"""Helpers of the port's multi-device training tests (``tests/test_torch_data_parallel.py``,
``test_torch_fsdp.py``, ``test_torch_tensor_parallel.py``, ``test_torch_pipeline_parallel.py``
and ``test_torch_expert_parallel.py``).

The JAX package trains on the 8 host devices that ``tests/conftest.py`` forces;
the port trains over the device list ``["cpu"] * 8``, its counterpart. A
trainer run of each package starts from the same weights, the JAX init
carried into the port (``carry_init``), with dropout off, and reads the same
sample stream, so both loss histories are the function of one init and one
stream.
"""

import copy
import json

import jax
import numpy as np
import torch

from capreolus_tpu.sampler import Sampler as JaxSampler
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate
from capreolus_tpu_torch.sampler import Sampler as TorchSampler
from capreolus_tpu_torch.trainer import Trainer as TorchTrainerBase
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS
from test_torch_trainer import EXTRACTOR_TINY, OFFLINE_TOKENIZER, draw, jax_flat, make_rerankers

CPU8 = ["cpu"] * 8
LOSS_RTOL, LOSS_ATOL = 5e-4, 1e-5  # the JAX suite's own fsdp tolerance (tests/test_fsdp.py)
FWD_TOL = 1e-5  # a forward or a gradient on a mesh against one device: f32 sums in other orders
TINY_BERT = {"pretrained": "tiny", "hidden_dropout_prob": 0.0,
             "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER)}
TRAIN = {"niters": 2, "itersize": 8, "batch": 8, "validatefreq": 1, "lr": 1e-3, "bertlr": 1e-3}


def bert_pair(corpus, trainer, **options):
    """(JAX, port) tiny BERT-MaxP rerankers with ``trainer`` options and dropout off."""
    opts = json.loads(json.dumps(TINY_BERT))
    opts.update(options)
    opts["trainer"] = dict(TRAIN, **trainer)
    return make_rerankers(corpus, "BERTMaxP", opts)


def carry_init(jax_rr, port_rr, corpus):
    """The JAX trainer's init (from its own first batch) becomes the port's:
    ``port_rr.init_params`` returns the port model with the JAX weights."""
    seed, batch = jax_rr.trainer.config["seed"], jax_rr.trainer.config["batch"]
    sampler = JaxSampler.create("triplet")
    sampler.prepare(corpus["run"], corpus["qrels"], jax_rr.extractor)
    rng = copy.deepcopy(getattr(jax_rr.extractor, "rng", None))  # the passage draws the trainer will make again
    params = jax_rr.init_params(jax.random.PRNGKey(seed), jax_collate(draw(sampler, batch), ARRAY_KEYS))
    if rng is not None:
        jax_rr.extractor.rng = rng
    flat = jax_flat(params)
    init = port_rr.init_params

    def carried(seed):
        model = init(seed + 1)
        model.load_state_dict(port_rr.state_dict_from_params(flat))
        return model

    port_rr.init_params = carried
    return flat


def train_port(port_rr, corpus, out, devices=CPU8, dev=True):
    """The port's ``train`` over ``devices`` (None: one device): (losses, metrics)."""
    train_s = TorchSampler.create("triplet")
    train_s.prepare(corpus["run"], corpus["qrels"], port_rr.extractor)
    dev_s = None
    if dev:
        dev_s = TorchSampler.create("pred")
        dev_s.prepare(corpus["run"], corpus["qrels"], port_rr.extractor)
    trainer = port_rr.trainer
    trainer.device, trainer.devices = "cpu", devices
    metrics = trainer.train(port_rr, train_s, out / "train", dev_s, out / "dev", corpus["qrels"], "map")
    return TorchTrainerBase.load_loss_file(out / "train" / "info" / "loss.txt"), metrics


def train_jax(jax_rr, corpus, out):
    """The JAX trainer's losses on the 8 host devices (no validation)."""
    train_s = JaxSampler.create("triplet")
    train_s.prepare(corpus["run"], corpus["qrels"], jax_rr.extractor)
    jax_rr.trainer.train(jax_rr, train_s, out / "train", None, out / "dev", corpus["qrels"], metric="map")
    return jax_rr.trainer.load_loss_file(out / "train" / "info" / "loss.txt")


def assert_losses(got, want, what):
    print(f"{what}: losses {got} against {want}")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=what)


def jax_spec(spec):
    """A JAX PartitionSpec as a tuple without trailing Nones (NamedSharding drops them)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def port_spec(spec):
    return jax_spec(tuple(spec))


def jax_shard_shapes(tree):
    """{flax key: addressable_shards[0]'s shape} of a placed JAX tree."""
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.addressable_shards[0].data.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_shard_shapes(store):
    return {key: tuple(arr.addressable_shards[0][3].shape) for key, arr in store.items()}


def placed_forward(placement, model, *inputs, **kwargs):
    """``model(*inputs)`` under ``placement``: rows cut over its data shards,
    each shard's forward on its first device, the outputs concatenated on the
    first shard's device."""
    rows = inputs[0].shape[0] // placement.dp
    lead = placement.lead(0)
    with placement.bind():
        outs = [model(*(x[r * rows:(r + 1) * rows].to(placement.lead(r)) for x in inputs), **kwargs)
                for r in range(placement.dp)]
    return torch.cat([o.to(lead) for o in outs])


def jax_bert_scorer(config, inp, mask, seg, seed=0):
    """(JAX ``_BertScorer``, its params from PRNGKey(seed), the port's
    ``_BertScorer`` carrying them) of one tiny config (a dict of BertConfig fields)."""
    from capreolus_tpu.reranker.bert.encoder import BertConfig as JaxBertConfig
    from capreolus_tpu.reranker.bert_rerankers import _BertScorer as JaxScorer
    from capreolus_tpu_torch.convert import flax_state_dict
    from capreolus_tpu_torch.reranker.bert.encoder import BertConfig
    from capreolus_tpu_torch.reranker.bert_rerankers import _BertScorer

    jmodel = JaxScorer(JaxBertConfig(dtype="float32", **config))
    params = jmodel.init(jax.random.PRNGKey(seed), inp, mask, seg)
    model = _BertScorer(BertConfig(**config))
    model.load_state_dict(flax_state_dict(model, jax_flat(params)))
    return jmodel, params, model


def grads_by_key(model, loss):
    """{flax key: gradient in the flax layout} of ``loss`` over ``model``'s parameters."""
    from capreolus_tpu_torch.convert import flax_leaves

    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, [named[name] for _, name, *_ in flax_leaves(model)])
    return {key: to_flax(g) for (key, _, to_flax, _, _), g in zip(flax_leaves(model), grads)}


def store_grads(placement, loss):
    """{canonical key: gradient} of ``loss`` over ``placement``'s blocks, each
    leaf's block gradients assembled (a stacked leaf's cut into its layers)."""
    from capreolus_tpu_torch.parallel.distributed import assemble_blocks

    keys = list(placement.store)
    blocks = [b for k in keys for b in placement.store[k].blocks.values()]
    grads = iter(torch.autograd.grad(loss, blocks, allow_unused=True))
    out = {}
    for key in keys:
        arr = placement.store[key]
        parts = [(index, next(grads)) for index in arr.blocks]
        parts = [(i, torch.zeros(tuple(b - a for a, b in i)) if g is None else g.to("cpu")) for i, g in parts]
        full = assemble_blocks(parts, "cpu")
        if key.startswith("stacked/"):
            for i, ck in enumerate(placement.stacked_from(key)):
                out[ck] = full[i]
        else:
            out[key] = full
    return out


def assert_grads(got, want, tol, what):
    """Each tensor's error against its own largest entry (at least 1)."""
    assert set(got) == set(want), what
    for key in want:
        scale = max(1.0, float(want[key].abs().max()))
        err = float((got[key].detach() - want[key].detach()).abs().max()) / scale
        assert err <= tol, f"{what}: {key} differs by {err:.3g} of its scale"
