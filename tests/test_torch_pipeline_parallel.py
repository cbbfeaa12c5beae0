"""The port's GPipe pipeline (``parallel/pipeline_parallel.py`` and the
trainer's ``pp`` placement) against the JAX package's, on the CPU: the port
over ``["cpu"] * 8``, JAX over its 8 forced host devices.

- the stacked view round-trips; its placed specs and first shards' shapes
  equal JAX's ``place_pp_view`` (pp=2, and pp=2 x tp=2);
- the pipelined encoder equals the plain encoder (forward and gradients,
  within 1e-5) at 2 and 4 stages and several microbatch counts, and pp x tp
  too; the pipelined scorer equals JAX's;
- the trainer's pp=2 and pp=2 x tp=2 runs have the losses of one device and
  of the JAX trainer from the same init (rtol 5e-4 / atol 1e-5);
- the JAX trainer's refusals, with its messages.
"""

import jax
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.parallel import pipeline_parallel as jpp  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import BertConfig as JaxBertConfig  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import BertEncoder as JaxBertEncoder  # noqa: E402
from capreolus_tpu_torch.convert import flatten_tree, unflatten_tree  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.parallel import pipeline_parallel as pp  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import BertConfig, BertEncoder  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import corpus, jax_flat, make_rerankers  # noqa: E402,F401
from torch_parallel_common import (CPU8, FWD_TOL, TINY_BERT, TRAIN, assert_grads, assert_losses, bert_pair,  # noqa: E402
                                   carry_init, grads_by_key, jax_bert_scorer, jax_shard_shapes, jax_spec,
                                   port_shard_shapes, port_spec, train_jax, train_port)

CFG = {"vocab_size": 211, "hidden_size": 32, "num_layers": 4, "num_heads": 2, "intermediate_size": 64,
       "max_position": 64}


def _inputs(batch=16, seqlen=16, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    inp = rng.integers(0, CFG["vocab_size"], size=(batch, seqlen)).astype(np.int32)
    mask = np.ones((batch, seqlen), np.int32)
    mask[:, seqlen - 3:] = 0  # padding tail exercises the attention mask
    seg = (rng.random((batch, seqlen)) < 0.5).astype(np.int32)
    return inp, mask, seg


def _t(*xs):
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in xs)


@pytest.fixture(scope="module")
def encoder():
    """(JAX params, the port's BertEncoder carrying them, its flax tree)."""
    from capreolus_tpu_torch.convert import flax_state_dict

    inp, mask, seg = _inputs()
    params = JaxBertEncoder(JaxBertConfig(dtype="float32", **CFG)).init(jax.random.PRNGKey(0), inp, mask, seg)["params"]
    model = BertEncoder(BertConfig(**CFG))
    flat = jax_flat({"params": params})
    model.load_state_dict(flax_state_dict(model, flat))
    tree = unflatten_tree({k[len("params/"):]: torch.from_numpy(v) for k, v in flat.items()})
    return params, model, tree


def test_stack_unstack_roundtrip(encoder):
    _, _, tree = encoder
    rest, stacked = pp.split_bert_params(tree, CFG["num_layers"])
    assert stacked["attention"]["query"]["kernel"].shape == (4, 32, 32)
    merged = pp.merge_bert_params(rest, stacked, CFG["num_layers"])
    assert flatten_tree(merged).keys() == flatten_tree(tree).keys()
    for key, v in flatten_tree(tree).items():
        torch.testing.assert_close(flatten_tree(merged)[key], v, rtol=0, atol=0)


@pytest.mark.parametrize("tp", [1, 2], ids=["pp2", "pp2-tp2"])
def test_placed_view_equals_jax(encoder, tp):
    params, _, tree = encoder
    rest, stacked = pp.place_pp_view(*pp.split_bert_params(tree, 4), pp.make_pp_mesh(CPU8, pp=2, tp=tp), 2)
    jrest, jstacked = jpp.place_pp_view(*jpp.split_bert_params(params, 4), jpp.make_pp_mesh(pp=2, tp=tp))
    got = {k: port_spec(v.spec) for k, v in flatten_tree(stacked).items()}
    want = {"/".join(str(getattr(p, "key", p)) for p in path): jax_spec(leaf.sharding.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jstacked)[0]}
    assert got == want
    assert port_shard_shapes(flatten_tree(stacked)) == jax_shard_shapes(jstacked)
    assert all(port_spec(v.spec) == () for v in flatten_tree(rest).values())
    if tp == 2:
        assert got["attention/query/kernel"] == ("pipe", None, "model")
        assert got["ffn_output/kernel"] == ("pipe", "model") and got["attention_ln/scale"] == ("pipe",)


@pytest.mark.parametrize("stages,microbatches,tp", [(2, 2, 1), (4, 4, 1), (4, 8, 1), (2, 0, 1), (2, 2, 2)],
                         ids=["pp2-m2", "pp4-m4", "pp4-m8", "pp2-auto", "pp2-tp2-m2"])
def test_pipelined_encoder_matches_plain(encoder, stages, microbatches, tp):
    _, model, tree = encoder
    inp, mask, seg = _t(*_inputs())
    with torch.no_grad():
        ref_seq, ref_pooled = model(inp, mask, seg)
        rest, stacked = pp.split_bert_params(tree, 4)
        seq, pooled = pp.pipelined_encoder(model.config, rest, stacked, inp, mask, seg,
                                           pp.make_pp_mesh(CPU8, pp=stages, tp=tp), microbatches)
    torch.testing.assert_close(seq, ref_seq, rtol=FWD_TOL, atol=FWD_TOL)
    torch.testing.assert_close(pooled, ref_pooled, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("stages,tp", [(4, 1), (2, 2)], ids=["pp4", "pp2-tp2"])
def test_pipelined_gradients_match_plain(encoder, stages, tp):
    """Gradients through the fill-drain schedule (and its Megatron stages)
    equal the plain encoder's, leaf by leaf."""
    _, model, tree = encoder
    inp, mask, seg = _t(*_inputs())
    want = grads_by_key(model, (model(inp, mask, seg)[1] ** 2).sum())
    rest, stacked = pp.place_pp_view(*pp.split_bert_params(tree, 4), pp.make_pp_mesh(CPU8, pp=stages, tp=tp), 2)
    for v in list(flatten_tree(rest).values()) + list(flatten_tree(stacked).values()):
        for b in v.blocks.values():
            b.requires_grad_(True)
    _, pooled = pp.pipelined_encoder(model.config, rest, stacked, inp, mask, seg,
                                     pp.make_pp_mesh(CPU8, pp=stages, tp=tp), stages)
    leaves = {**{f"params/{k}": v for k, v in flatten_tree(rest).items()},
              **{f"stacked/{k}": v for k, v in flatten_tree(stacked).items()}}
    grads = torch.autograd.grad((pooled ** 2).sum(), [b for v in leaves.values() for b in v.blocks.values()])
    from capreolus_tpu_torch.parallel.distributed import assemble_blocks

    it, got = iter(grads), {}
    for key, v in leaves.items():
        full = assemble_blocks([(i, next(it)) for i in v.blocks], "cpu")
        if key.startswith("stacked/"):
            for layer in range(4):
                got[f"params/layer_{layer}/{key[len('stacked/'):]}"] = full[layer]
        else:
            got[key] = full
    assert_grads(got, want, FWD_TOL, f"pp={stages} x tp={tp} gradients")


def test_pipelined_scorer_matches_jax():
    """[B, P, L] passage scoring through the port's pipeline equals JAX's
    pipelined scorer and the plain scorers; the view merges back exactly."""
    rng = np.random.Generator(np.random.PCG64(7))
    b, p, length = 4, 2, 12
    inp = rng.integers(0, CFG["vocab_size"], size=(b, p, length)).astype(np.int32)
    mask = np.ones((b, p, length), np.int32)
    seg = (rng.random((b, p, length)) < 0.5).astype(np.int32)
    jmodel, variables, model = jax_bert_scorer(CFG, inp, mask, seg, seed=3)
    want = np.asarray(jpp.pipelined_scorer_forward(JaxBertConfig(dtype="float32", **CFG),
                                                   *jpp.split_scorer_params(variables, jmodel.config),
                                                   inp, mask, seg, jpp.make_pp_mesh(pp=2), 2))
    tree = unflatten_tree({k: torch.from_numpy(v) for k, v in jax_flat(variables).items()})
    rest, stacked = pp.split_scorer_params(tree, model.config)
    with torch.no_grad():
        got = pp.pipelined_scorer_forward(model.config, rest, stacked, *_t(inp, mask, seg),
                                          pp.make_pp_mesh(CPU8, pp=2), 2)
        ref = model(*_t(inp, mask, seg))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    torch.testing.assert_close(got, ref, rtol=FWD_TOL, atol=FWD_TOL)
    back = flatten_tree(pp.merge_scorer_params(rest, stacked, model.config))
    for key, v in flatten_tree(tree).items():
        torch.testing.assert_close(back[key], v, rtol=0, atol=0)


def test_pipelined_train_mode_runs_with_dropout(encoder):
    _, model, tree = encoder
    inp, mask, seg = _t(*_inputs(batch=8))
    rest, stacked = pp.split_bert_params(tree, 4)
    mesh = pp.make_pp_mesh(CPU8, pp=2)
    import dataclasses

    cfg = dataclasses.replace(model.config, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    with torch.no_grad():
        _, eval_pooled = pp.pipelined_encoder(cfg, rest, stacked, inp, mask, seg, mesh, 2)
        _, train_pooled = pp.pipelined_encoder(cfg, rest, stacked, inp, mask, seg, mesh, 2, dropout_seed=9)
    assert torch.isfinite(train_pooled).all() and not torch.allclose(train_pooled, eval_pooled)


@pytest.mark.parametrize("tp", [1, 2], ids=["pp2", "pp2-tp2"])
def test_trainer_pp_end_to_end(corpus, tmp_path, tp):
    """BERT-MaxP with pp=2 (fastforward on) and pp=2 x tp=2: the losses of one
    device and of the JAX trainer; canonical checkpoints and predictions."""
    jax_rr, port_rr = bert_pair(corpus, {"pp": 2, "tp": tp, "fastforward": True})
    carry_init(jax_rr, port_rr, corpus)
    losses, metrics = train_port(port_rr, corpus, tmp_path / "pp")
    trainer = port_rr.trainer
    want_mesh = {"data": 4, "pipe": 2} if tp == 1 else {"data": 2, "pipe": 2, "model": 2}
    assert dict(trainer._data_mesh.shape) == want_mesh and trainer._placement.kind == "pp"
    assert (tmp_path / "pp" / "train" / "dev.best.params").exists() and np.isfinite(metrics["map"])
    assert "stacked/attention/query/kernel" in trainer._placement.store
    _, one_rr = bert_pair(corpus, {})
    carry_init(jax_rr, one_rr, corpus)
    one_losses, one_metrics = train_port(one_rr, corpus, tmp_path / "one", devices=None)
    assert_losses(losses, one_losses, f"pp=2 x tp={tp} against one device")
    np.testing.assert_allclose(metrics["map"], one_metrics["map"], rtol=1e-5)
    assert_losses(losses, train_jax(jax_rr, corpus, tmp_path / "jax"), "against the JAX trainer")


def _refused(corpus, name, trainer, **options):
    opts = dict(TINY_BERT, **options)
    opts["trainer"] = dict(TRAIN, **trainer)
    _, port_rr = make_rerankers(corpus, name, opts)
    return port_rr


@pytest.mark.parametrize("name,trainer,options,match", [
    ("parade", {"pp": 2}, {}, "parade is not pipeline-compatible"),
    ("BERTMaxP", {"pp": 2, "loss": "lce"}, {}, "does not support loss=lce"),
    ("BERTMaxP", {"pp": 8}, {}, "trainer.pp=8 does not divide the 2 encoder layers"),
    ("BERTMaxP", {"pp": 3}, {}, "trainer.pp=3 x trainer.tp=1 does not divide the 8 available devices"),
    ("BERTMaxP", {"pp": 2, "tp": 2, "sp": True}, {}, "cannot be combined with trainer.pp"),
], ids=["parade", "lce", "layers", "devices", "sp"])
def test_trainer_pp_refusals(corpus, tmp_path, name, trainer, options, match):
    from capreolus_tpu_torch.sampler import Sampler

    port_rr = _refused(corpus, name, trainer, **options)
    train_s = Sampler.create("triplet")
    train_s.prepare(corpus["run"], corpus["qrels"], port_rr.extractor)
    port_rr.trainer.device, port_rr.trainer.devices = "cpu", CPU8
    with pytest.raises(ConfigError, match=match):
        port_rr.trainer.train(port_rr, train_s, tmp_path / "t", None, tmp_path / "d", corpus["qrels"], "map")


def test_microbatches_must_divide_the_local_batch(encoder):
    _, model, tree = encoder
    inp, mask, seg = _t(*_inputs())
    with pytest.raises(ValueError, match="local batch 4 not divisible by microbatches=3"):
        pp.pipelined_encoder(model.config, *pp.split_bert_params(tree, 4), inp, mask, seg,
                             pp.make_pp_mesh(CPU8, pp=2), 3)


def test_reranker_pp_view_round_trips_and_scores(corpus):
    """BERT-MaxP's pp_view / pp_canonical and score_pp, against its own score."""
    _, port_rr = bert_pair(corpus, {})
    assert port_rr.pp_compatible
    from capreolus_tpu_torch.convert import flax_flat_params
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate
    from test_torch_trainer import draw, samplers

    model = port_rr.init_params(0)
    flat = {k: torch.from_numpy(v) for k, v in flax_flat_params(model).items()}
    view = port_rr.pp_view(unflatten_tree(flat))
    assert set(view) == {"rest", "stacked"}
    back = flatten_tree(port_rr.pp_canonical(view))
    assert back.keys() == flat.keys() and all(torch.equal(back[k], flat[k]) for k in flat)
    batch = collate(draw(samplers(corpus, (port_rr, port_rr))[1], 8), ARRAY_KEYS)
    with torch.no_grad():
        want = port_rr.score(batch, torch.device("cpu"))
        got = port_rr.score_pp(view, batch, pp.make_pp_mesh(CPU8, pp=2), 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=FWD_TOL, atol=FWD_TOL)
