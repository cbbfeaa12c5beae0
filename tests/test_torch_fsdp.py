"""The port's fully-sharded data parallelism (``parallel/fsdp.py`` and the
trainer's ``fsdp`` placement) against the JAX package's, on the CPU: the port
over ``["cpu"] * 8``, JAX over its 8 forced host devices.

- the spec rule and each leaf's spec and first shard's shape equal JAX's
  ``shard_params_fsdp`` on the same weights; Adam's moments are per block;
- training under fsdp equals replicated data parallelism and the JAX
  trainer's fsdp run from the same init (losses within rtol 5e-4 / atol 1e-5);
- a port checkpoint written under fsdp=8 (one slab per block) is read by
  JAX's ``load_sharded``, and a JAX checkpoint written under fsdp loads onto
  the port's tp=2 x dp=4 layout and onto one device, value for value;
- Adam's state resumes across layouts (one device to fsdp=8 and back);
- fsdp with tp, pp or ep raises the JAX trainer's ConfigError.
"""

import json

import jax
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.parallel.fsdp import fsdp_param_spec as jax_fsdp_spec  # noqa: E402
from capreolus_tpu.parallel.fsdp import shard_params_fsdp as jax_shard_fsdp  # noqa: E402
from capreolus_tpu.utils.sharded_ckpt import load_sharded as jax_load_sharded  # noqa: E402
from capreolus_tpu_torch.convert import unflatten_tree  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.parallel.distributed import make_mesh  # noqa: E402
from capreolus_tpu_torch.parallel.fsdp import fsdp_param_spec, shard_params_fsdp  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import corpus, jax_flat  # noqa: E402,F401
from torch_parallel_common import (CPU8, assert_losses, bert_pair, carry_init, jax_shard_shapes, jax_spec,  # noqa: E402
                                   port_shard_shapes, port_spec, train_jax, train_port)


class A:
    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


@pytest.mark.parametrize("shape", [(128, 64), (30522, 128), (6,), (), (64,), (8, 8, 24)])
def test_fsdp_param_spec_rules(shape):
    """The largest dim divisible by dp; the next largest when it does not
    divide; nothing divisible or a scalar: replicated."""
    assert port_spec(fsdp_param_spec(A(shape), 8)) == jax_spec(jax_fsdp_spec(A(shape), 8))


def test_shard_params_fsdp_places_leaves():
    mesh = make_mesh({"data": 8}, devices=CPU8)
    placed = shard_params_fsdp({"kernel": torch.zeros(32, 16), "scale": torch.ones(4)}, mesh)
    assert port_spec(placed["kernel"].spec) == ("data",)
    assert placed["kernel"].addressable_shards[0][3].shape == (4, 16)
    assert len(placed["kernel"].blocks) == 8 and port_spec(placed["scale"].spec) == ()


def fsdp_trainer(corpus, **trainer):
    jax_rr, port_rr = bert_pair(corpus, dict({"fsdp": True}, **trainer))
    port_rr.trainer.device, port_rr.trainer.devices = "cpu", CPU8
    return jax_rr, port_rr


def test_specs_and_shards_equal_jax(corpus):
    """Every leaf of tiny BERT-MaxP: the spec and first shard's shape of the
    port's placement against JAX's shard_params_fsdp of the same weights."""
    jax_rr, port_rr = fsdp_trainer(corpus)
    flat = carry_init(jax_rr, port_rr, corpus)
    trainer = port_rr.trainer
    model = port_rr.init_params(0)
    trainer._data_mesh = trainer._mesh(8)
    placement = trainer._place_params(port_rr, model)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    jtree = jax_shard_fsdp({k: jax.numpy.asarray(v) for k, v in flat.items()}, jmesh)
    assert {k: port_spec(a.spec) for k, a in placement.store.items()} == \
        {k: jax_spec(a.sharding.spec) for k, a in jtree.items()}
    assert port_shard_shapes(placement.store) == {k.replace("'", ""): v for k, v in jax_shard_shapes(jtree).items()}
    ffn = placement.store["params/bert/layer_0/intermediate/kernel"]
    assert port_spec(ffn.spec) == (None, "data") and ffn.addressable_shards[0][3].shape == (64, 128 // 8)


def test_trainer_fsdp_matches_replicated_and_jax(corpus, tmp_path):
    """Same init, same stream: ZeRO-3 training has the losses and metrics of
    replicated DP and of the JAX trainer's fsdp run; the weights and Adam's
    moments are per block, over the 8 data devices."""
    jax_rr, port_rr = fsdp_trainer(corpus)
    carry_init(jax_rr, port_rr, corpus)
    losses, metrics = train_port(port_rr, corpus, tmp_path / "fsdp")
    trainer = port_rr.trainer
    assert dict(trainer._data_mesh.shape) == {"data": 8} and trainer._placement.kind == "fsdp"
    ffn = trainer._placement.store["params/bert/layer_0/intermediate/kernel"]
    moments = [trainer._optimizer.state[b]["exp_avg"] for b in ffn.blocks.values()]
    assert len(moments) == 8 and all(m.shape == (64, 16) for m in moments)
    _, rep_rr = bert_pair(corpus, {})
    carry_init(jax_rr, rep_rr, corpus)
    rep_losses, rep_metrics = train_port(rep_rr, corpus, tmp_path / "rep")
    assert rep_rr.trainer._placement.kind == "dp"
    assert_losses(losses, rep_losses, "fsdp=8 against replicated dp=8")
    np.testing.assert_allclose(metrics["map"], rep_metrics["map"], rtol=1e-5)
    assert_losses(losses, train_jax(jax_rr, corpus, tmp_path / "jax"), "fsdp=8 against the JAX trainer's fsdp")


def test_port_fsdp_checkpoint_is_read_by_jax(corpus, tmp_path):
    """dev.best written under fsdp=8 with ckpt=sharded: each sharded leaf is
    8 slabs; JAX's load_sharded assembles the port's values; the port's
    load_best_model reads it back onto the same layout."""
    jax_rr, port_rr = fsdp_trainer(corpus, ckpt="sharded", niters=1)
    template = carry_init(jax_rr, port_rr, corpus)
    train_port(port_rr, corpus, tmp_path)
    trainer = port_rr.trainer
    pdir = tmp_path / "train" / "dev.best.params.shards"
    manifest = json.loads((pdir / "manifest.json").read_text())
    entry = next(e for e in manifest["leaves"] if e["path"] == "params/bert/layer_0/intermediate/kernel")
    assert len(entry["shards"]) == 8 and entry["shards"][1]["ranges"] == [[0, 64], [16, 32]]
    loaded = jax_flat(jax_load_sharded(pdir, like=unflatten_tree(template)))
    for key, arr in trainer._placement.store.items():
        np.testing.assert_array_equal(loaded[key], arr.numpy(), err_msg=key)
    before = {k: a.numpy() for k, a in trainer._placement.store.items()}
    trainer.load_best_model(port_rr, tmp_path / "train")
    for key, arr in trainer._placement.store.items():
        np.testing.assert_array_equal(arr.numpy(), before[key], err_msg=key)


@pytest.mark.parametrize("layout", ["tp2-dp4", "one-device"])
def test_jax_fsdp_checkpoint_loads_onto_other_layouts(corpus, tmp_path, layout):
    """The JAX trainer's sharded dev.best of weights placed under fsdp over 8
    devices loads onto the port's tp=2 x dp=4 placement (its column / row
    blocks) and onto one device, equal to the JAX weights."""
    jax_rr, port_rr = bert_pair(corpus, {"ckpt": "sharded", "tp": 2 if layout == "tp2-dp4" else 1})
    flat = carry_init(jax_rr, port_rr, corpus)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    placed = jax_shard_fsdp(jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat)), jmesh)
    jax_rr.trainer.save_checkpoint(tmp_path / "jax" / "dev.best", placed, {}, jax_rr)
    trainer = port_rr.trainer
    trainer.device, trainer.devices = "cpu", CPU8 if layout == "tp2-dp4" else ["cpu"]
    model = port_rr.init_params(5)  # other weights, overwritten by the load
    trainer._model = model
    trainer._data_mesh = trainer._mesh(8)
    trainer._placement = trainer._place_params(port_rr, model)
    trainer.load_best_model(port_rr, tmp_path / "jax")
    from capreolus_tpu_torch.convert import flax_flat_params

    got = flax_flat_params(model)
    for key, v in flat.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    if layout == "tp2-dp4":
        assert dict(trainer._data_mesh.shape) == {"data": 4, "model": 2}
        q = trainer._placement.store["params/bert/layer_0/attention/query/kernel"]
        assert port_spec(q.spec) == (None, "model") and len(q.blocks) == 2
        for key, arr in trainer._placement.store.items():
            np.testing.assert_array_equal(arr.numpy(), flat[key], err_msg=key)
    else:
        assert trainer._placement is None


@pytest.mark.parametrize("combo", [{"tp": 2}, {"pp": 2}, {"ep": 2}], ids=["tp", "pp", "ep"])
def test_fsdp_rejects_tp_pp_ep(corpus, combo):
    _, port_rr = fsdp_trainer(corpus, **combo)
    with pytest.raises(ConfigError, match="cannot be combined with tp/pp/ep"):
        port_rr.trainer._mesh(8)


@pytest.mark.parametrize("direction", ["one-device-to-fsdp8", "fsdp8-to-one-device"])
def test_adam_state_resumes_across_layouts(corpus, tmp_path, direction):
    """A sharded checkpoint after one step (weights and Adam) written on one
    device (Adam keyed by parameter index) resumes under fsdp=8 (Adam by leaf,
    cut into blocks), and one written under fsdp=8 resumes on one device:
    weights and every moment equal."""
    from capreolus_tpu_torch.convert import flax_leaves
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate
    from test_torch_trainer import draw, samplers

    def trainer_of(mesh):
        _, rr = bert_pair(corpus, {"ckpt": "sharded", "fsdp": mesh})
        t = rr.trainer
        t.device, t.devices = "cpu", CPU8 if mesh else None
        model = rr.init_params(3 if mesh else 4)
        t._model, t._data_mesh = model, t._mesh(8)
        t._placement = t._place_params(rr, model)
        return rr, t, model, t.make_optimizer(rr, model, t._placement)

    def adam_by_leaf(t, model, optimizer):
        if t._placement is not None:
            return {k.replace(".", "/"): v for k, v in t._placement_optimizer_tree(optimizer, gather=True)["state"].items()}
        params = dict(model.named_parameters())
        return {key: {m: to_flax(optimizer.state[params[name]][m]) for m in ("exp_avg", "exp_avg_sq")}
                for key, name, to_flax, _, _ in flax_leaves(model) if params[name] in optimizer.state}

    src_mesh = direction.startswith("fsdp8")
    rr, t, model, optimizer = trainer_of(src_mesh)
    batch = {k: v[None] for k, v in collate(draw(samplers(corpus, (rr, rr))[1], 8), ARRAY_KEYS).items()}
    t.train_step(rr, model, optimizer, batch, 0, t.step_seed(0, 0))
    t.save_checkpoint(tmp_path / "dev.best", model, optimizer, rr)
    if t._placement is not None:
        t._placement.sync_model()
    want_w = {k: v.detach().clone() for k, v in model.state_dict().items()}
    want = adam_by_leaf(t, model, optimizer)
    rr2, t2, model2, optimizer2 = trainer_of(not src_mesh)
    t2.load_checkpoint(tmp_path / "dev.best", model2, optimizer2, rr2)
    if t2._placement is not None:
        t2._placement.sync_model()
    for k, v in model2.state_dict().items():
        torch.testing.assert_close(v, want_w[k], rtol=0, atol=0, msg=k)
    got = adam_by_leaf(t2, model2, optimizer2)
    assert got.keys() == want.keys() and len(got) == len(list(model.parameters()))
    for key in want:
        for m in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(torch.as_tensor(got[key][m]), torch.as_tensor(want[key][m]), rtol=0, atol=0,
                                       msg=f"{key} {m}")
