"""The port's tensor and sequence parallelism (``parallel/tensor_parallel.py``
and the trainer's ``tp`` / ``sp`` placement) against the JAX package's, on the
CPU: the port over ``["cpu"] * 8``, JAX over its 8 forced host devices.

- the Megatron spec rules, and each leaf's spec and first shard's shape,
  equal JAX's ``shard_params_tp`` on the same weights;
- a tiny _BertScorer (4 heads x 16 = 64 hidden) on tp=4 (and tp=2 with sp)
  scores as it does on one device and as JAX's GSPMD-sharded scorer does, and
  its gradients equal one device's, within 1e-5;
- the trainer's tp=2 and tp=2 + sp runs have the losses of the port on one
  device and of the JAX trainer from the same init (rtol 5e-4 / atol 1e-5);
- indivisible degrees raise as JAX's trainer and mesh helpers do.
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

from capreolus_tpu.parallel.tensor_parallel import bert_param_spec as jax_bert_spec  # noqa: E402
from capreolus_tpu.parallel.tensor_parallel import make_tp_mesh as jax_tp_mesh  # noqa: E402
from capreolus_tpu.parallel.tensor_parallel import shard_params_tp as jax_shard_tp  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.parallel.placement import Placement  # noqa: E402
from capreolus_tpu_torch.parallel.tensor_parallel import bert_param_spec, make_tp_mesh  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import corpus  # noqa: E402,F401
from torch_parallel_common import (CPU8, FWD_TOL, assert_grads, assert_losses, bert_pair, carry_init,  # noqa: E402
                                   grads_by_key, jax_bert_scorer, jax_shard_shapes, jax_spec, placed_forward,
                                   port_shard_shapes, port_spec, store_grads, train_jax, train_port)

TINY = {"vocab_size": 512, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "intermediate_size": 128,
        "max_position": 128}


@pytest.fixture(scope="module")
def scorer():
    rng = np.random.Generator(np.random.PCG64(7))
    inp = rng.integers(0, 512, size=(8, 32)).astype(np.int32)
    mask = np.ones((8, 32), dtype=np.int32)
    mask[:, 28:] = 0
    seg = (rng.random((8, 32)) < 0.5).astype(np.int32)
    jmodel, params, model = jax_bert_scorer(TINY, inp, mask, seg)
    return jmodel, params, model, tuple(torch.from_numpy(x.astype(np.int64)) for x in (inp, mask, seg))


class K:  # a flax DictKey
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("path", [
    "params/bert/layer_0/attention/query/kernel", "params/bert/layer_1/attention/output/kernel",
    "params/bert/layer_0/intermediate/kernel", "params/bert/layer_0/intermediate/bias",
    "params/bert/layer_0/ffn_output/kernel", "params/bert/layer_0/ffn_output/bias",
    "params/bert/layer_0/attention/value/bias", "params/bert/word_embeddings", "params/classifier/kernel",
])
def test_param_spec_rules(path):
    want = jax_bert_spec(tuple(K(p) for p in path.split("/")))
    assert tuple(bert_param_spec(path)) == tuple(want)
    assert tuple(bert_param_spec(tuple(K(p) for p in path.split("/")))) == tuple(want)


def test_specs_and_shards_equal_jax(scorer):
    _, params, model, _ = scorer
    placement = Placement(model, make_tp_mesh(CPU8, tp=4), "tp")
    jtree = jax_shard_tp(params, jax_tp_mesh(tp=4))
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert {k: port_spec(a.spec) for k, a in placement.store.items()} == \
        {k: jax_spec(a.sharding.spec) for k, a in jflat.items()}
    assert port_shard_shapes(placement.store) == jax_shard_shapes(jtree)


@pytest.mark.parametrize("tp,sp", [(4, False), (2, False), (2, True)], ids=["tp4", "tp2", "tp2-sp"])
def test_tp_forward_equals_one_device_and_jax(scorer, tp, sp):
    """tp over 8 // tp data shards: the scores of one device and of JAX's
    sharded scorer (GSPMD inserts the psums), within 1e-5."""
    jmodel, params, model, (inp, mask, seg) = scorer
    with torch.no_grad():
        ref = model(inp, mask, seg)
        got = placed_forward(Placement(model, make_tp_mesh(CPU8, tp=tp), "tp", sp=sp), model, inp, mask, seg)
    torch.testing.assert_close(got, ref, rtol=FWD_TOL, atol=FWD_TOL)
    jmesh = jax_tp_mesh(tp=tp)
    batch = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("data"))
    args = [jax.device_put(x.numpy().astype(np.int32), batch) for x in (inp, mask, seg)]
    want = np.asarray(jax.jit(jmodel.apply)(jax_shard_tp(params, jmesh), *args))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("sp", [False, True], ids=["tp2", "tp2-sp"])
def test_tp_gradients_equal_one_device(scorer, sp):
    _, _, model, (inp, mask, seg) = scorer
    want = grads_by_key(model, (model(inp, mask, seg) ** 2).sum())
    placement = Placement(model, make_tp_mesh(CPU8, tp=2), "tp", sp=sp)
    got = store_grads(placement, (placed_forward(placement, model, inp, mask, seg) ** 2).sum())
    assert_grads(got, want, FWD_TOL, f"tp=2{' + sp' if sp else ''} gradients")


def test_indivisible_dims_fall_back_to_replication(scorer):
    """tp=8: the FFN's 128 columns divide and split; the 4 heads do not, so
    the port keeps the attention's leaves whole (JAX splits their 64 columns
    inside heads) and still scores as one device does; tp=3 does not divide 8."""
    _, params, model, (inp, mask, seg) = scorer
    placement = Placement(model, make_tp_mesh(CPU8, tp=8), "tp")
    assert port_spec(placement.store["params/bert/layer_0/intermediate/kernel"].spec) == (None, "model")
    assert port_spec(placement.store["params/bert/layer_0/attention/query/kernel"].spec) == ()
    jtree = jax_shard_tp(params, jax_tp_mesh(tp=8))
    assert jax_spec(jtree["params"]["bert"]["layer_0"]["intermediate"]["kernel"].sharding.spec) == (None, "model")
    with torch.no_grad():
        torch.testing.assert_close(placed_forward(placement, model, inp, mask, seg), model(inp, mask, seg),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        make_tp_mesh(CPU8, tp=3)


@pytest.mark.parametrize("sp", [False, True], ids=["tp2", "tp2-sp"])
def test_trainer_tp_end_to_end(corpus, tmp_path, sp):
    """rerank training with tp=2 (and sp) over the 8-device list (4 x 2):
    dev.best, and the losses of one device and of the JAX trainer."""
    jax_rr, port_rr = bert_pair(corpus, {"tp": 2, "sp": sp})
    carry_init(jax_rr, port_rr, corpus)
    losses, metrics = train_port(port_rr, corpus, tmp_path / "tp")
    assert dict(port_rr.trainer._data_mesh.shape) == {"data": 4, "model": 2}
    assert (tmp_path / "tp" / "train" / "dev.best.params").exists() and np.isfinite(metrics["map"])
    _, one_rr = bert_pair(corpus, {})
    carry_init(jax_rr, one_rr, corpus)
    one_losses, one_metrics = train_port(one_rr, corpus, tmp_path / "one", devices=None)
    assert_losses(losses, one_losses, f"tp=2{' + sp' if sp else ''} against one device")
    np.testing.assert_allclose(metrics["map"], one_metrics["map"], rtol=1e-5)
    assert_losses(losses, train_jax(jax_rr, corpus, tmp_path / "jax"), "against the JAX trainer")


@pytest.mark.parametrize("trainer,match", [
    ({"tp": 3}, "trainer.tp=3 does not divide the 8 available devices"),
    ({"sp": True}, "requires trainer.tp>1"),
], ids=["tp3", "sp-without-tp"])
def test_trainer_tp_refusals(corpus, trainer, match):
    _, port_rr = bert_pair(corpus, trainer)
    port_rr.trainer.device, port_rr.trainer.devices = "cpu", CPU8
    with pytest.raises(ConfigError, match=match):
        port_rr.trainer._mesh(4)
