"""The port's expert parallelism (``parallel/expert_parallel.py`` and the
trainer's ``ep`` placement) against the JAX package's, on the CPU: the port
over ``["cpu"] * 8``, JAX over its 8 forced host devices.

- the spec rules equal JAX's, and each leaf's spec and first shard's shape
  equal JAX's ``shard_params_ep`` on the same weights;
- ``MoeFFN`` with its experts spread over the expert devices equals one
  device's and JAX's EP-sharded layer (forward within 1e-5), and every
  expert's weights take a gradient, equal to one device's;
- BERT-MaxP with 2 experts trains under ep=2 with the losses of one device and
  of the JAX trainer from the same init (rtol 5e-4 / atol 1e-5);
- MoE with int8, and ep with tp or pp, raise as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.parallel.expert_parallel import expert_param_spec as jax_expert_spec  # noqa: E402
from capreolus_tpu.parallel.expert_parallel import make_ep_mesh as jax_ep_mesh  # noqa: E402
from capreolus_tpu.parallel.expert_parallel import shard_params_ep as jax_shard_ep  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import BertConfig as JaxBertConfig  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import MoeFFN as JaxMoeFFN  # noqa: E402
from capreolus_tpu_torch.convert import flax_state_dict  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.parallel.expert_parallel import expert_param_spec, make_ep_mesh  # noqa: E402
from capreolus_tpu_torch.parallel.placement import Placement  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import BertConfig, MoeFFN  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import corpus, jax_flat  # noqa: E402,F401
from torch_parallel_common import (CPU8, FWD_TOL, assert_grads, assert_losses, bert_pair, carry_init,  # noqa: E402
                                   grads_by_key, jax_shard_shapes, jax_spec, placed_forward, port_shard_shapes,
                                   port_spec, store_grads, train_jax, train_port)

CFG = {"vocab_size": 128, "hidden_size": 16, "num_layers": 2, "num_heads": 2, "intermediate_size": 32,
       "max_position": 32, "moe_experts": 2, "moe_topk": 1}


@pytest.fixture(scope="module")
def moe():
    """(JAX MoeFFN, its params, the port's MoeFFN carrying them, x [8, 16, 16])."""
    rng = np.random.Generator(np.random.PCG64(5))
    x = rng.standard_normal((8, 16, 16)).astype(np.float32)
    jmodel = JaxMoeFFN(JaxBertConfig(dtype="float32", **CFG))
    params = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(x))
    model = MoeFFN(BertConfig(**CFG))
    model.load_state_dict(flax_state_dict(model, jax_flat(params)))
    return jmodel, params, model, torch.from_numpy(x)


class K:  # a flax DictKey
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("path", ["params/bert/layer_0/moe/experts_wi", "params/bert/layer_0/moe/experts_bo",
                                  "params/bert/layer_0/moe/gate/kernel", "params/bert/word_embeddings"])
def test_expert_param_spec_rules(path):
    assert tuple(expert_param_spec(path)) == tuple(jax_expert_spec(tuple(K(p) for p in path.split("/"))))


def test_ep_forward_and_gradients_equal_one_device_and_jax(moe):
    jmodel, params, model, x = moe
    placement = Placement(model, make_ep_mesh(CPU8, ep=2), "ep")
    jtree = jax_shard_ep(params, jax_ep_mesh(ep=2))
    assert {k: port_spec(a.spec) for k, a in placement.store.items()} == \
        {"/".join(str(getattr(p, "key", p)) for p in path): jax_spec(leaf.sharding.spec)
         for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert port_shard_shapes(placement.store) == jax_shard_shapes(jtree)
    assert port_spec(placement.store["params/experts_wi"].spec) == ("expert",)
    with torch.no_grad():
        ref = model(x)
        got = placed_forward(placement, model, x)
    torch.testing.assert_close(got, ref, rtol=FWD_TOL, atol=FWD_TOL)
    want = np.asarray(jax.jit(jmodel.apply)(jtree, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    ref_grads = grads_by_key(model, (model(x) ** 2).sum())
    got_grads = store_grads(placement, (placed_forward(placement, model, x) ** 2).sum())
    assert_grads(got_grads, ref_grads, FWD_TOL, "ep=2 gradients")
    for e in range(2):  # top-1 routing over random tokens reaches both experts
        assert float(got_grads["params/experts_wi"][e].abs().max()) > 0, f"expert {e} got no gradient"


def test_trainer_ep_end_to_end(corpus, tmp_path):
    """BERT-MaxP with 2 experts (top-1) under ep=2 on the (data=4, expert=2)
    mesh: expert weights split, the losses of one device and of JAX's trainer."""
    jax_rr, port_rr = bert_pair(corpus, {"ep": 2}, moeexperts=2, moetopk=1)
    carry_init(jax_rr, port_rr, corpus)
    losses, metrics = train_port(port_rr, corpus, tmp_path / "ep")
    trainer = port_rr.trainer
    assert dict(trainer._data_mesh.shape) == {"data": 4, "expert": 2}
    wi = trainer._placement.store["params/bert/layer_0/moe/experts_wi"]
    assert port_spec(wi.spec) == ("expert",) and len(wi.blocks) == 2
    assert (tmp_path / "ep" / "train" / "dev.best.params").exists() and np.isfinite(metrics["map"])
    _, one_rr = bert_pair(corpus, {}, moeexperts=2, moetopk=1)
    carry_init(jax_rr, one_rr, corpus)
    one_losses, one_metrics = train_port(one_rr, corpus, tmp_path / "one", devices=None)
    assert_losses(losses, one_losses, "ep=2 against one device")
    np.testing.assert_allclose(metrics["map"], one_metrics["map"], rtol=1e-5)
    assert_losses(losses, train_jax(jax_rr, corpus, tmp_path / "jax"), "ep=2 against the JAX trainer")


@pytest.mark.parametrize("trainer,match", [
    ({"ep": 2, "tp": 2}, "cannot be combined with tp/pp yet"), ({"ep": 2, "pp": 2}, "cannot be combined with tp/pp"),
    ({"ep": 3}, "trainer.ep=3 does not divide the 8 available devices"),
], ids=["tp", "pp", "devices"])
def test_trainer_ep_refusals(corpus, trainer, match):
    _, port_rr = bert_pair(corpus, trainer, moeexperts=2)
    port_rr.trainer.device, port_rr.trainer.devices = "cpu", CPU8
    with pytest.raises(ConfigError, match=match):
        port_rr.trainer._mesh(8)


def test_moe_int8_combination_raises(corpus):
    """The port refuses it as the reranker is built; JAX as it builds the model."""
    with pytest.raises(ConfigError, match="moeexperts and quantize=int8 cannot be combined"):
        bert_pair(corpus, {"ep": 2}, moeexperts=2, quantize="int8")
