"""The mixture-of-experts FFN (``MoeFFN``, ``moeexperts`` / ``moetopk``) in
the port against the JAX package's on the CPU, from the same weights carried
across:

- routing: top-1 sends each token to its chosen expert alone; top-2 gates are
  convex (non-negative, two of them nonzero, summing to 1 within 1e-6);
- outputs and gradients (weights and input) equal to JAX's at 1e-5: f32 sums
  in another order; the port sums the experts' outputs expert by expert;
- every expert takes a gradient;
- the initial draws as flax's ``lecun_normal(batch_axis=0)``;
- BERTMaxP with MoE layers: ``test`` scores (1e-4) and training (the checks of
  ``tests/test_torch_trainer.py``) against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capreolus_tpu.reranker.bert.encoder import BertConfig as JaxBertConfig
from capreolus_tpu.reranker.bert.encoder import MoeFFN as JaxMoeFFN
from capreolus_tpu_torch.convert import bert_state_dict, flatten_tree
from capreolus_tpu_torch.reranker.bert.encoder import BertConfig, MoeFFN
from test_torch_index import torch_cache  # noqa: F401
from test_torch_trainer import check_training_matches_jax, corpus, make_rerankers  # noqa: F401
from torch_bert_rerankers_util import TRAIN_EXTRACTOR, assert_within, check_scores_match_jax

torch.set_num_threads(2)
MOE_TOL = 1e-5
TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)


def moe_pair(experts, topk, seed):
    """(JAX MoeFFN params, port MoeFFN with them, input [2, 16, 64])."""
    jax_cfg = JaxBertConfig(**TINY, moe_experts=experts, moe_topk=topk)
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    params = JaxMoeFFN(jax_cfg).init(jax.random.PRNGKey(seed), jnp.asarray(x))
    # biases away from zero, so that a mapping fault shows
    params = jax.tree_util.tree_map(lambda v: v + 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), v.shape),
                                    params)
    port = MoeFFN(BertConfig(**TINY, moe_experts=experts, moe_topk=topk))
    state = bert_state_dict({f"params/{k}": np.asarray(v) for k, v in flatten_tree(params["params"]).items()})
    port.load_state_dict(state)
    return jax_cfg, params, port, x


@pytest.mark.parametrize("experts,topk", [(4, 1), (4, 2), (3, 3)])
def test_moe_outputs_and_gradients_equal_jax(experts, topk):
    jax_cfg, params, port, x = moe_pair(experts, topk, seed=experts + topk)
    r = np.random.Generator(np.random.PCG64(1)).standard_normal((2, 16, 64)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(JaxMoeFFN(jax_cfg).apply(p, xx) * r)

    want_out = np.asarray(JaxMoeFFN(jax_cfg).apply(params, jnp.asarray(x)))
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out * torch.from_numpy(r)).sum().backward()
    assert_within(out.detach().numpy(), want_out, MOE_TOL, f"MoE {experts} experts top-{topk} output")
    assert_within(xt.grad.numpy(), np.asarray(g_x), MOE_TOL, "MoE input gradient")
    want_grads = flatten_tree(g_params["params"])
    for key, value in want_grads.items():
        name = key.replace("/", ".").replace("kernel", "weight")
        got = dict(port.named_parameters())[name].grad.numpy()
        if key.endswith("kernel"):
            got = got.T
        scale = max(1.0, float(np.abs(value).max()))
        assert_within(got / scale, np.asarray(value) / scale, MOE_TOL, f"MoE gradient {key}")


def test_top1_routes_each_token_to_its_chosen_expert():
    _, _, port, x = moe_pair(4, 1, seed=3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        gates = port.gates(xt)
        out = port(xt)
        chosen = torch.softmax(port.gate(xt), dim=-1).argmax(dim=-1)
        assert torch.equal(gates.argmax(dim=-1), chosen)
        torch.testing.assert_close(gates.max(dim=-1).values, torch.ones(2, 16), rtol=0, atol=1e-7)
        for e in range(4):
            h = torch.nn.functional.gelu(xt @ port.experts_wi[e] + port.experts_bi[e], approximate="tanh")
            want = h @ port.experts_wo[e] + port.experts_bo[e]
            sel = chosen == e
            torch.testing.assert_close(out[sel], want[sel], rtol=1e-5, atol=1e-6)
    assert len(set(chosen.flatten().tolist())) > 1  # the batch reaches more than one expert


def test_top2_gates_are_convex_and_every_expert_takes_a_gradient():
    _, _, port, x = moe_pair(4, 2, seed=4)
    xt = torch.from_numpy(x)
    gates = port.gates(xt)
    assert bool((gates >= 0).all())
    assert bool(((gates > 0).sum(dim=-1) == 2).all())
    torch.testing.assert_close(gates.sum(dim=-1), torch.ones(2, 16), rtol=0, atol=1e-6)
    port(xt).square().sum().backward()
    for name in ("experts_wi", "experts_bi", "experts_wo", "experts_bo"):
        grad = getattr(port, name).grad
        for e in range(4):
            assert float(grad[e].abs().max()) > 0, (name, e)
    assert float(port.gate.weight.grad.abs().max()) > 0


def test_moe_init_draws_as_flax():
    """The expert matrices ``lecun_normal`` per expert (std 1/sqrt(fan-in) within
    20%, truncated at two stds), zero biases, as JAX's init; the gate a Dense."""
    from capreolus_tpu_torch.convert import init_flax_

    jax_cfg, params, _, x = moe_pair(4, 2, seed=5)
    want = flatten_tree(JaxMoeFFN(jax_cfg).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = init_flax_(MoeFFN(BertConfig(**TINY, moe_experts=4, moe_topk=2)), torch.Generator().manual_seed(0))
    for name, fan_in in (("experts_wi", 64), ("experts_wo", 128)):
        w = getattr(port, name).detach().numpy()
        for e in range(4):
            std = float(np.asarray(want[name])[e].std())
            assert abs(float(w[e].std()) - std) <= 0.2 * std and abs(std - fan_in ** -0.5) <= 0.2 * fan_in ** -0.5
            assert np.abs(w[e]).max() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert float(port.experts_bi.detach().abs().max()) == float(port.experts_bo.detach().abs().max()) == 0.0


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_bertmaxp_scores_match_jax(topk):
    _, port_rr = check_scores_match_jax("BERTMaxP", {"moeexperts": 3, "moetopk": topk}, f"BERTMaxP MoE top-{topk}")
    assert port_rr.model.bert.layer_1.moe.experts_wi.shape == (3, 64, 128)
    assert not hasattr(port_rr.model.bert.layer_0, "intermediate")


@pytest.mark.parametrize("experts,topk", [(2, 2), (3, 1)])
def test_moe_bertmaxp_training_matches_jax(corpus, experts, topk):
    """With top-1 of 3 the routing is a step function of the gate's logits:
    after a step, the two trainers' weights differ by rounding, and a token
    whose two largest gate probabilities lie that close goes to another
    expert, which moves the loss by that expert's output (3.3e-2 at step 3
    here). So there the trainers' own steps are compared for one step; the
    optimizer is held over 3 steps on JAX's gradients either way. With two
    experts of two, every expert takes every token and the routing is smooth."""
    jax_rr, port_rr = make_rerankers(corpus, "BERTMaxP", {
        "pretrained": "tiny", "hidden_dropout_prob": 0.0, "moeexperts": experts, "moetopk": topk,
        "extractor": dict(TRAIN_EXTRACTOR, numpassages=2), "trainer": {"batch": 2, "lr": 1e-3, "bertlr": 1e-3,
                                                                      "itersize": 8}})
    check_training_matches_jax(corpus, jax_rr, port_rr, own_steps=3 if topk == experts else 1)
    config = port_rr.build_model().config
    assert dataclasses.asdict(config)["moe_experts"] == experts and config.moe_topk == topk
