"""Slice 4 module by module and as a whole: the PyTorch port's int8 inference
(X1's plain version, the int8 BERT encoder, BERTMaxP with ``quantize=int8``
and its ``RerankingService``, and the ColBERT searcher's int8 / int4 corpora)
against the JAX package, on the CPU, where ``int8_mm`` runs
``int8_matmul_plain``.

Tolerances (``pytest -s`` prints each measured error):
- X1's plain version against the Pallas X1 and X2 kernels in interpret mode
  and against int64 numpy: equal (the int32 product is exact).
- int8 codes and scales against the JAX functions run op by op: equal. Under
  ``jax.jit`` XLA folds ``amax / 127`` into ``amax * (1/127)``, so a scale may
  differ by an ulp (rtol 2.4e-7) and a code on a rounding boundary by one step:
  at most 1e-3 of the codes, each by one step.
- ``Int8Linear`` against ``Int8Dense``, weight codes and scales: equal; outputs
  1e-5 (equal int32 products, the f32 dequantization in the same order).
- the int8 encoder, BERTMaxP and the service against JAX with the same stats:
  1e-4 at the tiny config and at BERT-base width (one layer): the f32 hidden
  states differ by rounding (LayerNorm variance, matmul sums, as in the f32
  tests), and a per-token code that sits on a rounding boundary can flip by one
  step.
- an int8 layer is a step function of its input: where the input moves by
  1e-7 (rounding), a code on a rounding boundary flips by one step and the
  output moves by up to 5e-2 (9.5e-3 measured at BERT-base width), where the
  f32 layer's moves by at most 1e-5. The tiny layers the card's service test
  serves (N(0, 0.2) weights) move by up to 1e-1, at most 5% of their outputs
  by more than 1e-4 (5.3e-2 and 1.1% measured over six seeds): the card test's
  per-layer bounds. Over many layers such flips add up (the tiny model's int8
  scores move by 8.3e-3 of the largest, bounded at 3e-2), so comparisons
  across devices go layer by layer (``chip_smoke.py``,
  ``tests/test_torch_cuda.py``).
- calibrated ``gelu_amax`` against JAX's ``quant_stats``: 1e-2 of each layer's
  largest stat. The first layer's agree to rounding (2.4e-7 measured); after
  it, a per-token code that flips by one step moves a GELU input by
  ``x_scale * w_scale * wq``, up to 0.4% of the largest stat at the tiny
  width, which can move a channel's max (4.0e-3 measured). Scores of two
  models that each calibrated itself, whose folded FFN scales then differ by
  as much: 5e-3 (1.3e-3 measured on scores near 0.1-0.4).
- ColBERT searcher and service with int8 / int4 corpora: 1e-2, the JAX suite's
  tolerance for bf16 MaxSim sums, with the same docid order except at
  near-ties: two docs that trade places score within that tolerance of each
  other in both lists.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path
from unittest import mock

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

from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.ops import quantization as jq  # noqa: E402
from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu.reranker.bert import BertConfig as JaxBertConfig  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import Int8Dense  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import _quantize_per_token as jax_quantize_per_token  # noqa: E402
from capreolus_tpu.reranker.bert_rerankers import _BertScorer as JaxBertScorer  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.serving import ColbertRetrievalService as JaxColbertService  # noqa: E402
from capreolus_tpu.serving import RerankingService as JaxRerankingService  # noqa: E402
from capreolus_tpu_torch.convert import bert_state_dict, load_params, save_params  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402
from capreolus_tpu_torch.ops import int8_matmul as im  # noqa: E402
from capreolus_tpu_torch.ops import quantization as pq  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.reranker.bert import BertConfig  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import Int8Linear, _quantize_per_token  # noqa: E402
from capreolus_tpu_torch.reranker.bert_rerankers import _BertScorer  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from capreolus_tpu_torch.searcher import late_interaction as li  # noqa: E402
from capreolus_tpu_torch.serving import ColbertRetrievalService, RerankingService  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, TINY, TINY_TORCH, assert_within, bert_batch  # noqa: E402
from test_torch_colbert import QUERIES, SEARCHER, jax_tiny_checkpoint  # noqa: E402
from test_torch_cuda import assert_same_ranking as assert_same_ranking_across  # noqa: E402
from test_torch_index import torch_cache, write_trec_corpus  # noqa: E402,F401
from test_torch_knrm import flatten_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENCODER_TOL = 1e-4
AMAX_TOL = 1e-2
SELF_CALIBRATED_TOL = 5e-3
SEARCH_TOL = 1e-2
JIT_FLIP_SHARE = 1e-3
SCALE_RTOL = 2.4e-7


def int8_pair(m, n, k, seed):
    """a [M, K] and w [N, K] int8 over the full range, -128 in row 0 of each."""
    rng = np.random.Generator(np.random.PCG64(seed))
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    w = rng.integers(-128, 128, size=(n, k), dtype=np.int8)
    a[0, ::2], w[0] = -128, -128
    return a, w


# ---------------------------------------------------------------- X1 / X2 (the plain version)
def load_script(name):
    """A ``scripts/`` module by path. Importing it points JAX's compilation
    cache at ``.bench_cache/``; the setting in force before is restored."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_torch_int8_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return module


@pytest.mark.parametrize("script", ["exp_pallas_int8", "exp_pallas_int8b"])
@pytest.mark.parametrize("m,n,k,bm,bn", [(64, 64, 96, 32, 32), (128, 256, 64, 64, 128), (96, 32, 160, 32, 32)])
def test_plain_matches_pallas_int8_kernel_interpret(script, m, n, k, bm, bn):
    from jax.experimental import pallas as pl

    module = load_script(script)
    a, w = int8_pair(m, n, k, seed=m + n + k)
    with mock.patch.object(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)):
        want = np.asarray(module.pallas_int8_mm(jnp.asarray(a), jnp.asarray(w.T), bm=bm, bn=bn))
    got = im.int8_matmul_plain(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (37, 29, 45), (5, 7, 300), (130, 257, 64), (3, 2, 3072)])
def test_plain_matches_int64_numpy_at_ragged_shapes(m, n, k):
    a, w = int8_pair(m, n, k, seed=m * n + k)
    want = a.astype(np.int64) @ w.astype(np.int64).T
    got = im.int8_mm(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_int8_mm_routes_by_device(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the CUDA binding was called for CPU tensors")

    monkeypatch.setattr(im, "int8_matmul", boom)
    a, w = (torch.from_numpy(x) for x in int8_pair(4, 3, 8, seed=1))
    assert torch.equal(im.int8_mm(a, w), im.int8_matmul_plain(a, w))
    with pytest.raises(ValueError, match="unsupported device"):
        im.int8_mm(a.to("meta"), w.to("meta"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        im.int8_matmul(a, w)


# ---------------------------------------------------------------- quantization
def assert_codes_close(got, want, what, share=JIT_FLIP_SHARE):
    """int8 codes equal but for a share of one-step flips."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    print(f"{what}: {int((diff > 0).sum())} of {diff.size} codes differ, by at most {int(diff.max())}")
    assert diff.max() <= 1 and (diff > 0).mean() <= share


def test_quantize_per_token_matches_jax():
    rng = np.random.Generator(np.random.PCG64(2))
    x = (rng.standard_normal((4, 96, 768)) * 3).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero token takes the 1e-6 floor
    xq, xs = _quantize_per_token(torch.from_numpy(x))
    want_q, want_s = jax_quantize_per_token(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(want_s))
    assert xq.dtype == torch.int8 and xs.shape == (4, 96, 1)
    jit_q, jit_s = jax.jit(jax_quantize_per_token)(jnp.asarray(x))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jit_s), rtol=SCALE_RTOL, atol=0)
    assert_codes_close(xq.numpy(), jit_q, "per-token codes vs jitted JAX")


def test_quantize_rows_and_int4_are_bit_identical_to_jax():
    rng = np.random.Generator(np.random.PCG64(3))
    emb = (rng.standard_normal((23, 7, 16)) * 0.3).astype(np.float16)
    emb[4] = 0
    for slab_rows in (65536, 5):
        got, want = pq.quantize_rows(emb, slab_rows), jq.quantize_rows(emb, slab_rows)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for d in (112, 111):  # odd D: zero-padded nibble
            got, want = pq.quantize_rows_int4(emb.reshape(23, -1)[:, :d], slab_rows), \
                jq.quantize_rows_int4(emb.reshape(23, -1)[:, :d], slab_rows)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    packed = rng.integers(0, 256, size=(9, 13), dtype=np.uint8)
    np.testing.assert_array_equal(pq.unpack_int4(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jq.unpack_int4_jnp(jnp.asarray(packed))))
    codes, _ = pq.quantize_rows_int4(emb.reshape(23, -1))
    unpacked = pq.unpack_int4(torch.from_numpy(codes)).numpy()
    want = np.clip(np.round(emb.reshape(23, -1).astype(np.float32)
                            / pq.quantize_rows_int4(emb.reshape(23, -1))[1][:, None]), -7, 7)
    np.testing.assert_array_equal(unpacked, want.astype(np.int8))


def test_quantize_rows_torch_matches_jnp():
    """One scale per query, over [Lq, dim]."""
    rng = np.random.Generator(np.random.PCG64(4))
    q = rng.standard_normal((5, 32, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[3] = 0.0  # an all-zero query takes scale 1
    got_q, got_s = pq.quantize_rows_torch(torch.from_numpy(q))
    want_q, want_s = jq.quantize_rows_jnp(jnp.asarray(q))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s.shape == (5,) and float(got_s[3]) == 1.0
    jit_q, jit_s = jax.jit(jq.quantize_rows_jnp)(jnp.asarray(q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(jit_s), rtol=SCALE_RTOL, atol=0)
    assert_codes_close(got_q.numpy(), jit_q, "per-query codes vs jitted JAX")


# ---------------------------------------------------------------- Int8Linear
@pytest.mark.parametrize("mode", ["x", "x_pre+x_scales", "x_pre+fold_scales"])
def test_int8_linear_matches_int8_dense(mode):
    rng = np.random.Generator(np.random.PCG64(5))
    x = (rng.standard_normal((3, 40, 96)) * 2).astype(np.float32)
    dense = Int8Dense(48)
    variables = dense.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = {"params": {"kernel": variables["params"]["kernel"],
                            "bias": jnp.asarray(rng.standard_normal(48).astype(np.float32) * 0.1)}}
    linear = Int8Linear(96, 48)
    state = bert_state_dict({f"params/linear/{k}": np.asarray(v) for k, v in variables["params"].items()})
    linear.load_state_dict({key.split(".", 1)[1]: value for key, value in state.items()})
    xt = torch.from_numpy(x)
    if mode == "x":
        want = dense.apply(variables, jnp.asarray(x))
        got = linear(xt)
        fold = None
    elif mode == "x_pre+x_scales":
        hq, hs = jax_quantize_per_token(jnp.asarray(x))
        want = dense.apply(variables, jnp.asarray(x), x_pre=hq, x_scales=hs)
        got = linear(None, x_pre=torch.from_numpy(np.array(hq)), x_scales=torch.from_numpy(np.array(hs)))
        fold = None
    else:  # per-channel scales folded into the weight, as the int8 FFN feeds ffn_output
        s = (np.abs(x).reshape(-1, 96).max(axis=0) / 127.0).astype(np.float32)
        gq = np.clip(np.round(x / s), -127, 127).astype(np.int8)
        want = dense.apply(variables, jnp.asarray(x), x_pre=jnp.asarray(gq), fold_scales=jnp.asarray(s))
        fold = torch.from_numpy(s)
        linear.quantize_weight(fold_scales=fold)
        got = linear(None, x_pre=torch.from_numpy(gq))
    assert_within(got.detach().numpy(), np.asarray(want), 1e-5, f"Int8Linear vs Int8Dense ({mode})")
    # the weight codes and scales, as Int8Dense computes them in its graph
    kf = np.asarray(variables["params"]["kernel"]) * (1.0 if fold is None else np.asarray(s)[:, None])
    ws = np.maximum(np.abs(kf).max(axis=0), 1e-8) / np.float32(127.0)
    np.testing.assert_array_equal(linear.weight_q.numpy(), np.round(kf / ws).astype(np.int8).T)
    np.testing.assert_array_equal(linear.weight_scale.numpy(), ws)


def test_int8_linear_requantizes_after_a_load():
    linear = Int8Linear(8, 4)
    with torch.no_grad():
        linear(torch.ones(2, 8))
    assert linear.weight_q is not None and linear.weight_scale.shape == (4,)
    linear.load_state_dict({"weight": torch.full((4, 8), 0.5), "bias": torch.zeros(4)})
    assert linear.weight_q is None and "weight_q" not in linear.state_dict()
    with torch.no_grad():
        out = linear(torch.ones(2, 8))
    assert bool((linear.weight_q == 127).all())
    torch.testing.assert_close(out, torch.full((2, 4), 4.0))


def test_int8_layer_refolds_ffn_output_whenever_its_stats_change():
    """``ffn_output``'s codes always carry the current ``gelu_amax`` folded in:
    after an assignment, a load of the stats alone or of the whole layer, and a
    calibration."""
    from capreolus_tpu_torch.reranker.bert.encoder import BertLayer

    layer = BertLayer(dataclasses.replace(TINY_TORCH, quantize="int8")).eval()

    def assert_folded():
        want = Int8Linear(128, 64)
        want.load_state_dict(layer.ffn_output.state_dict())
        want.quantize_weight(fold_scales=layer.gelu_scales())
        assert torch.equal(layer.ffn_output.weight_q, want.weight_q)
        assert torch.equal(layer.ffn_output.weight_scale, want.weight_scale)

    rng = np.random.Generator(np.random.PCG64(4))
    layer.gelu_amax = torch.from_numpy(rng.random(128).astype(np.float32) * 3 + 0.5)
    assert_folded()
    state = {k: v.clone() for k, v in layer.state_dict().items()}
    state["gelu_amax"] = torch.from_numpy(rng.random(128).astype(np.float32) * 9)
    layer.load_state_dict(state)
    assert_folded()
    layer.load_state_dict({"gelu_amax": torch.full((128,), 1e-3)}, strict=False)
    assert_folded()
    with torch.no_grad():
        layer(torch.randn(2, 16, 64) * 30, torch.ones(2, 16, dtype=torch.bool), calibrate=True)
    assert float(layer.gelu_amax.max()) > 1e-3
    assert_folded()


def test_quantized_engine_runs_one_product_per_chunk(monkeypatch):
    """``quantized_maxsim_scores`` runs one ``int8_mm`` for every
    ``quantized_chunk_docs`` docs, the last chunk the rest."""
    shapes = []

    def counting_mm(a, w):
        shapes.append((a.shape[0], w.shape[0]))
        return im.int8_matmul_plain(a, w)

    monkeypatch.setattr(im, "int8_mm", counting_mm)
    monkeypatch.setattr(li, "SIM_CHUNK_BYTES", 4 * 6 * 7 * 5)  # 5 docs of 7 tokens for 2 queries of 3 tokens
    rng = np.random.Generator(np.random.PCG64(10))
    codes, scale = pq.quantize_rows(rng.standard_normal((23, 7, 8)).astype(np.float32))
    li.quantized_maxsim_scores(torch.randn(2, 3, 8), torch.from_numpy(codes), torch.ones(23, 7, dtype=torch.bool),
                               torch.from_numpy(scale))
    assert li.quantized_chunk_docs(2, 3, 7) == 5
    assert shapes == [(6, 35)] * 4 + [(6, 21)]


# ---------------------------------------------------------------- the int8 encoder
def jax_int8_variables(jax_cfg, args, seed):
    """JAX int8 _BertScorer variables from init, calibrated on ``args``."""
    model = JaxBertScorer(dataclasses.replace(jax_cfg, quantize="int8"))
    variables = model.init(jax.random.PRNGKey(seed), *args)
    _, stats = model.apply(variables, *args, calibrate=True, mutable=["quant_stats"])
    return model, {"params": variables["params"], **stats}


@pytest.mark.parametrize("width", ["tiny", "base-1-layer"])
def test_int8_encoder_matches_jax_with_the_same_stats(width):
    if width == "tiny":
        jax_cfg, cfg, batch = TINY, TINY_TORCH, bert_batch(3, 4, 64, qlen=5, seed=11, vocab=5000)
    else:
        jax_cfg, cfg = JaxBertConfig(num_layers=1), BertConfig(num_layers=1)
        batch = bert_batch(2, 2, 128, qlen=12, seed=13)
    args = [batch[k] for k in ("pos_bert_input", "pos_mask", "pos_seg")]
    jax_model, variables = jax_int8_variables(jax_cfg, args, seed=3)
    want = np.asarray(jax_model.apply(variables, *args))
    model = _BertScorer(dataclasses.replace(cfg, quantize="int8"))
    model.load_state_dict(bert_state_dict(flatten_params(variables)))  # quant_stats carried through convert
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a) for a in args)).numpy()
    assert_within(got, want, ENCODER_TOL, f"int8 encoder {width}, passage scores with JAX's stats")
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(getattr(model.bert, f"layer_{i}").gelu_amax.numpy(),
                                      np.asarray(variables["quant_stats"]["bert"][f"layer_{i}"]["gelu_amax"]))


def seed_weights(model, seed, std):
    """LayerNorm scales 1, biases and LayerNorm shifts 0, every other
    parameter N(0, std), drawn from ``seed`` (the chip smoke test's recipe)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_ln." in name or name.endswith("bias"):
                p.fill_(1.0 if name.endswith("_ln.weight") else 0.0)
            else:
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32) * std))


def test_int8_layer_is_a_step_function_of_its_input():
    """A BERT-base-width int8 layer (seeded N(0, 0.02) weights, as the chip
    smoke test serves) moves by a one-step code flip where its input moves by
    rounding: at most 5e-2 (the chip check's bound for a layer run on the card
    and on the CPU from the same input), where the f32 layer moves by 1e-5."""
    batch = bert_batch(2, 4, 128, qlen=12, seed=21)
    ids, mask, seg = (torch.from_numpy(batch[k].reshape(-1, 128)) for k in ("pos_bert_input", "pos_mask", "pos_seg"))
    moved = {}
    for quantize in ("none", "int8"):
        model = _BertScorer(BertConfig(num_layers=1, quantize=quantize)).eval()
        with torch.no_grad():
            seed_weights(model, 12, std=0.02)
            model(ids[None], mask[None], seg[None], calibrate=True)
            hidden, keys = model.bert.embed(ids, seg), mask.bool()
            out = model.bert.layer_0(hidden, keys)
            noise = torch.from_numpy(np.random.Generator(np.random.PCG64(13)).standard_normal(hidden.shape)
                                     .astype(np.float32))
            moved[quantize] = float((model.bert.layer_0(hidden * (1 + 1e-7 * noise), keys) - out).abs().max())
    print(f"one layer, input moved by 1e-7: f32 output moves {moved['none']:.3g}, int8 {moved['int8']:.3g}")
    assert moved["none"] <= 1e-5 and moved["int8"] <= 5e-2


def test_tiny_int8_layers_move_under_rounding():
    """The tiny layers of the card's service test (seeded N(0, 0.2) weights),
    each fed the output of the one before: where a layer's input moves by
    1e-7, its outputs move by at most 1e-1 and at most 5% of them by more than
    1e-4, the card test's per-layer bounds, over six seeds of weights and
    batch."""
    worst, share = 0.0, 0.0
    for seed in range(6):
        rng = np.random.Generator(np.random.PCG64(100 + seed))
        ids = torch.from_numpy(rng.integers(1, 1024, size=(8, 4, 128)))
        mask = torch.from_numpy((np.arange(128)[None, None] < rng.integers(20, 129, size=(8, 4, 1))).astype(np.int64))
        seg = torch.zeros_like(ids)
        model = _BertScorer(dataclasses.replace(TINY_TORCH, quantize="int8")).eval()
        with torch.no_grad():
            seed_weights(model, seed, std=0.2)
            model(ids, mask, seg, calibrate=True)
            hidden, keys = model.bert.embed(ids.reshape(-1, 128), seg.reshape(-1, 128)), mask.reshape(-1, 128).bool()
            for i in range(TINY_TORCH.num_layers):
                layer = getattr(model.bert, f"layer_{i}")
                out = layer(hidden, keys)
                noise = torch.from_numpy(rng.standard_normal(tuple(hidden.shape)).astype(np.float32))
                moved = (layer(hidden * (1 + 1e-7 * noise), keys) - out).abs()
                worst, share = max(worst, float(moved.max())), max(share, float((moved > 1e-4).float().mean()))
                hidden = out
    print(f"tiny int8 layers, input moved by 1e-7: outputs move by up to {worst:.3g}, at most {share:.3g} of them "
          f"by more than 1e-4")
    assert worst <= 1e-1 and share <= 5e-2


def test_int8_tiny_scores_move_under_rounding():
    """The tiny model of the card's service test (seeded N(0, 0.2) weights):
    where its embeddings move by 1e-7, int8 scores move by up to 3e-2 of the
    largest score (8.3e-3 measured), f32 scores by 1e-5. This is why the card
    test compares the two devices layer by layer."""
    batch = bert_batch(50, 4, 128, qlen=5, seed=3, vocab=1024)
    args = [torch.from_numpy(batch[k]) for k in ("pos_bert_input", "pos_mask", "pos_seg")]
    moved = {}
    for quantize in ("none", "int8"):
        model = _BertScorer(dataclasses.replace(TINY_TORCH, quantize=quantize)).eval()
        with torch.no_grad():
            seed_weights(model, 8, std=0.2)
            model(*args, calibrate=True)
            base = model(*args)
            emb = model.bert.word_embeddings.data.clone()
            noise = np.random.Generator(np.random.PCG64(9)).standard_normal(tuple(emb.shape)).astype(np.float32)
            model.bert.word_embeddings.data = emb * (1 + 1e-7 * torch.from_numpy(noise))
            moved[quantize] = float((model(*args) - base).abs().max() / base.abs().max())
    print(f"tiny BERTMaxP, embeddings moved by 1e-7: f32 scores move {moved['none']:.3g} of the largest, "
          f"int8 {moved['int8']:.3g}")
    assert moved["none"] <= 1e-5 and moved["int8"] <= 3e-2


def _reranker_pair(options, extractor=None):
    cfg = dict(options, extractor=dict(extractor or EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER,
                                       index={"collection": {"name": "dummy"}}))
    return JaxReranker.create("BERTMaxP", cfg), TorchReranker.create("BERTMaxP", cfg)


def _load_port(port_rr, flat):
    port_rr.build_model().load_state_dict(port_rr.state_dict_from_params(flat))
    return port_rr.model.eval()


def test_prepare_inference_and_uncalibrated_fallback_match_jax():
    jax_rr, port_rr = _reranker_pair({"pretrained": "tiny", "quantize": "int8", "aggregation": "max"})
    batch = bert_batch(3, 2, 64, qlen=5, seed=17, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(7), batch)
    model = _load_port(port_rr, flatten_params(params))
    assert all(float(b.abs().max()) == 0.0 for n, b in model.named_buffers() if n.endswith("gelu_amax"))

    # uncalibrated: zero stats select amax = 8 in every channel, on both sides
    want = np.asarray(jax_rr.test(params, batch))
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert_within(got, want, ENCODER_TOL, "BERTMaxP int8, uncalibrated (amax = 8 fallback)")

    jax_rr.prepare_inference(params, batch)
    port_rr.prepare_inference(batch, "cpu")
    for i in range(model.config.num_layers):
        want_amax = np.asarray(jax_rr._quant_stats["bert"][f"layer_{i}"]["gelu_amax"])
        got_amax = getattr(model.bert, f"layer_{i}").gelu_amax.numpy()
        assert (got_amax > 0).all()
        assert_within(got_amax / want_amax.max(), want_amax / want_amax.max(), AMAX_TOL,
                      f"calibrated gelu_amax, layer {i} (relative to its largest)")
    want = np.asarray(jax_rr.test(jax_rr.inference_variables(params), batch))
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert_within(got, want, SELF_CALIBRATED_TOL, "BERTMaxP int8, each side calibrated on the batch")

    # a second calibration restarts from zero stats, as the JAX one does
    port_rr.prepare_inference({k: v[:1] for k, v in batch.items()}, "cpu")
    jax_rr.prepare_inference(params, {k: v[:1] for k, v in batch.items()})
    np.testing.assert_allclose(model.bert.layer_0.gelu_amax.numpy(),
                               np.asarray(jax_rr._quant_stats["bert"]["layer_0"]["gelu_amax"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("aggregation", ["max", "avg"])
def test_bertmaxp_int8_scores_match_jax(aggregation):
    """Scores with the stats JAX calibrated, carried through ``convert``."""
    jax_rr, port_rr = _reranker_pair({"pretrained": "tiny", "quantize": "int8", "aggregation": aggregation})
    batch = bert_batch(3, 4, 64, qlen=5, seed=19, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(9), batch)
    jax_rr.prepare_inference(params, batch)
    variables = jax_rr.inference_variables(params)
    want = np.asarray(jax_rr.test(variables, batch))
    _load_port(port_rr, flatten_params(variables))
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert_within(got, want, ENCODER_TOL, f"BERTMaxP int8 tiny, aggregation {aggregation}")


def test_int8_and_f32_models_share_one_checkpoint():
    """quantize=int8 changes no parameter name: an f32 checkpoint loads into
    the int8 model, whose extra state is one gelu_amax per layer."""
    _, f32_rr = _reranker_pair({"pretrained": "tiny"})
    _, int8_rr = _reranker_pair({"pretrained": "tiny", "quantize": "int8"})
    f32_keys, int8_keys = set(f32_rr.build_model().state_dict()), set(int8_rr.build_model().state_dict())
    assert int8_keys - f32_keys == {f"bert.layer_{i}.gelu_amax" for i in range(2)} and f32_keys <= int8_keys
    assert isinstance(int8_rr.model.bert.layer_0.ffn_output, Int8Linear)
    assert type(f32_rr.model.bert.layer_0.ffn_output) is torch.nn.Linear


def test_moe_and_int8_raise_the_jax_message():
    options = {"pretrained": "tiny", "quantize": "int8", "moeexperts": 2}
    jax_rr, _ = _reranker_pair({"pretrained": "tiny"})
    cfg = dict(options, extractor=dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER,
                                       index={"collection": {"name": "dummy"}}))
    with pytest.raises(JaxConfigError) as jax_err:
        JaxReranker.create("BERTMaxP", cfg).build_model()
    with pytest.raises(ConfigError) as port_err:
        TorchReranker.create("BERTMaxP", cfg)
    assert str(port_err.value) == str(jax_err.value) == "moeexperts and quantize=int8 cannot be combined"
    with pytest.raises(ConfigError, match="'none' or 'int8'"):
        TorchReranker.create("BERTMaxP", dict(cfg, quantize="int4", moeexperts=0))


@pytest.mark.parametrize("name", ["ptBERTMaxP", "TFVanillaBERT"])
def test_aliases_take_quantize(name):
    reranker = TorchReranker.create(name, {"pretrained": "tiny", "quantize": "int8", "extractor": {
        "tokenizer": OFFLINE_TOKENIZER, "index": {"collection": {"name": "dummy"}}}})
    assert reranker.build_model().config.quantize == "int8"


def test_cpu_int8_paths_never_take_the_kernel(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the CUDA binding was called for CPU tensors")

    monkeypatch.setattr(im, "int8_matmul", boom)
    model = _BertScorer(dataclasses.replace(TINY_TORCH, quantize="int8")).eval()
    ids = torch.randint(0, 1024, (2, 2, 16))
    with torch.inference_mode():
        assert model(ids, torch.ones_like(ids), torch.zeros_like(ids), calibrate=True).shape == (2, 2)
    rng = np.random.Generator(np.random.PCG64(6))
    codes, scale = pq.quantize_rows(rng.standard_normal((5, 6, 8)).astype(np.float32))
    scores = li.quantized_maxsim_scores(torch.randn(2, 3, 8), torch.from_numpy(codes), torch.ones(5, 6, dtype=torch.bool),
                                        torch.from_numpy(scale))
    assert scores.shape == (2, 5) and bool(torch.isfinite(scores).all())


# ---------------------------------------------------------------- RerankingService
def _service_pair(tmp_path, quant_stats):
    coll = {"name": "dummy"}
    config = {"pretrained": "tiny", "quantize": "int8",
              "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, index={"collection": coll})}
    jax_reranker = JaxReranker.create("BERTMaxP", config)
    ckpt = tmp_path / "bert" / "weights"
    jax_svc = JaxRerankingService(capreolus_tpu.index.Index.create("tpu", {"collection": coll}), jax_reranker,
                                  ckpt, topn=3)
    shape = (1, EXTRACTOR_TINY["numpassages"], EXTRACTOR_TINY["maxseqlen"])
    example = {key: np.zeros(shape, np.int64) for key in ("pos_bert_input", "pos_mask", "pos_seg")}
    params = jax_reranker.init_params(jax.random.PRNGKey(123), example)
    jax_reranker.trainer.save_checkpoint(ckpt, params, {}, jax_reranker)
    flat = flatten_params(jax_reranker.trainer._strip_frozen(jax_reranker, params))
    flat.update({f"quant_stats/{k}": v for k, v in quant_stats.items()})
    port_ckpt = save_params(flat, tmp_path / "bert.npz")
    port_svc = RerankingService(TorchIndex.create("tpu", {"collection": coll}),
                                TorchReranker.create("BERTMaxP", config), port_ckpt, topn=3, device="cpu")
    return jax_svc, port_svc


QUERIES_BERT = ["distant galaxies telescope", "telescope observed whales", "galaxies in orbit"]


def assert_same_ranking(port_hits, jax_hits, tol, what):
    """``test_torch_cuda.assert_same_ranking`` (the same docids in the same
    order but for near-ties, every shared doc within ``tol``), then the shared
    docs' largest error printed against ``tol``."""
    assert_same_ranking_across(port_hits, jax_hits, tol, what)
    jax_scores = dict(jax_hits)
    assert_within([s for d, s in port_hits if d in jax_scores], [jax_scores[d] for d, _ in port_hits if d in jax_scores],
                  tol, what)


def test_int8_reranking_service_calibrates_on_the_first_request_as_jax(tmpdir_as_cache, torch_cache):
    jax_svc, port_svc = _service_pair(tmpdir_as_cache, {})
    assert port_svc._calibrate_pending
    port_results, jax_results = port_svc.search(QUERIES_BERT, k=3), jax_svc.search(QUERIES_BERT, k=3)
    assert not port_svc._calibrate_pending and all(len(hits) >= 2 for hits in port_results)
    for port_hits, jax_hits in zip(port_results, jax_results):
        assert_same_ranking(port_hits, jax_hits, SELF_CALIBRATED_TOL, "int8 BERTMaxP RerankingService vs JAX")
    # calibrated once, on the first request's batch, as JAX's _ensure_params does
    stats = jax_svc.reranker._quant_stats["bert"]
    for i in range(2):
        want = np.asarray(stats[f"layer_{i}"]["gelu_amax"])
        got = getattr(port_svc.reranker.model.bert, f"layer_{i}").gelu_amax.numpy()
        assert_within(got / want.max(), want / want.max(), AMAX_TOL, f"service gelu_amax, layer {i}")


def test_int8_reranking_service_uses_the_checkpoints_stats(tmpdir_as_cache, torch_cache):
    rng = np.random.Generator(np.random.PCG64(8))
    stats = {f"bert/layer_{i}/gelu_amax": (rng.random(128) * 3 + 0.5).astype(np.float32) for i in range(2)}
    _, port_svc = _service_pair(tmpdir_as_cache, stats)
    assert not port_svc._calibrate_pending
    assert all(len(hits) >= 2 for hits in port_svc.search(QUERIES_BERT, k=3))
    for i in range(2):
        np.testing.assert_array_equal(getattr(port_svc.reranker.model.bert, f"layer_{i}").gelu_amax.numpy(),
                                      stats[f"bert/layer_{i}/gelu_amax"])
    assert set(load_params(tmpdir_as_cache / "bert.npz")) >= {f"quant_stats/{k}" for k in stats}


# ---------------------------------------------------------------- ColBERT quantized corpora
@pytest.mark.parametrize("options", [{"quantize": "int8"}, {"quantize": "int4"}, {"quantize": "int4", "rescore": 0}],
                         ids=["int8", "int4-rescore", "int4-no-rescore"])
def test_quantized_searcher_matches_jax_on_dummy(tmpdir_as_cache, torch_cache, options):
    jax_searcher = JaxSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, **options})
    jax_searcher.index.create_index()
    ckpt = jax_tiny_checkpoint(jax_searcher, torch_cache / "colbert.npz")
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": ckpt, **options})
    searcher.device = "cpu"
    for query in QUERIES:
        got, want = searcher.query(query), jax_searcher.query(query)
        assert len(got) == 3
        assert_same_ranking(list(got.items()), list(want.items()), SEARCH_TOL, f"colbert {options} '{query}'")
    codes, mask, scale = searcher._docs_emb
    assert mask.dtype == torch.bool and scale.dtype == torch.float32
    assert codes.dtype == (torch.int8 if options["quantize"] == "int8" else torch.uint8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jax_searcher._docs_emb[0]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jax_searcher._docs_emb[2]))


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_service_matches_jax_on_a_small_corpus(tmpdir_as_cache, torch_cache, quantize):
    corpus = tmpdir_as_cache / "corpus"
    write_trec_corpus(corpus, num_docs=60, seed=31, min_len=10, max_len=60)
    config = {key: value for key, value in SEARCHER.items() if key != "index"}
    config.update(quantize=quantize, rescore=20)
    queries = ["w1 w7 w30", "w2 w25 galaxy", "w39 w5 w6 w8", "w11", "w3 w4", "orbit w12"]
    jax_svc = JaxColbertService.from_config(collection="dummy", collection_path=str(corpus), max_k=10,
                                            allowrandominit=True, **config)
    ckpt = jax_tiny_checkpoint(jax_svc.searcher, torch_cache / "colbert.npz")
    port_svc = ColbertRetrievalService.from_config(collection="dummy", collection_path=str(corpus), max_k=10,
                                                   device="cpu", checkpointfile=ckpt, **config)
    for port_hits, jax_hits in zip(port_svc.search(queries, k=10), jax_svc.search(queries, k=10)):
        assert len(port_hits) == 10
        assert_same_ranking(port_hits, jax_hits, SEARCH_TOL, f"ColbertRetrievalService {quantize} vs JAX")


def test_quantized_scores_do_not_depend_on_the_chunk(monkeypatch):
    rng = np.random.Generator(np.random.PCG64(9))
    emb = (rng.standard_normal((23, 7, 16)) * 0.3).astype(np.float32)
    mask = torch.from_numpy(rng.random((23, 7)) > 0.3)
    mask[[0, 11]] = False  # docs with no valid token score -inf
    q = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    for codes, scale in (pq.quantize_rows(emb), pq.quantize_rows_int4(emb.reshape(23, -1))):
        args = (q, torch.from_numpy(codes), mask, torch.from_numpy(scale))
        whole = li.quantized_maxsim_scores(*args)
        monkeypatch.setattr(li, "SIM_CHUNK_BYTES", 4 * 15 * 7 * 4)  # 4 docs per chunk
        torch.testing.assert_close(li.quantized_maxsim_scores(*args), whole, rtol=0, atol=0)
        monkeypatch.undo()
        assert bool(torch.isneginf(whole[:, [0, 11]]).all()) and bool(torch.isfinite(whole[:, 1]).all())
