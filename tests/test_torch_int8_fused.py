"""Slice 5 on the CPU: the plain versions of X1's f32 and int8-gelu epilogues
and of Q1 (per-token quantization), against the JAX package and against the
arithmetic the int8 encoder ran before the epilogues were fused, and the
fused wiring of the int8 encoder.

Tolerances (``pytest -s`` prints each measured error):
- Q1's plain version against JAX ``_quantize_per_token`` run op by op: equal
  codes and scales.
- the f32 epilogue's plain version against ``Int8Linear``'s unfused
  arithmetic: bit-identical; against JAX ``Int8Dense``: ``ENCODER_TOL`` (equal
  int32 products, the f32 dequantization in the same order).
- the int8-gelu epilogue's plain codes against the JAX chain
  ``clip(round(gelu(Int8Dense(x)) / s))``: one step at most, at a share of at
  most ``JIT_FLIP_SHARE`` of the codes: XLA's and torch's GELU can round apart
  at a code boundary.
- the fused wiring, run on CPU tensors through the kernels' bindings (patched
  to their plain versions), against the unfused arithmetic: bit-identical
  outside the GELU requantization, GELU codes within one step (equal here,
  since the plain versions run the same ops), and the tiny int8 encoder within
  ``ENCODER_TOL`` of JAX with JAX's stats.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.reranker.bert.encoder import Int8Dense  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import _quantize_per_token as jax_quantize_per_token  # noqa: E402
from capreolus_tpu_torch.convert import bert_state_dict  # noqa: E402
from capreolus_tpu_torch.ops import build  # noqa: E402
from capreolus_tpu_torch.ops import int8_matmul as im  # noqa: E402
from capreolus_tpu_torch.ops import quantization as pq  # noqa: E402
from capreolus_tpu_torch.ops.flash_attention import multihead_attention  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import Int8Linear  # noqa: E402
from capreolus_tpu_torch.reranker.bert_rerankers import _BertScorer  # noqa: E402
from test_torch_bert import TINY, TINY_TORCH, assert_within, bert_batch  # noqa: E402
from test_torch_int8 import (ENCODER_TOL, JIT_FLIP_SHARE, assert_codes_close, int8_pair,  # noqa: E402
                             jax_int8_variables, seed_weights)
from test_torch_knrm import flatten_params  # noqa: E402


def dense_pair(n_in, n_out, seed, x):
    """A JAX ``Int8Dense`` with its variables (N(0, 0.1) bias) and the
    ``Int8Linear`` that loads them."""
    rng = np.random.Generator(np.random.PCG64(seed))
    dense = Int8Dense(n_out)
    kernel = dense.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]["kernel"]
    variables = {"params": {"kernel": kernel, "bias": jnp.asarray(rng.standard_normal(n_out).astype(np.float32) * 0.1)}}
    linear = Int8Linear(n_in, n_out)
    state = bert_state_dict({f"params/linear/{k}": np.asarray(v) for k, v in variables["params"].items()})
    linear.load_state_dict({key.split(".", 1)[1]: value for key, value in state.items()})
    linear.quantize_weight()
    return dense, variables, linear


def unfused_linear(linear, x=None, x_pre=None, x_scales=None):
    """``Int8Linear.forward`` before the fused epilogues: the int32 product,
    then f32 dequantization by torch ops, in place."""
    if x_pre is None:
        x_pre, x_scales = pq.quantize_per_token_plain(x)
    lead = x_pre.shape[:-1]
    out = im.int8_matmul_plain(x_pre.reshape(-1, x_pre.shape[-1]), linear.weight_q).view(*lead, -1).float()
    if x_scales is not None:
        out.mul_(x_scales)
    return out.mul_(linear.weight_scale).add_(linear.bias)


# ---------------------------------------------------------------- Q1
@pytest.mark.parametrize("shape", [(4, 96, 768), (37, 45), (3, 1)])
def test_q1_plain_matches_jax(shape):
    rng = np.random.Generator(np.random.PCG64(sum(shape)))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0  # an all-zero token takes the 1e-6 floor
    got_q, got_s = pq.quantize_per_token_plain(torch.from_numpy(x))
    want_q, want_s = jax_quantize_per_token(jnp.asarray(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.dtype == torch.int8 and got_s.shape == (*shape[:-1], 1)
    dispatched = pq.quantize_tokens(torch.from_numpy(x))
    assert torch.equal(dispatched[0], got_q) and torch.equal(dispatched[1], got_s)


def test_q1_plain_divides_by_127():
    """The scale is ``amax / 127`` rounded once (a true division), never
    ``amax * (1 / 127)``, which can land one ulp away."""
    amax = torch.from_numpy(np.random.Generator(np.random.PCG64(5)).random(4096).astype(np.float32) * 10 + 1e-3)
    x = torch.zeros(4096, 3)
    x[:, 1] = amax
    _, scales = pq.quantize_per_token_plain(x)
    want = (amax.double() / 127.0).float()  # the correctly rounded quotient
    assert torch.equal(scales[:, 0], want)
    assert not torch.equal(want, amax * np.float32(1 / 127))  # the reciprocal differs somewhere


def int8_scale_sites(seed):
    """The per-channel and per-row scales the port computes besides Q1's, each
    with the amax it divides: ``Int8Linear.quantize_weight`` (per output
    channel, with and without folded input scales), ``BertLayer.gelu_scales``
    (per FFN channel, 8 where uncalibrated) and ``quantize_rows_torch`` (per
    ColBERT query). Returns {name: (scales, amax)}."""
    from capreolus_tpu_torch.reranker.bert.encoder import BertLayer

    rng = np.random.Generator(np.random.PCG64(seed))
    linear = Int8Linear(768, 768)
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy((rng.standard_normal((768, 768)) * 0.02).astype(np.float32)))
    fold = torch.from_numpy((rng.random(768) * 0.1 + 0.01).astype(np.float32))
    layer = BertLayer(dataclasses.replace(TINY_TORCH, quantize="int8"))
    amax = rng.random(TINY_TORCH.intermediate_size).astype(np.float32) * 10
    amax[::7] = 0.0  # uncalibrated channels
    layer.gelu_amax = torch.from_numpy(amax)
    queries = torch.from_numpy(rng.standard_normal((64, 32, 128)).astype(np.float32))
    out = {}
    linear.quantize_weight()
    out["weight"] = (linear.weight_scale, linear.weight.abs().amax(dim=1).clamp_min(1e-8))
    linear.quantize_weight(fold_scales=fold)
    out["weight_folded"] = (linear.weight_scale, (linear.weight * fold[None, :]).abs().amax(dim=1).clamp_min(1e-8))
    out["gelu"] = (layer.gelu_scales(), torch.where(layer.gelu_amax > 0, layer.gelu_amax, 8.0))
    out["colbert_query"] = (pq.quantize_rows_torch(queries)[1], queries.abs().amax(dim=(1, 2)))
    return out


@pytest.mark.parametrize("site", ["weight", "weight_folded", "gelu", "colbert_query"])
def test_scales_divide_by_127(site):
    """Each scale is ``amax / 127`` rounded once, the division by a tensor of
    127s, never ``amax * (1 / 127)``: bit for bit the correctly rounded
    quotient (the card's own scales are held against these in
    tests/test_torch_cuda.py)."""
    scales, amax = int8_scale_sites(seed=41)[site]
    assert torch.equal(scales, pq.int8_scale(amax))
    assert torch.equal(scales, (amax.double() / 127.0).float())


# ---------------------------------------------------------------- the f32 epilogue
@pytest.mark.parametrize("with_x_scales", [True, False], ids=["x_scales", "folded"])
def test_f32_epilogue_plain_is_the_unfused_int8_linear(with_x_scales):
    rng = np.random.Generator(np.random.PCG64(6))
    x = (rng.standard_normal((3, 40, 96)) * 2).astype(np.float32)
    dense, variables, linear = dense_pair(96, 48, 6, x)
    xq, xs = pq.quantize_per_token_plain(torch.from_numpy(x))
    if with_x_scales:
        want_port = unfused_linear(linear, x_pre=xq, x_scales=xs)
        got = im.int8_linear_plain(xq.reshape(-1, 96), linear.weight_q, linear.weight_scale, linear.bias,
                                   xs.reshape(-1)).view(3, 40, 48)
        want_jax = dense.apply(variables, jnp.asarray(x))
    else:
        want_port = unfused_linear(linear, x_pre=xq)
        got = im.int8_linear_plain(xq.reshape(-1, 96), linear.weight_q, linear.weight_scale,
                                   linear.bias).view(3, 40, 48)
        want_jax = dense.apply(variables, jnp.asarray(x), x_pre=jnp.asarray(xq.numpy()))
    with torch.no_grad():
        assert torch.equal(got, want_port)
        assert torch.equal(linear(None, x_pre=xq, x_scales=xs if with_x_scales else None), want_port)
    assert_within(got.detach().numpy(), np.asarray(want_jax), ENCODER_TOL, f"f32 epilogue (plain) vs Int8Dense")


# ---------------------------------------------------------------- the int8-gelu epilogue
@pytest.mark.parametrize("approximate", ["tanh", "none"])
def test_gelu_epilogue_plain_codes_match_the_jax_chain(approximate):
    rng = np.random.Generator(np.random.PCG64(7))
    x = (rng.standard_normal((4, 64, 96)) * 2).astype(np.float32)
    dense, variables, linear = dense_pair(96, 256, 7, x)
    g = jax.nn.gelu(dense.apply(variables, jnp.asarray(x)), approximate=approximate == "tanh")
    amax = np.asarray(jnp.max(jnp.abs(g.reshape(-1, 256)), axis=0))
    s = (np.where(amax > 0, amax, 8.0) / 127.0).astype(np.float32)
    want = np.asarray(jnp.clip(jnp.round(g / s), -127.0, 127.0).astype(jnp.int8))
    xq, xs = pq.quantize_per_token_plain(torch.from_numpy(x))
    with torch.no_grad():
        got = im.int8_linear_gelu_plain(xq.reshape(-1, 96), linear.weight_q, linear.weight_scale, linear.bias,
                                        torch.from_numpy(s), xs.reshape(-1), approximate=approximate)
        assert torch.equal(linear.gelu_codes(torch.from_numpy(x), torch.from_numpy(s), approximate).reshape(-1, 256),
                           got)
    assert_codes_close(got.numpy(), want.reshape(-1, 256), f"int8-gelu ({approximate}) codes vs the JAX chain")


# ---------------------------------------------------------------- dispatch and padding
def test_dispatchers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA binding was called for CPU tensors")

    for name in ("int8_matmul", "int8_linear", "int8_linear_gelu"):
        monkeypatch.setattr(im, name, boom)
    monkeypatch.setattr(pq, "quantize_per_token", boom)
    a, w = (torch.from_numpy(t) for t in int8_pair(6, 5, 32, seed=2))
    ws, bias, xs, os_ = torch.rand(5) * 1e-3, torch.randn(5), torch.rand(6) * 0.05, torch.rand(5) * 0.1 + 0.01
    assert torch.equal(im.int8_linear_mm(a, w, ws, bias, xs), im.int8_linear_plain(a, w, ws, bias, xs))
    assert torch.equal(im.int8_linear_gelu_mm(a, w, ws, bias, os_, xs, "none"),
                       im.int8_linear_gelu_plain(a, w, ws, bias, os_, xs, "none"))
    x = torch.randn(6, 32)
    assert all(torch.equal(p, q) for p, q in zip(pq.quantize_tokens(x), pq.quantize_per_token_plain(x)))
    for call in (lambda: im.int8_linear_mm(a.to("meta"), w.to("meta"), ws, bias),
                 lambda: im.int8_linear_gelu_mm(a.to("meta"), w.to("meta"), ws, bias, os_),
                 lambda: pq.quantize_tokens(x.to("meta"))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_bindings_raise_on_cpu_tensors():
    a, w = (torch.from_numpy(t) for t in int8_pair(6, 5, 32, seed=3))
    ws, bias = torch.rand(5), torch.zeros(5)
    for call in (lambda: im.int8_linear(a, w, ws, bias), lambda: im.int8_linear_gelu(a, w, ws, bias, ws),
                 lambda: pq.quantize_per_token(torch.randn(4, 8))):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    with pytest.raises(ValueError, match="approximate"):
        im.int8_linear_gelu(a, w, ws, bias, ws, approximate="sigmoid")


@pytest.mark.parametrize("k,offset", [(45, 0), (64, 1), (3072, 0)], ids=["K-off-16", "misaligned", "aligned"])
def test_padding_copy_gives_the_plain_result(k, offset):
    a, w = (torch.from_numpy(t) for t in int8_pair(37, 29, k, seed=k + offset))
    if offset:  # a view one byte past a 16-byte boundary
        a = torch.empty(a.numel() + offset, dtype=torch.int8)[offset:].view(a.shape).copy_(a)
    k_pad = -(-k // 16) * 16
    pa, copied_a = im.tma_operand(a, k_pad)
    pw, copied_w = im.tma_operand(w, k_pad)
    assert copied_a == (k % 16 != 0 or a.data_ptr() % 16 != 0) and copied_w == (k % 16 != 0)
    assert pa.shape == (37, k_pad) and pa.data_ptr() % 16 == 0 and bool((pa[:, k:] == 0).all())
    assert (pa is a) != copied_a
    assert torch.equal(im.int8_matmul_plain(pa, pw), im.int8_matmul_plain(a, w))
    ws, bias, os_ = torch.rand(29) * 1e-3, torch.randn(29) * 0.1, torch.rand(29) * 0.05 + 0.01
    assert torch.equal(im.int8_linear_plain(pa, pw, ws, bias), im.int8_linear_plain(a, w, ws, bias))
    assert torch.equal(im.int8_linear_gelu_plain(pa, pw, ws, bias, os_), im.int8_linear_gelu_plain(a, w, ws, bias, os_))


# ---------------------------------------------------------------- the fused wiring
class Recorder:
    """The kernels' bindings replaced by their plain versions, counting calls
    and keeping the GELU codes; with ``build.on_card`` patched to True, CPU
    tensors take the route that CUDA tensors take."""

    def __init__(self, monkeypatch):
        self.calls = {"quantize_per_token": 0, "int32": 0, "f32": 0, "int8_gelu": 0}
        self.codes = []
        monkeypatch.setattr(build, "on_card", lambda t, what: True)
        monkeypatch.setattr(pq, "quantize_per_token", self._count("quantize_per_token", pq.quantize_per_token_plain))
        monkeypatch.setattr(im, "int8_matmul", self._count("int32", im.int8_matmul_plain))
        monkeypatch.setattr(im, "int8_linear", self._count("f32", im.int8_linear_plain))
        monkeypatch.setattr(im, "int8_linear_gelu", self._count("int8_gelu", im.int8_linear_gelu_plain))

    def _count(self, key, plain):
        def call(*args, **kwargs):
            self.calls[key] += 1
            out = plain(*args, **kwargs)
            if key == "int8_gelu":
                self.codes.append(out)
            return out

        return call


def tiny_int8_model(seed):
    model = _BertScorer(dataclasses.replace(TINY_TORCH, quantize="int8")).eval()
    batch = bert_batch(3, 2, 64, qlen=5, seed=seed, vocab=1024)
    args = [torch.from_numpy(batch[k]) for k in ("pos_bert_input", "pos_mask", "pos_seg")]
    with torch.no_grad():
        seed_weights(model, seed, std=0.2)
        model(*args, calibrate=True)
    ids, mask, seg = (a.reshape(-1, 64) for a in args)
    return model, ids, mask.bool(), seg


def unfused_layer(layer, hidden, mask):
    """A ``BertLayer``'s int8 forward as the port ran it before the fused
    epilogues: (output, the FFN's GELU codes)."""
    att, c = layer.attention, layer.config
    b, l, h = hidden.shape

    def split(x):
        return x.view(b, l, c.num_heads, c.head_dim).transpose(1, 2).contiguous()

    hq, hs = pq.quantize_per_token_plain(hidden)
    q, k, v = (split(unfused_linear(p, x_pre=hq, x_scales=hs)) for p in (att.query, att.key, att.value))
    out = multihead_attention(q, k, v, mask).transpose(1, 2).reshape(b, l, h)
    hidden = layer.attention_ln(hidden + unfused_linear(att.output, out))
    g = F.gelu(unfused_linear(layer.intermediate, hidden), approximate="tanh" if c.gelu_approximate else "none")
    gq = torch.round(g / layer.gelu_scales()).clamp_(-127, 127).to(torch.int8)
    return layer.output_ln(hidden + unfused_linear(layer.ffn_output, x_pre=gq)), gq


def test_fused_attention_through_the_bindings_is_the_unfused_path(monkeypatch):
    model, ids, mask, seg = tiny_int8_model(seed=31)
    att = model.bert.layer_0.attention
    with torch.no_grad():
        hidden = model.bert.embed(ids, seg)
        hq, hs = pq.quantize_per_token_plain(hidden)
        want = [unfused_linear(p, x_pre=hq, x_scales=hs) for p in (att.query, att.key, att.value)]
        recorder = Recorder(monkeypatch)
        q, k, v = att.heads(hidden)
        assert recorder.calls == {"quantize_per_token": 1, "int32": 0, "f32": 3, "int8_gelu": 0}
        for got, ref in zip((q, k, v), want):
            assert torch.equal(got.transpose(1, 2).reshape(ref.shape), ref)
        out = att(hidden, mask)
    assert recorder.calls == {"quantize_per_token": 3, "int32": 0, "f32": 7, "int8_gelu": 0}
    b, l, h = hidden.shape
    ref = unfused_linear(att.output, multihead_attention(q, k, v, mask).transpose(1, 2).reshape(b, l, h))
    assert torch.equal(out, ref)


def test_fused_layer_through_the_bindings_is_the_unfused_path(monkeypatch):
    """One Q1 and three f32 launches for q, k, v; Q1 and f32 for the output
    projection; Q1 and int8-gelu for the up-projection; f32 for the
    down-projection: 3 Q1 and 6 X1 launches per layer, none in int32 mode."""
    model, ids, mask, seg = tiny_int8_model(seed=32)
    with torch.no_grad():
        hidden = model.bert.embed(ids, seg)
        for i in range(TINY_TORCH.num_layers):
            layer = getattr(model.bert, f"layer_{i}")
            want, want_codes = unfused_layer(layer, hidden, mask)
            recorder = Recorder(monkeypatch)
            got = layer(hidden, mask)
            monkeypatch.undo()
            assert recorder.calls == {"quantize_per_token": 3, "int32": 0, "f32": 5, "int8_gelu": 1}
            flips = (recorder.codes[0].reshape(want_codes.shape).int() - want_codes.int()).abs()
            print(f"layer {i}: {int((flips > 0).sum())} of {flips.numel()} GELU codes differ from the unfused path")
            assert int(flips.max()) <= 1
            assert torch.equal(got, want)
            hidden = got


def test_calibrating_layer_keeps_the_f32_gelu(monkeypatch):
    """A calibrating pass needs the f32 GELU output for its amax: its
    up-projection runs in f32 mode, and it updates ``gelu_amax`` as before."""
    model, ids, mask, seg = tiny_int8_model(seed=33)
    layer = model.bert.layer_0
    with torch.no_grad():
        hidden = model.bert.embed(ids, seg)
        before = layer.gelu_amax.clone()
        layer.gelu_amax = torch.zeros_like(before)
        recorder = Recorder(monkeypatch)
        layer(hidden, mask, calibrate=True)
    assert recorder.calls == {"quantize_per_token": 3, "int32": 0, "f32": 6, "int8_gelu": 0}
    assert torch.equal(layer.gelu_amax, before)  # the same batch calibrated it in tiny_int8_model


def test_fused_encoder_through_the_bindings_matches_jax_with_its_stats(monkeypatch):
    batch = bert_batch(3, 4, 64, qlen=5, seed=11, vocab=5000)
    args = [batch[k] for k in ("pos_bert_input", "pos_mask", "pos_seg")]
    jax_model, variables = jax_int8_variables(TINY, args, seed=3)
    want = np.asarray(jax_model.apply(variables, *args))
    model = _BertScorer(dataclasses.replace(TINY_TORCH, quantize="int8"))
    model.load_state_dict(bert_state_dict(flatten_params(variables)))
    with torch.inference_mode():
        unfused = model.eval()(*(torch.from_numpy(a) for a in args))
        recorder = Recorder(monkeypatch)
        got = model(*(torch.from_numpy(a) for a in args))
    layers = TINY_TORCH.num_layers
    assert recorder.calls == {"quantize_per_token": 3 * layers, "int32": 0, "f32": 5 * layers, "int8_gelu": layers}
    assert torch.equal(got, unfused)
    assert_within(got.numpy(), want, ENCODER_TOL, "tiny int8 encoder through the bindings vs JAX, JAX's stats")
