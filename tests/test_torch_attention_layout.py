"""The encoder's attention layout on the CPU: the heads K2 reads are strided
views of the projections' outputs, never copies, and the plain version gives
the same bits on those views as on contiguous copies.

``BertSelfAttention.heads`` returns ``x.view(B, L, H, D).transpose(1, 2)`` of
each projection's [B, L, H * D] output, in f32 and with ``quantize=int8``
(where X1's f32 epilogue writes those rows); K2 reads the strides on the card
(``tests/test_torch_cuda.py``), and ``attention_plain`` runs on the CPU.
Tolerances: strided against contiguous, bit for bit; against JAX's
``_xla_attention`` on the same values, 1e-5 (one f32 softmax, sums in
another order), as ``tests/test_torch_bert.py`` holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capreolus_tpu_torch

capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.ops.flash_attention import _xla_attention  # noqa: E402
from capreolus_tpu_torch.ops import flash_attention as fa  # noqa: E402
from capreolus_tpu_torch.ops import quantization as pq  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import BertConfig, BertSelfAttention  # noqa: E402
from test_torch_bert import assert_within  # noqa: E402


def head_views(b, l, h, d, seed, dtype=torch.float32):
    """q, k, v as the encoder hands them to attention: [B, H, L, D] views of
    [B, L, H * D] rows, and a [B, L] key mask with ragged prefixes, a hole and
    a fully masked last element."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = [torch.from_numpy(rng.standard_normal((b, l, h * d)).astype(np.float32)).to(dtype) for _ in range(3)]
    mask = np.zeros((b, l), dtype=bool)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        mask[i, :n] = True
    mask[0, l // 3] = False
    mask[-1] = False
    return [x.view(b, l, h, d).transpose(1, 2) for x in rows], torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("l,h,d", [(1, 12, 64), (32, 12, 64), (77, 2, 32), (180, 12, 64), (256, 12, 64),
                                   (130, 2, 128)])
def test_attention_plain_on_head_views_is_bit_equal_to_contiguous(l, h, d, dtype):
    (q, k, v), mask = head_views(3, l, h, d, seed=l + h + d, dtype=dtype)
    assert q.stride() == (l * h * d, d, h * d, 1) and (l == 1 or not q.is_contiguous())
    got = fa.attention_plain(q, k, v, mask)
    want = fa.attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(fa.multihead_attention(q, k, v, mask), got)
    if dtype == torch.float32:
        ref = np.asarray(_xla_attention(*(jnp.asarray(x.contiguous().numpy()) for x in (q, k, v)),
                                        jnp.asarray(mask.numpy())))
        assert_within(got.numpy(), ref, 1e-5, f"attention_plain on head views vs _xla_attention L={l} H={h} D={d}")


def _attention(quantize, seed):
    config = BertConfig(vocab_size=1024, hidden_size=768, num_layers=1, num_heads=12, intermediate_size=3072,
                        quantize=quantize)
    att = BertSelfAttention(config).eval()
    rng = np.random.Generator(np.random.PCG64(seed))
    with torch.no_grad():
        for p in att.parameters():
            p.copy_(torch.from_numpy((rng.standard_normal(tuple(p.shape)) * 0.02).astype(np.float32)))
    hidden = torch.from_numpy(rng.standard_normal((2, 40, 768)).astype(np.float32))
    mask = torch.ones((2, 40), dtype=torch.bool)
    mask[1, 23:] = False
    return att, hidden, mask


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_heads_are_views_of_the_projections(quantize):
    att, hidden, mask = _attention(quantize, seed=3 if quantize == "none" else 4)
    outputs = {}
    hooks = [getattr(att, name).register_forward_hook(lambda mod, args, out, name=name: outputs.__setitem__(name, out))
             for name in ("query", "key", "value")]
    with torch.inference_mode():
        heads = att.heads(hidden)
    for hook in hooks:
        hook.remove()
    b, l, _ = hidden.shape
    for name, x in zip(("query", "key", "value"), heads):
        proj = outputs[name]
        assert proj.shape == (b, l, 768) and proj.is_contiguous()
        # the same memory: no head split copy
        assert x.data_ptr() == proj.data_ptr() and x.untyped_storage().data_ptr() == proj.untyped_storage().data_ptr()
        assert x.shape == (b, 12, l, 64) and x.stride() == (l * 768, 64, 768, 1)
        assert torch.equal(x, proj.view(b, l, 12, 64).transpose(1, 2))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_attention_forward_on_views_equals_the_contiguous_path(quantize):
    """The layer's output is bit for bit what it was when the heads were
    copied contiguous before attention and the merge copied them back."""
    att, hidden, mask = _attention(quantize, seed=5 if quantize == "none" else 6)
    b, l, h = hidden.shape
    with torch.inference_mode():
        got = att(hidden, mask)
        q, k, v = (x.contiguous() for x in att.heads(hidden))
        merged = fa.multihead_attention(q, k, v, mask).transpose(1, 2).contiguous().view(b, l, h)
        want = att.output(merged)
    assert torch.equal(got, want)


def test_int8_heads_come_from_one_quantization():
    """With int8, one per-token quantization of the hidden states feeds the
    three projections, and the heads are views of their f32 outputs."""
    att, hidden, _ = _attention("int8", seed=7)
    with torch.inference_mode():
        hq, hs = pq.quantize_per_token_plain(hidden)
        for proj, x in zip((att.query, att.key, att.value), att.heads(hidden)):
            want = proj(None, x_pre=hq, x_scales=hs)
            assert torch.equal(x.transpose(1, 2).reshape(want.shape), want)
