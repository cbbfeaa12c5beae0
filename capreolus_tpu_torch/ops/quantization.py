"""Symmetric int8 / int4 quantization of embeddings (the JAX package's
``ops/quantization.py``).

- ``quantize_rows`` and ``quantize_rows_int4`` are the port's own copies of the
  JAX module's numpy functions, line for line, so that a corpus quantizes to the
  same codes and scales bit for bit: one f32 scale per row (per document for
  the [N, Ld, dim] ColBERT tensor), ``amax / 127`` (``amax / 7`` for int4),
  round half to even, clip; int4 codes are packed as two's-complement nibbles,
  the low nibble holding the even dims.
- ``quantize_rows_torch`` is the counterpart of ``quantize_rows_jnp``: the
  per-row quantization of a query batch on its own device, one scale per
  query, reduced over every axis but the first.
- ``unpack_int4`` is the counterpart of ``unpack_int4_jnp``.
- ``int8_mips_scores`` and ``int4_mips_scores``: [Q, D] float queries against
  an int8 or packed-int4 corpus with per-row scales -> [Q, N] f32, the dense
  searcher's quantized scores. Queries quantize per row
  (``quantize_rows_torch``); the int8 x int8 -> int32 product is X1's int32
  epilogue on CUDA tensors and its plain version on CPU tensors
  (``ops/int8_matmul.int8_mm``), over corpus chunks of at most ``MAX_N``
  rows; the f32 epilogue keeps the JAX functions' order of operations, which
  differs between int4's two paths (``score_chunk``).
- Q1, the per-token int8 quantization of the int8 BERT layer (the JAX
  encoder's ``_quantize_per_token``): the binding ``quantize_per_token`` of the
  hand-written kernel ``csrc/quantize_per_token.cu`` (launches counted in
  ``quantize_per_token.launches``), its plain version
  ``quantize_per_token_plain``, and the dispatcher ``quantize_tokens`` (CUDA
  tensors to the kernel, CPU tensors to the plain version).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from capreolus_tpu_torch.ops import build


def quantize_rows(emb: np.ndarray, slab_rows: int = 65536):
    """[N, D] (or [N, T, D]) float -> (int8 same-shape, f32 [N] per-row scales).

    Symmetric: scale = amax(|row|)/127, q = round(x/scale). All-zero rows get
    scale 1 (their quantized row is all zeros anyway). ``slab_rows`` rows at a
    time, so that host memory holds one f32 slab beside the int8 output."""
    emb = np.asarray(emb)
    n = emb.shape[0]
    out = np.empty(emb.shape, np.int8)
    scale = np.empty((n,), np.float32)
    for s0 in range(0, max(n, 1), slab_rows):
        slab = np.asarray(emb[s0 : s0 + slab_rows], dtype=np.float32)
        reduce_axes = tuple(range(1, slab.ndim))
        amax = np.max(np.abs(slab), axis=reduce_axes) if slab.size else np.zeros((0,))
        sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.round(slab / sc.reshape((-1,) + (1,) * (slab.ndim - 1)))
        out[s0 : s0 + slab_rows] = np.clip(q, -127, 127).astype(np.int8)
        scale[s0 : s0 + slab_rows] = sc
    return out, scale


def quantize_rows_int4(emb: np.ndarray, slab_rows: int = 65536):
    """[N, D] float -> (uint8 [N, ceil(D/2)] packed nibble pairs, f32 [N] scales).

    Symmetric to [-7, 7]: scale = amax(|row|)/7. Two's-complement nibbles, low
    nibble = even dims, high nibble = odd dims; an odd D is zero-padded (a zero
    dim adds nothing to a dot product)."""
    emb = np.asarray(emb)
    n, d = emb.shape[0], emb.shape[-1]
    d_pad = d + (d % 2)
    out = np.empty((n, d_pad // 2), np.uint8)
    scale = np.empty((n,), np.float32)
    for s0 in range(0, max(n, 1), slab_rows):
        slab = np.asarray(emb[s0 : s0 + slab_rows], dtype=np.float32)
        amax = np.max(np.abs(slab), axis=1) if slab.size else np.zeros((0,))
        sc = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
        q = np.clip(np.round(slab / sc[:, None]), -7, 7).astype(np.int8)
        if d % 2:
            q = np.concatenate([q, np.zeros((len(q), 1), np.int8)], axis=1)
        lo = (q[:, 0::2].astype(np.uint8)) & 0xF
        hi = (q[:, 1::2].astype(np.uint8)) & 0xF
        out[s0 : s0 + slab_rows] = lo | (hi << 4)
        scale[s0 : s0 + slab_rows] = sc
    return out, scale


def int8_scale(amax):
    """``amax / 127`` as a true division on every device. Torch on CUDA
    multiplies by the reciprocal when it divides by a Python number, and that
    can round one ulp away from the CPU's and JAX's division; dividing by a
    tensor of 127s does not."""
    return amax / torch.full_like(amax, 127.0)


def quantize_rows_torch(emb):
    """Per-row symmetric int8 quantization on ``emb``'s device: [N, ...] float
    -> (int8 same shape, f32 [N] scales), the rule of ``quantize_rows`` with
    one scale per row over all its other axes (per query, over [Lq, dim])."""
    reduce_axes = tuple(range(1, emb.dim()))
    amax = emb.float().abs().amax(dim=reduce_axes)
    scale = torch.where(amax > 0, int8_scale(amax), 1.0)
    q = torch.round(emb / scale.reshape((-1,) + (1,) * (emb.dim() - 1)))
    return q.clamp(-127, 127).to(torch.int8), scale


def unpack_int4(packed):
    """uint8 [..., P] packed nibbles -> int8 [..., 2P] (the low nibble first)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def _int8_product(q_i8, docs_i8):
    """q [Q, D] int8 @ docs [N, D].T -> [Q, N] int32 through ``int8_mm``, in
    chunks of at most X1's ``MAX_N`` corpus rows."""
    from capreolus_tpu_torch.ops.int8_matmul import MAX_N, int8_mm

    n = docs_i8.shape[0]
    if n <= MAX_N:
        return int8_mm(q_i8, docs_i8.contiguous())
    out = torch.empty((q_i8.shape[0], n), dtype=torch.int32, device=q_i8.device)
    for c0 in range(0, n, MAX_N):
        out[:, c0 : c0 + MAX_N] = int8_mm(q_i8, docs_i8[c0 : c0 + MAX_N].contiguous())
    return out


def int8_mips_scores(q_emb, docs_i8, dscale):
    """[Q, D] float queries x ([N, D] int8, [N] f32) docs -> [Q, N] f32 scores:
    the int32 product (X1 on the card), then ``isc * qscale[:, None] *
    dscale[None, :]`` in that order, as the JAX function computes it."""
    q_i8, qscale = quantize_rows_torch(q_emb)
    iscores = _int8_product(q_i8, docs_i8)
    return iscores.float() * qscale[:, None] * dscale[None, :]


def _padded_queries(q_i8, d_up):
    """Queries zero-padded to the unpacked width (odd-D corpora pack a zero dim)."""
    if q_i8.shape[-1] < d_up:
        q_i8 = torch.nn.functional.pad(q_i8, (0, d_up - q_i8.shape[-1]))
    return q_i8.contiguous()


def score_chunk(q_i8, docs_p4, dscale, start, rows):
    """One chunk of the chunked int4 path: rows [start, start+rows) of the
    packed corpus unpacked to int8, the int32 product, times the docs'
    scales: ``isc * s[None, :]`` (the query scale multiplies the whole matrix
    afterwards, as in the JAX ``fori_loop``)."""
    isc = _int8_product(q_i8, unpack_int4(docs_p4[start : start + rows]))
    return isc.float() * dscale[None, start : start + rows]


def int4_mips_scores(q_emb, docs_p4, dscale, row_chunk: int = 131072):
    """[Q, D] float queries x ([N, P] packed int4, [N] f32) docs -> [Q, N] f32.

    Queries quantize to int8; documents unpack to int8, in chunks of
    ``row_chunk`` rows above ``row_chunk`` so that the int8 corpus never
    exists whole. Up to ``row_chunk`` rows the epilogue is ``isc *
    qscale[:, None] * dscale[None, :]``; above, ``(isc * s[None, :]) *
    qscale[:, None]``, as the JAX function's two paths round. (Its last chunk
    starts at ``n - row_chunk`` and rewrites overlapping columns with equal
    values; chunks here do not overlap, which gives the same matrix.)"""
    q_i8, qscale = quantize_rows_torch(q_emb)
    q_i8 = _padded_queries(q_i8, docs_p4.shape[-1] * 2)
    n = docs_p4.shape[0]
    if n <= row_chunk:
        iscores = _int8_product(q_i8, unpack_int4(docs_p4))
        return iscores.float() * qscale[:, None] * dscale[None, :]
    out = torch.empty((q_i8.shape[0], n), dtype=torch.float32, device=q_emb.device)
    for start in range(0, n, row_chunk):
        rows = min(row_chunk, n - start)
        out[:, start : start + rows] = score_chunk(q_i8, docs_p4, dscale, start, rows)
    return out * qscale[:, None]


def quantize_per_token_plain(x):
    """Dynamic per-token int8 quantization (the JAX ``_quantize_per_token``):
    [..., K] float -> (int8 codes [..., K], f32 scales [..., 1]) with scale
    ``max(amax(|x|), 1e-6) / 127`` over the last axis and codes ``round(x /
    scale)`` (half to even) clipped to [-127, 127], the scale a true division
    (``int8_scale``)."""
    xf = x.float()
    xs = int8_scale(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6))
    xq = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return xq, xs


def _q1_lib():
    lib = build.load("quantize_per_token")
    lib.quantize_per_token_launch.restype = ctypes.c_int
    lib.quantize_per_token_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def quantize_per_token(x):
    """Q1 on a CUDA tensor: x [..., K] f32, contiguous -> (int8 codes [..., K],
    f32 scales [..., 1]), equal to ``quantize_per_token_plain`` on the same
    device. Raises ValueError on anything else, CPU tensors included."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_per_token: x is on {x.device}; the kernel takes CUDA tensors only")
    if x.dtype != torch.float32:
        raise ValueError(f"quantize_per_token: x has dtype {x.dtype}, expected torch.float32")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"quantize_per_token: x must be contiguous with at least one axis, got {tuple(x.shape)}")
    k = x.shape[-1]
    m = x.numel() // k if k else 0
    if m >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"quantize_per_token: {m} rows of {k} outside the kernel's int32 limits")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scales
    lib = _q1_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_per_token_launch(x.data_ptr(), q.data_ptr(), scales.data_ptr(), m, k, stream)
    if err != 0:
        raise RuntimeError(f"quantize_per_token kernel launch failed: cudaError {err}")
    quantize_per_token.launches += 1
    return q, scales


quantize_per_token.launches = 0


def quantize_tokens(x):
    """Per-token int8 codes and scales of x [..., K]: Q1 for CUDA tensors,
    ``quantize_per_token_plain`` for CPU tensors."""
    return quantize_per_token(x) if build.on_card(x, "quantize_tokens") else quantize_per_token_plain(x)
