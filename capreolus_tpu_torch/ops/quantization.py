"""Symmetric int8 / int4 quantization of embeddings (the JAX package's
``ops/quantization.py``, as far as the ColBERT searcher's quantized corpora
need it).

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
"""

from __future__ import annotations

import numpy as np
import torch


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


def quantize_rows_torch(emb):
    """Per-row symmetric int8 quantization on ``emb``'s device: [N, ...] float
    -> (int8 same shape, f32 [N] scales), the rule of ``quantize_rows`` with
    one scale per row over all its other axes (per query, over [Lq, dim])."""
    reduce_axes = tuple(range(1, emb.dim()))
    amax = emb.float().abs().amax(dim=reduce_axes)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.round(emb / scale.reshape((-1,) + (1,) * (emb.dim() - 1)))
    return q.clamp(-127, 127).to(torch.int8), scale


def unpack_int4(packed):
    """uint8 [..., P] packed nibbles -> int8 [..., 2P] (the low nibble first)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)
