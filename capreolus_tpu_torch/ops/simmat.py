"""K1: fused similarity matrix + RBF kernel pooling (KNRM soft-TF).

The port of the JAX package's ``ops/simmat.py``. ``knrm_pool`` is the function
of ``_knrm_pool_pallas`` at that boundary: normalised q/d embeddings, token ids,
mus and sigmas in, pooled [B, K] features out; it differs from the Pallas
kernel only on pad doc positions, which it counts as the model's path does. For CUDA tensors it launches the
hand-written Hopper kernel ``csrc/knrm_pool.cu`` (or raises); for CPU tensors it
runs ``knrm_pool_plain``, a torch transcription of the kernel's math, which is
also what the kernel is held against on the card. ``knrm_pool.launches``
counts the kernel launches. The kernel has no backward, so it refuses inputs
that require grad (the JAX model takes its Pallas kernel only on
``stop_gradient`` inputs, with kernels and embeddings frozen). ``knrm_plan`` decides how many blocks share a
batch element's doc rows.
"""

from __future__ import annotations

import ctypes

import torch

from capreolus_tpu_torch.ops import build

_LIMITS = {}
KNRM_WARPS = 8  # warps per block of K1
KNRM_CHUNK = 8  # doc rows per warp task of K1
KNRM_MAX_SPLITS = 64  # blocks per batch element


def knrm_plan(d):
    """Blocks per batch element of K1 (its ``splits``) for D doc rows: enough
    that each of their warps takes at most one chunk of ``KNRM_CHUNK`` rows, up
    to 64. The batch element's warps take the chunks in turn: chunk ``ch`` goes
    to warp ``ch % KNRM_WARPS`` of block ``ch // KNRM_WARPS % splits``.

    Tuned at the served rerank depth (B = 100 candidates, 13 splits at D =
    800); it does not look at B, and a larger batch, which fills the card with
    fewer splits, is untuned."""
    chunks = -(-d // KNRM_CHUNK)
    return max(1, min(KNRM_MAX_SPLITS, -(-chunks // KNRM_WARPS)))


def knrm_pool_plain(q_emb, d_emb, qtok, dtok, mus, sigmas):
    """Plain torch version of K1: [B, Q, E], [B, D, E], [B, Q], [B, D], [K], [K] -> [B, K].

    Pad doc positions count in the kernel sums at sim 0, as in the model's
    ``reranker.common.knrm_pool`` (the Pallas kernel masks them; see
    ``csrc/knrm_pool.cu``). On CUDA, matmul must run in true f32
    (``torch.backends.cuda.matmul.allow_tf32`` False, torch's default): the
    sigma=0.001 kernel amplifies TF32's rounding."""
    sim = torch.matmul(q_emb, d_emb.transpose(1, 2))  # [B, Q, D]
    qt, dt = qtok[:, :, None], dtok[:, None, :]
    exact = (qt == dt) & (qt < 0) & (dt < 0)
    valid = (qt != 0) & (dt != 0)
    sim = torch.where(valid, sim + exact.to(sim.dtype), 0.0)
    row_mask = sim.sum(dim=2) != 0.0  # [B, Q] query positions with any signal
    adj = sim[:, None] - mus[None, :, None, None]  # [B, K, Q, D]
    sig = sigmas[None, :, None, None]
    kern = torch.exp(-0.5 * adj * adj / (sig * sig))
    ksum = kern.sum(dim=3)  # [B, K, Q]
    return torch.where(row_mask[:, None], torch.log(ksum + 1e-6), 0.0).sum(dim=2)


def _lib():
    lib = build.load("knrm_pool")
    if not _LIMITS:
        lib.knrm_pool_launch.restype = ctypes.c_int
        lib.knrm_pool_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.knrm_pool_work_floats.restype = ctypes.c_longlong
        lib.knrm_pool_work_floats.argtypes = [ctypes.c_int] * 4
        for fn in ("knrm_pool_max_q", "knrm_pool_max_e", "knrm_pool_max_pairs", "knrm_pool_warps", "knrm_pool_chunk"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        _LIMITS.update(q=lib.knrm_pool_max_q(), e=lib.knrm_pool_max_e(), pairs=lib.knrm_pool_max_pairs())
        if (lib.knrm_pool_warps(), lib.knrm_pool_chunk()) != (KNRM_WARPS, KNRM_CHUNK):
            raise RuntimeError("knrm_pool: the kernel's warps and chunk differ from knrm_plan's")
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"knrm_pool: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"knrm_pool: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"knrm_pool: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"knrm_pool: {name} must be contiguous")


def knrm_pool(q_emb, d_emb, qtok, dtok, mus, sigmas):
    """K1 at the ``_knrm_pool_pallas`` boundary; see the module docstring."""
    device = q_emb.device
    others = sorted({str(t.device) for t in (d_emb, qtok, dtok, mus, sigmas)} - {str(device)})
    if others:
        raise ValueError(f"knrm_pool: q_emb is on {device} but other inputs are on {others}")
    if device.type == "cpu":
        return knrm_pool_plain(q_emb, d_emb, qtok, dtok, mus, sigmas)
    if device.type != "cuda":
        raise ValueError(f"knrm_pool: unsupported device {device}")
    grads = [name for name, t in (("q_emb", q_emb), ("d_emb", d_emb), ("mus", mus), ("sigmas", sigmas))
             if t.requires_grad]
    if grads:
        raise ValueError(f"knrm_pool: {', '.join(grads)} require grad, and the kernel has no backward; "
                         f"a KNRM with trainable kernels or embeddings takes knrm_pool_plain's path")
    b, q, e = q_emb.shape
    d, k = d_emb.shape[1], mus.shape[0]
    _check("q_emb", q_emb, torch.float32, (b, q, e), device)
    _check("d_emb", d_emb, torch.float32, (b, d, e), device)
    _check("qtok", qtok, torch.int32, (b, q), device)
    _check("dtok", dtok, torch.int32, (b, d), device)
    _check("mus", mus, torch.float32, (k,), device)
    _check("sigmas", sigmas, torch.float32, (k,), device)
    lib = _lib()
    if q > _LIMITS["q"] or e > _LIMITS["e"] or q * k > _LIMITS["pairs"] or d < 1 or k < 1:
        raise ValueError(f"knrm_pool: shape Q={q}, D={d}, E={e}, K={k} outside the kernel's limits "
                         f"(Q <= {_LIMITS['q']}, E <= {_LIMITS['e']}, Q*K <= {_LIMITS['pairs']}, D >= 1)")
    out = torch.empty((b, k), dtype=torch.float32, device=device)
    if b == 0:
        return out
    splits = knrm_plan(d)
    # the blocks' sums, then their tickets, which the launch zeroes on this stream
    work = torch.empty(lib.knrm_pool_work_floats(b, q, k, splits), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.knrm_pool_launch(q_emb.data_ptr(), d_emb.data_ptr(), qtok.data_ptr(), dtok.data_ptr(),
                                   mus.data_ptr(), sigmas.data_ptr(), out.data_ptr(), work.data_ptr(),
                                   b, q, d, e, k, splits, stream)
    if err != 0:
        raise RuntimeError(f"knrm_pool kernel launch failed: cudaError {err}")
    knrm_pool.launches += 1
    return out


knrm_pool.launches = 0


def knrm_inputs(embedding, querytoks, doctoks, mus, sigmas):
    """The arguments of ``knrm_pool`` for token ids, as the JAX ``knrm_simmat_pool``
    builds them: rows gathered and normalised with ``norm + 1e-9`` in the
    table's dtype, pad (0) and OOV (negative) rows zeroed so the dot products
    see nothing for them (the OOV exact-match channel comes from the token
    ids), then widened to f32; int32 ids, f32 kernels. A bf16 table (a frozen
    KNRM under ``trainer.amp``) gives the bf16 rows JAX's Pallas path feeds its
    kernel, widened exactly."""

    def norm_embed(toks):
        emb = embedding[torch.clamp_min(toks, 0)]
        emb = emb / (torch.sqrt(torch.sum(emb * emb, dim=-1, keepdim=True)) + 1e-9)
        return torch.where((toks > 0)[..., None], emb, 0.0).float().contiguous()

    def f32(values):
        return torch.as_tensor(values, dtype=torch.float32, device=embedding.device).contiguous()

    return (norm_embed(querytoks), norm_embed(doctoks), querytoks.to(torch.int32).contiguous(),
            doctoks.to(torch.int32).contiguous(), f32(mus), f32(sigmas))


def knrm_simmat_pool(embedding, querytoks, doctoks, mus, sigmas):
    """KNRM pooled features [B, K] from token ids through K1."""
    return knrm_pool(*knrm_inputs(embedding, querytoks, doctoks, mus, sigmas))
