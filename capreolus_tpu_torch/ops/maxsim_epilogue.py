"""The int8 ColBERT engine's MaxSim epilogue: X1's int32 similarities of one
chunk of docs to the chunk's scores.

``searcher/late_interaction.py::quantized_maxsim_codes`` scores each chunk of
an int8 or int4 corpus by one X1 product sim [Q*Lq, C*Ld] int32 (row q*Lq + t,
column d*Ld + j: query q's token t against doc d's token j). The epilogue
rounds each similarity to bf16, as the JAX scorer's bf16 dot rounds it, takes
the max over the doc's valid tokens (a masked token at bf16(-1e9)), sums the
maxima over query tokens in ``ops.maxsim.sum_query_tokens``' pairwise tree in
f32, and multiplies by the query's and then the doc's scale; a doc with no
valid token scores -inf. The scores land in columns [col0, col0 + C) of
out [Q, N] f32.

- ``maxsim_epilogue`` is the binding of the hand-written kernel
  ``csrc/maxsim_epilogue.cu``, which reads each valid token's similarity once
  and skips the masked ones, with the plain version's bits; its launches count
  in ``maxsim_epilogue.launches``. No Pallas kernel corresponds: the JAX
  package leaves this epilogue to XLA, fused into its bf16 dot.
- ``maxsim_epilogue_plain`` is the plain torch version, the arithmetic the
  engine ran before the kernel.
- ``chunk_scores`` is what the engine calls: CUDA tensors go to the kernel,
  CPU tensors to the plain version, and any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from capreolus_tpu_torch.ops import build
from capreolus_tpu_torch.ops.maxsim import sum_query_tokens

MASKED_BIAS = -1e9  # a masked doc token's similarity in the max (and its additive bias in K3's bias_t)
MAX_LQ = 1024  # query tokens the kernel takes: its [Lq, 32] f32 row maxima fit in an SM's shared memory


def maxsim_epilogue_plain(sim, mask, qscale, dscale, out, col0):
    """Plain torch version: sim [Q*Lq, C*Ld] int32, mask [C, Ld] bool, qscale
    [Q] and dscale [C] f32 -> the chunk's scores written to out[:, col0 :
    col0 + C]. Returns ``out``."""
    nq, (c, ld) = qscale.shape[0], mask.shape
    lq = sim.shape[0] // nq
    sim = sim.to(torch.bfloat16).view(nq, lq, c, ld)
    sim.masked_fill_(~mask[None, None], MASKED_BIAS)
    per_q_token = sim.amax(dim=-1).float()  # [Q, Lq, C]
    scores = sum_query_tokens(per_q_token) * qscale[:, None] * dscale[None, :]
    out[:, col0 : col0 + c] = torch.where(mask.any(dim=1)[None, :], scores, float("-inf"))
    return out


def _lib():
    lib = build.load("maxsim_epilogue")
    lib.maxsim_epilogue_launch.restype = ctypes.c_int
    lib.maxsim_epilogue_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
    return lib


def maxsim_epilogue(sim, mask, qscale, dscale, out, col0):
    """The kernel on CUDA tensors, with ``maxsim_epilogue_plain``'s arguments
    and bits: sim int32 and mask bool contiguous, qscale and dscale contiguous
    f32, out f32 with unit column stride, all on one device, Lq at most
    ``MAX_LQ``. Raises ValueError on anything else, CPU tensors included
    (``chunk_scores`` routes those to the plain version), where every check
    but the device's comes first. Returns ``out``."""
    what = "maxsim_epilogue"
    device = sim.device
    for name, t, dtype, dim in (("sim", sim, torch.int32, 2), ("mask", mask, torch.bool, 2),
                                ("qscale", qscale, torch.float32, 1), ("dscale", dscale, torch.float32, 1),
                                ("out", out, torch.float32, 2)):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, sim on {device}")
        if t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"{what}: {name} must be {dim}-D {dtype}, got {t.dtype} {tuple(t.shape)}")
        if name != "out" and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    nq, (c, ld) = qscale.shape[0], mask.shape
    if nq == 0 or sim.shape[0] % nq or sim.shape[1] != c * ld:
        raise ValueError(f"{what}: sim {tuple(sim.shape)} is not [Q*Lq, C*Ld] for {nq} query scales and a "
                         f"[{c}, {ld}] mask")
    lq = sim.shape[0] // nq
    if dscale.shape[0] != c:
        raise ValueError(f"{what}: dscale has {dscale.shape[0]} entries, expected {c}")
    if out.shape[0] != nq or out.stride(1) != 1 or not 0 <= col0 <= out.shape[1] - c:
        raise ValueError(f"{what}: out {tuple(out.shape)} (strides {out.stride()}) cannot take [{nq}, {c}] "
                         f"scores at column {col0} in unit-stride rows")
    if not 1 <= lq <= MAX_LQ or c < 1 or ld < 1 or nq * -(-c // 32) >= 2 ** 31:
        raise ValueError(f"{what}: {nq} queries of {lq} tokens over {c} docs of {ld} outside the kernel's limits "
                         f"(1 <= Lq <= {MAX_LQ}, at least one doc and token)")
    if device.type != "cuda":
        raise ValueError(f"{what}: sim is on {device}; the kernel takes CUDA tensors only")
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.maxsim_epilogue_launch(sim.data_ptr(), mask.data_ptr(), qscale.data_ptr(), dscale.data_ptr(),
                                         out.data_ptr() + 4 * col0, out.stride(0), nq, lq, c, ld, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    maxsim_epilogue.launches += 1
    return out


maxsim_epilogue.launches = 0


def chunk_scores(sim, mask, qscale, dscale, out, col0):
    """One chunk's scores into out[:, col0 : col0 + C]: the kernel for CUDA
    tensors, ``maxsim_epilogue_plain`` for CPU tensors. Returns ``out``."""
    if build.on_card(sim, "chunk_scores"):
        return maxsim_epilogue(sim, mask, qscale, dscale, out, col0)
    return maxsim_epilogue_plain(sim, mask, qscale, dscale, out, col0)
