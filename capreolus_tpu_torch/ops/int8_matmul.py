"""X1/X2: the int8 x int8 -> int32 matrix product of the int8 inference path,
with the dequantization, GELU and requantization of monoBERT's int8 layer in
its epilogue.

The counterpart of the Pallas ``matmul_kernel`` of
``scripts/exp_pallas_int8.py`` (X1) and ``scripts/exp_pallas_int8b.py`` (X2),
which compute ``a @ b`` for a [M, K] and b [K, N] int8 into int32. Here the
right operand comes as w [N, K], K-contiguous like an ``nn.Linear`` weight, so
the product is ``a @ w.T``, exact in int32 for the full int8 range. The
hand-written Hopper kernel ``csrc/int8_matmul.cu`` (wgmma fed by TMA) has three
epilogues, each with a binding, a plain torch version and a dispatcher:

- int32: ``int8_matmul`` / ``int8_matmul_plain`` / ``int8_mm``, the product
  itself (ColBERT's quantized engine);
- f32: ``int8_linear`` / ``int8_linear_plain`` / ``int8_linear_mm``,
  ``((acc * x_scales[m]) * w_scales[n]) + bias[n]``, ``x_scales`` optional:
  ``Int8Linear``'s output;
- int8-gelu: ``int8_linear_gelu`` / ``int8_linear_gelu_plain`` /
  ``int8_linear_gelu_mm``, ``clamp(round(gelu(v) / out_scales[n]), -127,
  127)`` as int8 for f32 mode's v, tanh or erf GELU: the int8 FFN's
  up-projection, whose codes feed the down-projection directly.

The plain versions are the arithmetic the port ran before the epilogues were
fused: the f64 product, then torch's ops in the same order. A dispatcher sends
CUDA tensors to the binding and CPU tensors to the plain version. Every launch
counts in ``int8_matmul.launches`` and in its mode's entry of
``int8_matmul.mode_launches``; an operand that TMA cannot read as it is (K off
16, or a base off 16 bytes) is copied, zero-padded, and counted in
``int8_matmul.pad_copies``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from capreolus_tpu_torch.ops import build

MAX_K = (1 << 17) - 1  # |sum| <= K * 2**14 stays below 2**31
MAX_N = 65535 * 128  # the widest product the wrappers take; ColBERT's engine chunks by it
# output tile width (128 or 256) by epilogue, the faster at the served shapes on the H100 (PERF.md)
TILE_N = {"int32": 256, "f32": 128, "int8_gelu": 128}
GELU_MODES = {"tanh": 2, "none": 3}  # F.gelu's ``approximate`` -> the kernel's int8-gelu mode


def int8_matmul_plain(a, w):
    """Plain torch version: a [M, K] int8 @ w [N, K].T -> [M, N] int32.

    The product runs in f64 and is cast to int32, on the CPU and on the card
    alike: every product of two int8 values and every partial sum is an
    integer of magnitude at most K * 2**14 < 2**53, so the f64 result is exact
    in any summation order. (torch's int32 matmul on the CPU has no BLAS
    behind it; CUDA has none.)"""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64).T).to(torch.int32)


def int8_linear_plain(a, w, w_scales, bias, x_scales=None):
    """Plain version of the f32 epilogue: the product as f32, times
    ``x_scales`` [M] per row when given, times ``w_scales`` [N], plus ``bias``
    [N]; four separately rounded operations, in place."""
    out = int8_matmul_plain(a, w).float()
    if x_scales is not None:
        out.mul_(x_scales.reshape(-1, 1))
    return out.mul_(w_scales).add_(bias)


def requantize(g, out_scales):
    """int8 codes of g [..., N] at per-channel ``out_scales`` [N]: divided,
    rounded half to even and clamped to [-127, 127] (the int8 FFN's GELU
    requantization, the JAX ``_int8_ffn``'s rule)."""
    return torch.round(g / out_scales).clamp_(-127, 127).to(torch.int8)


def int8_linear_gelu_plain(a, w, w_scales, bias, out_scales, x_scales=None, approximate="tanh"):
    """Plain version of the int8-gelu epilogue: ``int8_linear_plain``'s value
    through ``F.gelu``, then ``requantize`` at ``out_scales`` [N]."""
    return requantize(F.gelu(int8_linear_plain(a, w, w_scales, bias, x_scales), approximate=approximate), out_scales)


def _lib():
    lib = build.load("int8_matmul")
    lib.int8_gemm_launch.restype = ctypes.c_int
    lib.int8_gemm_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                                     + [ctypes.c_int, ctypes.c_void_p])
    return lib


def tma_operand(t, k_pad):
    """``t`` [rows, K] itself when TMA can read it (K == k_pad, a 16-byte
    aligned base), else a zero-padded copy [rows, k_pad] on its device; zero
    bytes add nothing to the product. Returns (tensor, whether it copied)."""
    if t.shape[1] == k_pad and t.data_ptr() % 16 == 0:
        return t, False
    out = torch.zeros((t.shape[0], k_pad), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out, True


def _launch(what, mode, a, w, out_dtype, vectors, tile_n):
    """Checks the operands, launches the kernel in ``mode`` and counts it.
    ``vectors`` maps x_scales, w_scales, bias, out_scales to f32 vectors or None;
    ``tile_n`` None takes the epilogue's ``TILE_N``."""
    epilogue = "int32" if mode == 0 else "f32" if mode == 1 else "int8_gelu"
    tile_n = TILE_N[epilogue] if tile_n is None else tile_n
    device = a.device
    if device.type != "cuda":
        raise ValueError(f"{what}: a is on {device}; the kernel takes CUDA tensors only")
    if w.device != device:
        raise ValueError(f"{what}: w is on {w.device}, a on {device}")
    for name, t in (("a", a), ("w", w)):
        if t.dtype != torch.int8:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}, expected torch.int8")
        if t.dim() != 2:
            raise ValueError(f"{what}: {name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous (K-contiguous rows)")
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"{what}: a is [M={m}, K={k}] but w is {tuple(w.shape)}, expected [N, {k}]")
    if not 1 <= k <= MAX_K or m >= 2 ** 31 or n > MAX_N:
        raise ValueError(f"{what}: shape M={m} N={n} K={k} outside the kernel's limits "
                         f"(1 <= K <= {MAX_K}, M < 2**31, N <= {MAX_N})")
    if tile_n not in (128, 256):
        raise ValueError(f"{what}: tile_n must be 128 or 256, got {tile_n}")
    lengths = {"x_scales": m, "w_scales": n, "bias": n, "out_scales": n}
    for name, t in vectors.items():
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 1-D float32 tensor on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.shape[0] != lengths[name]:
            raise ValueError(f"{what}: {name} has {t.shape[0]} entries, expected {lengths[name]}")
    lib = _lib()
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    if m == 0 or n == 0:
        return out
    k_pad = -(-k // 16) * 16
    a, copied_a = tma_operand(a, k_pad)
    w, copied_w = tma_operand(w, k_pad)
    ptrs = [0 if vectors.get(name) is None else vectors[name].data_ptr()
            for name in ("x_scales", "w_scales", "bias", "out_scales")]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.int8_gemm_launch(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k_pad, mode, *ptrs, tile_n,
                                   stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    int8_matmul.pad_copies += copied_a + copied_w
    int8_matmul.launches += 1
    int8_matmul.mode_launches[epilogue] += 1
    return out


def int8_matmul(a, w, tile_n=None):
    """X1's int32 epilogue on CUDA tensors: a [M, K] int8 and w [N, K] int8,
    both contiguous on one device, 1 <= K <= 2**17 - 1 -> [M, N] int32. Raises
    ValueError on anything else, CPU tensors included (``int8_mm`` routes those
    to the plain version)."""
    return _launch("int8_matmul", 0, a, w, torch.int32, {}, tile_n)


int8_matmul.launches = 0  # every launch of the kernel, in any epilogue mode
int8_matmul.mode_launches = {"int32": 0, "f32": 0, "int8_gelu": 0}
int8_matmul.pad_copies = 0  # operands copied to a zero-padded, 16-byte aligned buffer


def int8_linear(a, w, w_scales, bias, x_scales=None, tile_n=None):
    """X1's f32 epilogue on CUDA tensors -> [M, N] f32, bit-identical to
    ``int8_linear_plain`` on the same device; the vectors are contiguous f32."""
    vectors = {"x_scales": x_scales, "w_scales": w_scales, "bias": bias}
    return _launch("int8_linear", 1, a, w, torch.float32, vectors, tile_n)


def int8_linear_gelu(a, w, w_scales, bias, out_scales, x_scales=None, approximate="tanh", tile_n=None):
    """X1's int8-gelu epilogue on CUDA tensors -> [M, N] int8 codes, those of
    ``int8_linear_gelu_plain`` but where the kernel's GELU and torch's round
    apart across a code boundary (one step). ``approximate`` is F.gelu's:
    "tanh" or "none" (erf)."""
    if approximate not in GELU_MODES:
        raise ValueError(f"int8_linear_gelu: approximate must be 'tanh' or 'none', got {approximate!r}")
    vectors = {"x_scales": x_scales, "w_scales": w_scales, "bias": bias, "out_scales": out_scales}
    return _launch("int8_linear_gelu", GELU_MODES[approximate], a, w, torch.int8, vectors, tile_n)


def int8_mm(a, w):
    """a [M, K] int8 @ w [N, K].T -> [M, N] int32: X1 for CUDA tensors,
    ``int8_matmul_plain`` for CPU tensors."""
    return int8_matmul(a, w) if build.on_card(a, "int8_mm") else int8_matmul_plain(a, w)


def int8_linear_mm(a, w, w_scales, bias, x_scales=None):
    """f32 [M, N] of ``Int8Linear``: X1's f32 epilogue for CUDA tensors,
    ``int8_linear_plain`` for CPU tensors."""
    if build.on_card(a, "int8_linear_mm"):
        return int8_linear(a, w, w_scales, bias, x_scales)
    return int8_linear_plain(a, w, w_scales, bias, x_scales)


def int8_linear_gelu_mm(a, w, w_scales, bias, out_scales, x_scales=None, approximate="tanh"):
    """int8 GELU codes [M, N]: X1's int8-gelu epilogue for CUDA tensors,
    ``int8_linear_gelu_plain`` for CPU tensors."""
    if build.on_card(a, "int8_linear_gelu_mm"):
        return int8_linear_gelu(a, w, w_scales, bias, out_scales, x_scales, approximate)
    return int8_linear_gelu_plain(a, w, w_scales, bias, out_scales, x_scales, approximate)
