"""X1/X2: the int8 x int8 -> int32 matrix product of the int8 inference path.

The counterpart of the Pallas ``matmul_kernel`` of
``scripts/exp_pallas_int8.py`` (X1) and ``scripts/exp_pallas_int8b.py`` (X2),
which compute ``a @ b`` for a [M, K] and b [K, N] int8 into int32. Here the
right operand comes as w [N, K], K-contiguous like an ``nn.Linear`` weight, so
``int8_matmul(a, w) == a @ w.T``, exact in int32 for the full int8 range.

- ``int8_matmul`` is the binding of the hand-written Hopper kernel
  ``csrc/int8_matmul.cu`` (int8 tensor cores through ``mma.sync``) and counts
  its launches in ``int8_matmul.launches``;
- ``int8_matmul_plain`` is the plain torch version of the same function, which
  the kernel is held against on the card;
- ``int8_mm`` is what the int8 paths call: CUDA tensors go to the kernel, CPU
  tensors to the plain version, and any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from capreolus_tpu_torch.ops import build

MAX_K = (1 << 17) - 1  # |sum| <= K * 2**14 stays below 2**31
MAX_N = 65535 * 128  # the launch's grid.y holds the 128-column tiles of the output


def int8_matmul_plain(a, w):
    """Plain torch version: a [M, K] int8 @ w [N, K].T -> [M, N] int32.

    The product runs in f64 and is cast to int32, on the CPU and on the card
    alike: every product of two int8 values and every partial sum is an
    integer of magnitude at most K * 2**14 < 2**53, so the f64 result is exact
    in any summation order. (torch's int32 matmul on the CPU has no BLAS
    behind it; CUDA has none.)"""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64).T).to(torch.int32)


def _lib():
    lib = build.load("int8_matmul")
    lib.int8_matmul_launch.restype = ctypes.c_int
    lib.int8_matmul_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def int8_matmul(a, w):
    """X1 on CUDA tensors: a [M, K] int8 and w [N, K] int8, both contiguous on
    one device, 1 <= K <= 2**17 - 1 -> [M, N] int32. Raises ValueError on
    anything else, CPU tensors included (``int8_mm`` routes those to the plain
    version)."""
    device = a.device
    if device.type != "cuda":
        raise ValueError(f"int8_matmul: a is on {device}; the kernel takes CUDA tensors only")
    if w.device != device:
        raise ValueError(f"int8_matmul: w is on {w.device}, a on {device}")
    for name, t in (("a", a), ("w", w)):
        if t.dtype != torch.int8:
            raise ValueError(f"int8_matmul: {name} has dtype {t.dtype}, expected torch.int8")
        if t.dim() != 2:
            raise ValueError(f"int8_matmul: {name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous (K-contiguous rows)")
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"int8_matmul: a is [M={m}, K={k}] but w is {tuple(w.shape)}, expected [N, {k}]")
    if not 1 <= k <= MAX_K or m >= 2 ** 31 or n > MAX_N:
        raise ValueError(f"int8_matmul: shape M={m} N={n} K={k} outside the kernel's limits "
                         f"(1 <= K <= {MAX_K}, M < 2**31, N <= {MAX_N})")
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.int32, device=device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.int8_matmul_launch(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_mm(a, w):
    """a [M, K] int8 @ w [N, K].T -> [M, N] int32: X1 for CUDA tensors,
    ``int8_matmul_plain`` for CPU tensors."""
    if a.device.type == "cuda":
        return int8_matmul(a, w)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w)
    raise ValueError(f"int8_mm: unsupported device {a.device}")
