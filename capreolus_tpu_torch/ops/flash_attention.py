"""K2: masked multi-head attention with an online softmax.

The port of the JAX package's ``ops/flash_attention.py``. ``flash_attention``
computes the function of the Pallas ``_flash_kernel``: q scaled by
``1/sqrt(D)`` in f32, keys with a zero mask entry filled with -1e30, an online
softmax with f32 running max, sum and accumulator, and the output
``acc / max(l, 1e-30)`` in the input dtype. It is the binding of the
hand-written Hopper kernel ``csrc/flash_attention.cu`` (``wgmma`` products fed
by TMA: split TF32 for f32 inputs, bf16 for bf16), and counts its launches in
``flash_attention.launches``. It reads q, k and v through their strides, so
the encoder hands it head views of its projections, and writes its output
[B, L, H, D], so the encoder merges the heads with a view. ``attention_plain``
is the plain torch version of the same function, which the kernel is held
against on the card.
``multihead_attention`` is what the encoder calls. A training forward
(``train=True`` with grad enabled) takes ``attention_plain`` with its
``dropout_rate``, differentiable, with dropout on the probabilities, as the JAX
package sends every forward with dropout to ``_xla_attention``: the kernel has
no backward and is never trained through. Every other forward goes to the
kernel for CUDA tensors and to the plain version for CPU tensors; any other
device raises. The kernel refuses a tensor that requires grad: its output has
no ``grad_fn``, so taking it would leave every weight below the attention
with a zero gradient.

The JAX package takes the Pallas kernel only as an opt-in on the TPU
(``CAPREOLUS_FLASH_ATTENTION=1``) and otherwise ``_xla_attention``; in the
port, attention outside training on CUDA tensors is always K2. At f32, the dtype served, the
three agree to rounding. In bf16, ``_xla_attention`` keeps bf16 scores with a
-30000 fill; K2 keeps f32 scores and sums and rounds the probabilities to
bf16 for their product with v (the MXU's precision at its default), and
``attention_plain`` computes in f32 throughout (ROADMAP "Faults and
differences").
"""

from __future__ import annotations

import ctypes
import math

import torch

from capreolus_tpu_torch.ops import build
from capreolus_tpu_torch.ops.dropout import dropout

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND = []


def attention_plain(q, k, v, mask, dropout_rate=0.0, generator=None):
    """Plain torch version of K2: q, k, v [B, H, L, D] (any strides, the
    encoder's head views included), key mask [B, L] (bool or int, nonzero =
    attend) -> [B, H, L, D] in the input dtype.

    The math runs in f32 whatever the input dtype. A query row whose keys are
    all masked gets the mean of V, as both JAX paths give at f32. On CUDA the
    matmuls must run in true f32 (``torch.backends.cuda.matmul.allow_tf32``
    False, torch's default). A ``dropout_rate`` above 0 drops probabilities
    (``ops.dropout`` with ``generator``), as ``_xla_attention`` does with its
    ``dropout_rng``: the training forward's attention, differentiable. At 0 it
    is the function K2 is held against."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    scores = torch.matmul(qf, kf.transpose(-1, -2))  # [B, H, L, L]
    scores = scores.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, generator)
    return torch.matmul(probs, vf).to(q.dtype)


def _lib():
    lib = build.load("flash_attention")
    if not _BOUND:
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                               + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        _BOUND.append(True)
    return lib


def flash_attention(q, k, v, mask):
    """K2 on CUDA tensors: q, k, v [B, H, L, D], f32 or bf16, with D in (32,
    64, 128) and any L >= 1; key mask [B, L], bool or integer. q, k and v may
    be strided views (``x.view(B, L, H, D).transpose(1, 2)`` of a projection's
    output) as long as D is contiguous and every base and stride is a multiple
    of 16 bytes. Returns [B, H, L, D] in q's dtype, the ``transpose(1, 2)`` view
    of a [B, L, H, D] buffer, so merging the heads after it is a view. Raises on
    anything else, CPU tensors included (``multihead_attention`` routes those
    to ``attention_plain``), and tensors that require grad: the kernel has no
    backward."""
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.requires_grad:
            raise ValueError(f"flash_attention: {name} requires grad, and the kernel has no backward; "
                             f"a training forward takes multihead_attention(..., train=True)")
    if device.type != "cuda":
        raise ValueError(f"flash_attention: q is on {device}; the kernel takes CUDA tensors only")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t.device != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not one of {sorted(map(str, _DTYPE_CODES))}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention: q, k, v must share one [B, H, L, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, l, d = q.shape
    if d not in HEAD_DIMS or l < 1:
        raise ValueError(f"flash_attention: head dim {d} and length {l} outside the kernel's limits "
                         f"(D in {HEAD_DIMS}, L >= 1)")
    if tuple(mask.shape) != (b, l):
        raise ValueError(f"flash_attention: mask has shape {tuple(mask.shape)}, expected {(b, l)}")
    if mask.dtype.is_floating_point or mask.dtype.is_complex:
        raise TypeError(f"flash_attention: mask dtype {mask.dtype} is not bool or integer")
    elem = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension has stride {t.stride(3)}; it must be 1")
        if t.data_ptr() % 16 or any(t.stride(i) * elem % 16 or t.stride(i) < 0 for i in range(3)):
            raise ValueError(f"flash_attention: {name}'s base and its strides {tuple(t.stride())[:3]} "
                             f"({elem}-byte values) must be multiples of 16 bytes")
    if mask.dtype != torch.bool:
        mask = mask != 0
    mask = mask.contiguous()
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=device)
    if b * h == 0:
        return out.transpose(1, 2)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                         out.data_ptr(), b, h, l, d, _DTYPE_CODES[q.dtype], strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0


def multihead_attention(q, k, v, mask, train=False, dropout_rate=0.0, generator=None):
    """Multi-head attention [B, H, L, D] with a [B, L] key mask: in a training
    forward (``train`` with grad enabled) ``attention_plain`` with
    ``dropout_rate`` and ``generator``; otherwise K2 for CUDA tensors and
    ``attention_plain`` for CPU tensors."""
    if train and torch.is_grad_enabled():
        return attention_plain(q, k, v, mask, dropout_rate, generator)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, mask)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    raise ValueError(f"multihead_attention: unsupported device {q.device}")
