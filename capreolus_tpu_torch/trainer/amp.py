"""bf16 ``trainer.amp`` as the JAX trainer computes it.

The JAX trainer casts every f32 leaf of the parameter tree to bf16 before a
training forward (``amp`` ``train`` or ``both``) or a prediction (``pred`` or
``both``), and differentiates through the cast, so the gradient reaches the
f32 weights that optax updates. Its flax modules declared ``dtype=float32``
(every Dense and LayerNorm of the encoder, KNRM's combine layer, ...) promote
their bf16 parameters back to f32, so most arithmetic stays f32 on
bf16-rounded weights. Only where every operand is a parameter does JAX compute
in bf16: BERT's embedding sum, and a KNRM's embedding rows, their norms and,
on the accelerator path, their normalisation.

``bf16_params(model)`` gives the port the same function: inside the block
every f32 parameter reads as its bf16 rounding, widened back to f32 at each
call of its module, and a module's ``amp_bf16_params`` (the embedding tables)
read as bf16 tensors, which the module's code then sums or normalises in bf16
as JAX does. The rounding is an autograd op, so the gradient flows back to
the f32 parameter, which the optimizer updates. This is not
``torch.autocast``, which would run the matmuls themselves in bf16.
"""

from __future__ import annotations

import contextlib

import torch

from capreolus_tpu_torch.core import ConfigError

AMP_MODES = ("none", "train", "pred", "both")
_ALIASES = {"false": "none", "none": "none", "0": "none", "": "none", "true": "both", "1": "both"}


def amp_mode(value) -> str:
    """The normalised mode of a ``trainer.amp`` value: none, train, pred or
    both (``True`` is ``both``, ``False`` ``none``), as the JAX trainer's
    ``_amp_mode`` reads it; anything else raises ``ConfigError``."""
    raw = str(value).lower()
    mode = _ALIASES.get(raw, raw)
    if mode not in AMP_MODES:
        raise ConfigError(f"amp must be one of: none, train, pred, both (got {value!r})")
    return mode


@contextlib.contextmanager
def bf16_params(model: torch.nn.Module, enabled: bool = True):
    """Within the block, each f32 parameter of ``model`` reads as its bf16
    rounding: a bf16 tensor where its module lists it in
    ``amp_bf16_params``, else that tensor widened to f32 anew at each call
    of its module, as each flax module promotes the bf16 leaf it reads. So
    the gradients of a weight's uses (a positive and a negative forward) are
    rounded to bf16 one by one and summed in bf16, then widened into the f32
    parameter's ``grad``, as JAX differentiates its cast tree. The
    parameters come back on exit. Leave the block only after the backward
    pass of a forward run inside it: a layer that ``remat`` recomputes must
    read the same weights."""
    swapped, hooks = [], []

    def widen(module, args, rounded, native):
        for name, value in rounded.items():
            module._parameters[name] = value if name in native else value.float()

    try:
        if enabled:
            for module in model.modules():
                rounded = {name: param.to(torch.bfloat16) for name, param in module._parameters.items()
                           if param is not None and param.dtype == torch.float32}
                if not rounded:
                    continue
                swapped.extend((module, name, module._parameters[name]) for name in rounded)
                native = getattr(module, "amp_bf16_params", ())
                widen(module, (), rounded, native)
                hooks.append(module.register_forward_pre_hook(
                    lambda m, args, rounded=rounded, native=native: widen(m, args, rounded, native)))
        yield model
    finally:
        for hook in hooks:
            hook.remove()
        for module, name, param in reversed(swapped):
            module._parameters[name] = param


def round_int8_inference(model: torch.nn.Module):
    """The JAX trainer's ``amp`` prediction of an int8 reranker, on its
    inference model (a copy the reranker reloads from the training model at
    every ``prepare_inference``): calibrated on the f32 weights, then every
    f32 weight and GELU stat rounded to bf16 in place, and the weights
    quantized in bf16 arithmetic (``Int8Linear.quant_dtype``), as the JAX
    ``Int8Dense`` quantizes the bf16 kernel of a cast parameter tree.
    ``prepare_inference`` sets f32 quantization again before it calibrates."""
    from capreolus_tpu_torch.reranker.bert.encoder import set_quant_dtype

    with torch.no_grad():
        for param in model.parameters():
            param.copy_(param.to(torch.bfloat16))
        for name, buf in model.named_buffers():
            if name.endswith("gelu_amax"):
                buf.copy_(buf.to(torch.bfloat16))
        set_quant_dtype(model, torch.bfloat16)
