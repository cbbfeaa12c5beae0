"""Dropout as flax's ``nn.Dropout`` applies it, shared by the encoder's
hidden dropout and the attention probabilities' (``attention_plain``)."""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """``x`` with each value kept with probability ``1 - rate`` (one
    ``torch.rand`` draw of x's shape from ``generator``, on x's device) and
    scaled by ``1 / (1 - rate)``; the identity at ``rate`` 0."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
