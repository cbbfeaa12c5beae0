"""The check that a run loaded neither JAX nor the JAX package.

A module is named by the part of its name before the first dot, compared
whole: ``capreolus_tpu_torch`` is the port and never matches
``capreolus_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "capreolus_tpu"})


def forbidden_modules(names=None):
    """Sorted top-level names among ``names`` (``sys.modules`` by default) that
    are forbidden."""
    names = sys.modules if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
