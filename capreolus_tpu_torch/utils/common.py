"""Common utilities (the ``padlist`` of the JAX package's ``utils/common.py``)."""

from __future__ import annotations


def padlist(items, padlen, pad_token=0):
    """Pad (right) or truncate a list to exactly ``padlen`` items."""
    items = list(items[:padlen])
    return items + [pad_token] * (padlen - len(items))
