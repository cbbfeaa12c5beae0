"""``idle_share`` (``metrics/idle_share.py``) of the training cells."""

from lib import registry


def read(run):
    return registry.load_module("metrics", "idle_share").read(run)
