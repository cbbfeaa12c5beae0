"""``mfu`` (``metrics/mfu.py``) of the training cells: the model's products of
every step of the traced window, the forward over both sides' sequences and
the backward at twice its products, all f32 and so charged at TF32's peak,
over the window's length."""

from lib import registry


def read(run):
    return registry.load_module("metrics", "mfu").read(run)
