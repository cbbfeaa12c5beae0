"""The serving model's share of the card's peak over the traced window: the
least time the model's products of every request in the window take at the
published peaks of their declared precision (int8 1,979 TOP/s, bf16 989
TFLOP/s, f32 at TF32's 495 TFLOP/s: ``lib/device.py``, dense, at 700 W; the
card's power limit is printed beside every run), over the window's length.
Products: every projection, FFN and head product, attention's two products
over the keys each row needs, MaxSim's product over valid doc tokens
(``lib/work.py``). An op marked ``"mfu": False`` is an implementation's
product, not the model's (the int8 ColBERT engine's product over every doc
token, which its MaxSim op already counts)."""

from lib import work


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    return 100.0 * sum(work.product_seconds(op, run.peaks) for op in run.ops if op.get("mfu", True)) / run.window_s
