"""Q1 (``ops/quantization.py``, ``csrc/quantize_per_token.cu``): the least time
of every per-token quantization in the traced window (f32 rows read once,
codes and scales written once) over the device time of the kernels named
``quantize_per_token_kernel``."""

from lib.readers import roofline

KERNEL = "quantize_per_token_kernel"


def read(run):
    return roofline(run, KERNEL, lambda op: op["kind"] == "quantize")
