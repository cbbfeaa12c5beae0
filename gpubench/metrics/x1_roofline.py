"""X1 (``ops/int8_matmul.py``, ``csrc/int8_matmul.cu``): the least time of
every int8 product in the traced window, each at its own epilogue (int32,
f32 dequantization, int8-gelu), over the device time of the kernels named
``int8_gemm_kernel``."""

from lib.readers import roofline

KERNEL = "int8_gemm_kernel"


def read(run):
    return roofline(run, KERNEL, lambda op: op["kind"] == "gemm" and op["dtype"] == "int8")
