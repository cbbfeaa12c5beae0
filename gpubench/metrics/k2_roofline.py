"""K2 (``ops/flash_attention.py``, ``csrc/flash_attention.cu``): the least time
of every attention in the traced window (q read and the output written once,
the k and v rows each row needs, the mask; two products per needed key at the
peak of the inputs' precision, f32 at TF32's) over the device time of the
kernels named ``attention_kernel``."""

from lib.readers import roofline

KERNEL = "attention_kernel"


def read(run):
    return roofline(run, KERNEL, lambda op: op["kind"] == "attention")
