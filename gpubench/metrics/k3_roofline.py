"""K3 (``ops/maxsim.py``, ``csrc/maxsim.cu``): the least time of every bf16
MaxSim in the traced window (queries and valid doc tokens read once, the
mask bias, the scores written once; the product over valid tokens at the bf16
peak) over the device time of the kernels named ``maxsim_kernel``."""

from lib.readers import roofline

KERNEL = "maxsim_kernel"


def read(run):
    return roofline(run, KERNEL, lambda op: op["kind"] == "maxsim" and op["dtype"] == "bf16")
