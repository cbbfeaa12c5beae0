"""Kernels of the port: each with its plain torch version and a launch count.

``simmat``: K1, the fused KNRM simmat + kernel pooling (``csrc/knrm_pool.cu``).
``flash_attention``: K2, masked attention with an online softmax
(``csrc/flash_attention.cu``).
``build``: nvcc build and ctypes load of the CUDA sources.
"""
