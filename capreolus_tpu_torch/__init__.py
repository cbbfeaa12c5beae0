"""capreolus_tpu_torch: the PyTorch / CUDA port of capreolus_tpu.

The JAX package ``capreolus_tpu`` is the reference; this package keeps its
layout and module names so that each module's counterpart is easy to find, and
imports nothing of it (nor of JAX). It serves retrieve-then-rerank search (the
BM25 exact scoring engine, then KNRM or monoBERT-MaxP) and ColBERT
late-interaction retrieval; each TPU kernel on those paths is hand-written CUDA
for Hopper under ``csrc/`` (K1 ``knrm_pool.cu``, K2 ``flash_attention.cu``,
K3 ``maxsim.cu``).

Entry points run on the GPU unless the caller asks for the CPU
(``RetrievalService(..., device="cpu")``).
"""

__version__ = "0.1.0"

from capreolus_tpu_torch.core import (
    ConfigError,
    ConfigOption,
    Dependency,
    ModuleBase,
    constants,
    module_registry,
)
from capreolus_tpu_torch.utils.loginit import get_logger

_MODULE_PACKAGES = (
    "collection",
    "index",
    "tokenizer",
    "extractor",
    "reranker",
    "searcher",
)

_loaded = False


def load_all_modules():
    """Import every module-type package so their @register decorators run."""
    global _loaded
    if _loaded:
        return
    import importlib

    for pkg in _MODULE_PACKAGES:
        importlib.import_module(f"capreolus_tpu_torch.{pkg}")
    _loaded = True


__all__ = [
    "ConfigError",
    "ConfigOption",
    "Dependency",
    "ModuleBase",
    "constants",
    "get_logger",
    "load_all_modules",
    "module_registry",
]
