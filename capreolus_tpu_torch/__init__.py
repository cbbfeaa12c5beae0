"""capreolus_tpu_torch: the PyTorch / CUDA port of capreolus_tpu.

The JAX package ``capreolus_tpu`` is the reference; this package keeps its
layout and module names so that each module's counterpart is easy to find, and
imports nothing of it (nor of JAX). It serves retrieve-then-rerank search (the
BM25 exact scoring engine, then KNRM or monoBERT-MaxP) and ColBERT
late-interaction retrieval, and runs the rank and rerank tasks from its CLI
(``python -m capreolus_tpu_torch rank.searcheval with ...``,
``rerank.traineval``, which trains KNRM or monoBERT-MaxP); each TPU kernel
on those paths is hand-written CUDA for Hopper under ``csrc/`` (K1
``knrm_pool.cu``, K2 ``flash_attention.cu``, K3 ``maxsim.cu``, X1
``int8_matmul.cu``). The index build, query analysis and block-max pruning
run their host work in C++ under ``native/`` (built by g++ at first use).
The published benchmarks (``robust04``, ``antique``, ``core17/18``, ...)
resolve their topics, qrels and folds from config files and the shipped
``data/``, and never download offline (``CAPREOLUS_OFFLINE=1``).

Entry points run on the GPU unless the caller asks for the CPU
(``RetrievalService(..., device="cpu")``, ``--device=cpu`` on the CLI).
"""

__version__ = "0.1.0"

from capreolus_tpu_torch.core import (
    ConfigError,
    ConfigOption,
    Dependency,
    ModuleBase,
    config_list_to_dict,
    config_string_to_dict,
    constants,
    module_registry,
)
from capreolus_tpu_torch.utils.loginit import get_logger

_MODULE_PACKAGES = (
    "collection",
    "benchmark",
    "index",
    "searcher",
    "tokenizer",
    "extractor",
    "reranker",
    "sampler",
    "trainer",
    "task",
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


def parse_config_string(config_string: str) -> dict:
    """Parse a whitespace-delimited 'a.b=1 c=2' string into a nested config dict."""
    return config_string_to_dict(config_string)


__all__ = [
    "ConfigError",
    "ConfigOption",
    "Dependency",
    "ModuleBase",
    "config_list_to_dict",
    "constants",
    "get_logger",
    "load_all_modules",
    "module_registry",
    "parse_config_string",
]
