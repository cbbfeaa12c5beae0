"""Shared fixtures of the benchmark's own tests: the harness's directory on
the import path, and the tiny scale at which a cell runs on the CPU."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

TINY_BERT = {"vocab_size": 1024, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 128}


def tiny_scale(workload):
    """Widths and sizes a CPU test can hold: the port's ``tiny`` BERT, a few hundred docs."""
    if workload.startswith("colbert"):
        return {"pretrained": "tiny", "model": dict(TINY_BERT, dim=16),
                "corpus": {"docs": 300, "centres": 64, "block": 128,
                           "len": {"median": 16, "sigma": 0.5, "min": 4, "max": 40}}}
    return {"pretrained": "tiny", "model": dict(TINY_BERT),
            "corpus": {"docs": 300, "min_len": 30, "max_len": 120, "vocab": 2000, "topics": 20,
                       "title_ranks": [20, 200]}}


@pytest.fixture
def bench():
    from lib import registry

    return registry.benchmark()


@pytest.fixture
def cpu_cache(tmp_path, monkeypatch):
    """The port's caches under the test's own directory."""
    monkeypatch.setenv("CAPREOLUS_CACHE", str(tmp_path / "cache"))
    return tmp_path
