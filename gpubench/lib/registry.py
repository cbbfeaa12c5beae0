"""Finds each part of a cell by its name in ``BENCHMARK.json``: a
configuration is ``configs/<name>.json``, a traffic mix ``traffic/<name>.json``,
a per-layer metric ``metrics/<name>.py`` (its ``read(run)``), a reference
``reference/<config>.py`` and a system ``systems/<system>.py``, where the
configuration names its system. Adding any of them is adding a file."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # gpubench/
ROOT = HERE.parent  # the checkout


def benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind, name, base=HERE):
    with open(Path(base) / kind / f"{name}.json", encoding="utf-8") as fh:
        return json.load(fh)


def load_module(kind, name, base=HERE):
    """The module of ``<base>/<kind>/<name>.py``, loaded by its path (names may
    hold dots and dashes), cached in ``sys.modules`` under a private name."""
    key = f"gpubench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = Path(base) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def metrics_of(bench, workload_name, trace):
    """The metric entries a run of the cell reports: its end-to-end metrics with
    ``trace`` 0, its per-layer metrics with ``trace`` 1 (an entry without a
    ``workloads`` key counts for every cell that reports what it moves)."""
    e2e = [m for m in bench["end_to_end"] if workload_name in m.get("workloads", [workload_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload_name in m.get("workloads", [workload_name]) and m["moves"] in reported]
