"""The port's benchmark: one run of one cell.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's system from its configuration and the seed (set-up),
warms up the cell's shapes, measures for ``--seconds`` with the cell's
traffic (driven by the loop the mix names), reads the cell's end-to-end
metrics (``--trace 0``) or, under ``torch.profiler``, its per-layer metrics
(``--trace 1``), then checks a sample of the window's answers against the
plain reference and prints one JSON line. It runs on the card only: without
one it exits non-zero and prints no result. The cell, its configuration,
traffic mix, loop, metrics and reference are found by name
(``lib/registry.py``)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))  # the port, from the checkout

from lib import device as device_lib  # noqa: E402
from lib import nojax, registry  # noqa: E402
from lib.corpus import rng_of  # noqa: E402


def process_start():
    """``time.perf_counter()`` at this process's start (Linux's /proc), or now."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T0 = process_start()


def cache_dirs(root):
    """The program's build and kernel caches at fixed paths inside the checkout."""
    base = Path(root) / "build" / "gpubench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("CAPREOLUS_LOGGING", "WARNING")


class Run:
    """What a metric reader reads: the window's records and length, set-up
    seconds, the program's spans, the ops of the window (``lib/work.py``),
    the card's peaks and, in a traced run, the device trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def sample(finished, n, seed, items):
    """``n`` finished requests drawn from the seed, the one with most items among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: items(finished[i]))
    rest = [i for i in range(len(finished)) if i != longest]
    picks = rng_of(seed, "sample").permutation(len(rest))[:max(0, n - 1)]
    return [finished[longest]] + [finished[rest[int(i)]] for i in sorted(picks)]


def run_cell(bench, workload, seed, seconds, trace, device="cuda", tmpdir=None, scale=None, t0=None, patch=None,
             controls=False):
    """One run of ``workload`` (an entry of ``bench["workloads"]``); returns the
    result dict. ``scale`` overrides widths and sizes (the CPU tests' tiny
    cells); ``patch(system)``, called before the warm-up (a training cell's
    first steps are part of it), lets a test break the timed path underneath. ``controls`` adds ``result["controls"]``: each of
    the reference's controls (``CONTROLS``), put in the program's place for
    the same sampled requests, compared as the program was
    (``control.py``)."""
    import torch

    t0 = T0 if t0 is None else t0
    config = registry.load_json("configs", workload["config"])
    mix = registry.load_json("traffic", workload["traffic"])
    loop = registry.load_module("loops", mix["loop"])
    system = registry.load_module("systems", config["system"]).System(config, mix, seed, device, tmpdir, scale)
    if patch is not None:
        patch(system)
    system.warm()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    tr = None
    if trace:
        from torch.profiler import record_function

        from lib import trace as trace_lib

        system.trace_on()
        (records, window_s), tr = trace_lib.profiled(
            lambda: loop.run(system, mix, seconds, record_function),
            tmpdir)
        system.trace_off()
    else:
        records, window_s = loop.run(system, mix, seconds)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    finished = [r for r in records if r["error"] is None and r["answers"] is not None]
    peaks = device_lib.peaks_of(torch.cuda.get_device_name(0)) if on_card else device_lib.peaks_of("H100")
    run = Run(config=config, mix=mix, workload=workload, records=records, finished=finished, window_s=window_s,
              setup_s=setup_s, setup_parts=dict(system.setup_parts), trace=tr, peaks=peaks,
              items=system.items, spans=system.spans(finished), ops=system.ops(finished) if trace else [])
    metrics = {}
    for m in registry.metrics_of(bench, workload["name"], trace):
        value = registry.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    chosen = sample(finished, config["check"]["requests"], seed, system.items)
    inputs = system.inputs
    system.free()
    del system
    reference = registry.load_module("reference", config["name"])
    numbers = reference.check(inputs, config, mix, chosen, device) if chosen else {}
    checks = {name: {"value": float(numbers.get(name, float("inf"))), "limit": float(limit)}
              for name, limit in config["limits"].items()}
    failed = len(records) - len(finished)
    correct = bool(finished) and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(records), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": workload["chips"], "memory_peak_bytes": int(memory_peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_by_host()}
    result["setup_parts_s"] = run.setup_parts
    if controls and chosen:
        result["controls"] = {name: fn(inputs, config, mix, chosen, device) for name, fn in reference.CONTROLS.items()}
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    bench = registry.benchmark(root)
    workload = registry.workload(bench, args.workload)
    device_lib.require_cards(workload["chips"])
    cache_dirs(root)
    tmpdir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        result = run_cell(bench, workload, args.seed, args.seconds, args.trace, "cuda", tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    found = nojax.forbidden_modules()
    if found:
        print(f"gpubench: the run loaded forbidden modules: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"gpubench: {workload['name']} seed {args.seed} on {device_lib.power_limit()}; set-up parts (s) "
          f"{json.dumps(result['setup_parts_s'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
