"""The controls of a cell's comparison, and the program's readings beside them.

    python3 gpubench/control.py --workload <name> --seeds 11,12,13 [--seconds 5]

For each seed in one process, one run of the cell as ``run.py`` makes it
(``run.run_cell``: set-up, warm-up, ``--seconds`` of the cell's traffic, the
reference's check of a seeded sample: the program's reading), and then each
of the reference's controls put in the program's place for the same sampled
requests (``CONTROLS`` of ``reference/<config>.py``: the reference one
precision below the configuration's). Prints one JSON line per seed. The
limits in the configuration are set between the two readings (PERF.md gives
them)."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run as bench_run  # noqa: E402
from lib import device as device_lib  # noqa: E402
from lib import registry  # noqa: E402


def readings(bench, workload, seed, seconds, device, tmpdir, scale=None):
    """{"program": numbers, "controls": {name: numbers}, ...} of one seed."""
    r = bench_run.run_cell(bench, workload, seed, seconds, 0, device, tmpdir, scale=scale, t0=0.0, controls=True)
    if "controls" not in r:
        raise RuntimeError(f"seed {seed}: no request finished in {seconds} s")
    return {"seed": seed, "requests": r["attempted"], "failed": r["failed"], "correct": r["correct"],
            "program": {k: c["value"] for k, c in r["checks"].items()}, "controls": r["controls"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    bench = registry.benchmark(HERE.parent)
    workload = registry.workload(bench, args.workload)
    device_lib.require_cards(workload["chips"])
    bench_run.cache_dirs(HERE.parent)
    for seed in (int(s) for s in args.seeds.split(",")):
        tmpdir = tempfile.mkdtemp(prefix="gpubench-control-")
        try:
            print(json.dumps(readings(bench, workload, seed, args.seconds, "cuda", tmpdir)), flush=True)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
