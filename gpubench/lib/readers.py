"""What the per-layer metric files share: a kernel's share of its roofline
from the traced window, and medians of the program's spans."""

from __future__ import annotations

import statistics

from lib import work


def roofline(run, kernel, is_op):
    """100 x (the sum of the least times of the window's ops that ``is_op``
    selects) / (the device seconds of the kernels whose name holds
    ``kernel``); None where either is nothing."""
    ops = [op for op in run.ops if is_op(op)]
    seconds, count = run.trace.device_seconds(lambda name: kernel in name)
    if not ops or count == 0 or seconds <= 0:
        return None
    return 100.0 * sum(work.least_seconds(op, run.peaks) for op in ops) / seconds


def span_median(run, stage):
    values = [s[stage] for s in run.spans if stage in s]
    return statistics.median(values) if values else None
