"""The program's spans in a traced window, for the per-layer metrics that read
them: each span the port records (``capreolus_tpu_torch/utils/tracing.py``)
is a host op of the trace (``lib/trace.py``: name, start, end), on the
profiler's clock. Only spans wholly inside the ``gpubench.window`` span
count, so the warm-up's are left out.

A span's parent is the span of the given name that holds it in time (the
program's spans of one request run on one thread, one after another). A
metric is the window's total over its finished requests or steps (a mean,
so that the parts of one layer add up), 0.0 where its parent spans ran and
it found no child, and None where no parent span ran (a program without
these spans, or an untraced run)."""

from __future__ import annotations

import bisect
from collections import defaultdict


class Spans:
    """The window's host ops by name: {name: [(start_us, end_us)] by start}."""

    def __init__(self, trace):
        lo, hi = trace.window
        by = defaultdict(list)
        for name, start, end in trace.host_ops:
            if lo <= start and end <= hi:
                by[name].append((start, end))
        self.by = {name: sorted(v) for name, v in by.items()}

    def count(self, name, within=None):
        return len(self._select(name, within))

    def seconds(self, name, within=None):
        """Total seconds of the ``name`` spans (held in a ``within`` span, if given)."""
        return sum(end - start for start, end in self._select(name, within)) / 1e6

    def self_seconds(self, name, children):
        """Total seconds of the ``name`` spans less the part their ``children``
        spans (names) cover."""
        total = self.seconds(name)
        for child in children:
            total -= self.seconds(child, within=name)
        return total

    def _select(self, name, within):
        spans = self.by.get(name, [])
        if within is None:
            return spans
        parents = self.by.get(within, [])
        starts = [s for s, _ in parents]
        out = []
        for start, end in spans:
            i = bisect.bisect_right(starts, start) - 1  # the latest parent begun by then
            if i >= 0 and parents[i][1] >= end:
                out.append((start, end))
        return out


def of(run, parent):
    """The window's ``Spans``, or None where the run is untraced or no
    ``parent`` span ran in its window."""
    if getattr(run, "trace", None) is None:
        return None
    spans = Spans(run.trace)
    return spans if spans.count(parent) else None


def ms_per_item(run, seconds):
    """``seconds`` in ms per finished request or step of the window."""
    return 1e3 * seconds / len(run.finished) if run.finished else None
