"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over the
measured window, exported as a Chrome trace and reduced to the device's
operations (kernels, copies, memsets), their union (busy seconds), the
window's length, and the host activity under each idle gap.

The harness marks its own spans with ``record_function``: ``gpubench.window``
around the measured window, ``gpubench.dispatch`` and ``gpubench.collect``
around its calls into the system. A gap is named by the innermost host span or
op under its midpoint, or ``host: python`` where no op runs there."""

from __future__ import annotations

import heapq
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "gpubench.window"


class Trace:
    """Device ops [(name, start_us, dur_us)] inside the window, host ops
    [(name, start_us, end_us)], and the window's bounds in trace microseconds."""

    def __init__(self, device_ops, host_ops, window):
        self.window = window
        lo, hi = window
        self.device_ops = [(n, s, d) for n, s, d in device_ops if s < hi and s + d > lo]
        self.host_ops = host_ops

    @classmethod
    def from_chrome(cls, path):
        with open(path, encoding="utf-8") as fh:
            events = json.load(fh)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        device, host, window = [], [], None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name, ts, dur = e.get("cat", ""), e.get("name", ""), float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                device.append((name, ts, dur))
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                host.append((name, ts, ts + dur))
                if name == WINDOW_SPAN:
                    window = (ts, ts + dur)
        if window is None:
            raise ValueError("the trace holds no gpubench.window span")
        return cls(device, host, window)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self):
        """The union of the device ops' intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.device_ops)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, match):
        """Total seconds of the device ops whose name satisfies ``match``, and their count."""
        total, count = 0.0, 0
        for name, _, dur in self.device_ops:
            if match(name):
                total += dur
                count += 1
        return total / 1e6, count

    def top_device_ops(self, n=10):
        by = defaultdict(float)
        for name, _, dur in self.device_ops:
            by[name] += dur / 1e6
        return sorted(([short(k), v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_by_host(self, n=10):
        """Idle seconds of the window summed by the host activity under each
        gap's midpoint (the innermost host op there), the ``n`` largest."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: (g[0] + g[1]) / 2)
        ops = sorted(self.host_ops, key=lambda o: o[1])
        active, i, by = [], 0, defaultdict(float)
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            while i < len(ops) and ops[i][1] <= mid:
                heapq.heappush(active, (-ops[i][1], ops[i][2], ops[i][0]))
                i += 1
            inner = None
            for neg_start, end, name in active:  # the latest-started op still open is the innermost
                if end >= mid and (inner is None or -neg_start > inner[0]):
                    inner = (-neg_start, name)
            if len(active) > 64:  # drop ops that have ended
                active = [a for a in active if a[1] >= mid]
                heapq.heapify(active)
            by["host: " + (short(inner[1]) if inner else "python")] += (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def short(name, width=80):
    """A kernel's or op's name without ``void``, anonymous namespaces and its
    argument list, at most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:width]


def profiled(fn, tmpdir):
    """Runs ``fn()`` under torch.profiler (CPU and CUDA activities) and returns
    (its result, the ``Trace``). The Chrome trace goes to ``tmpdir`` and is
    deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tmpdir, "gpubench_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
    prof.export_chrome_trace(path)
    try:
        return result, Trace.from_chrome(path)
    finally:
        os.remove(path)
