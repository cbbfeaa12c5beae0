"""A training loop: optimizer steps back to back (``system.step()``) while the
window is open; the window closes once the last step begun in it has
finished on the card (``system.sync()``). A step is not timed on its own: the
host queues it and the card runs it later, so every step's ``done`` is the
window's close and the rate is the samples of every step over the window."""

from __future__ import annotations

import contextlib
import time



def run(system, mix, seconds, span=None):
    """Returns (records, window_s): a record per step begun, {"index",
    "payload" (None), "dispatch", "done", "answers" (the step's), "error"}."""
    span = span or (lambda name: contextlib.nullcontext())
    records = []
    with span("gpubench.window"):
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            rec = {"index": len(records), "payload": None, "dispatch": time.perf_counter(), "done": None,
                   "answers": None, "error": None}
            records.append(rec)
            try:
                with span("gpubench.step"):
                    rec["answers"] = system.step()
            except Exception as e:  # a step that fails is counted, and the run goes on
                rec["error"] = repr(e)
        system.sync()
        done = time.perf_counter()
    for rec in records:
        rec["done"] = done
    return records, done - start
