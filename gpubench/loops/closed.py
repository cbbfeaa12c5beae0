"""A closed loop: one client keeping the mix's ``in_flight`` requests
dispatched (1: send, wait for the answer, send the next; 2: dispatch request
N + 1, then collect request N).

Requests begin while the window is open; the window closes when the last
request begun in it has its answer on the host, so no request is cut in half.
A request is timed on the host clock from its dispatch to the return of its
collect: the moment its answers are on the host, which in a loop of one
client is the moment the client holds them. With two in flight, request N's
collect starts once request N + 1 is dispatched, so a request that finished
on the card during that dispatch waits for it, as the client's would."""

from __future__ import annotations

import contextlib
import time
from collections import deque


def run(system, mix, seconds, span=None):
    """Drives ``system.dispatch(payload) -> collect`` (``collect() ->
    answers``) over ``system.payloads()`` for ``seconds``. ``span(name)`` is a
    context manager the traced run passes (``torch.profiler.record_function``).

    Returns (records, window_s): a record per request begun, {"index",
    "payload", "dispatch", "done", "answers", "error"}."""
    span = span or (lambda name: contextlib.nullcontext())
    in_flight = mix["in_flight"]
    records, pending = [], deque()
    with span("gpubench.window"):
        start = time.perf_counter()
        end = start + seconds
        for index, payload in enumerate(system.payloads()):
            now = time.perf_counter()
            if now >= end:
                break
            rec = {"index": index, "payload": payload, "dispatch": now, "done": None, "answers": None, "error": None}
            records.append(rec)
            try:
                with span("gpubench.dispatch"):
                    collect = system.dispatch(payload)
            except Exception as e:  # a request that fails is counted, and the run goes on
                rec["error"], rec["done"] = repr(e), time.perf_counter()
                continue
            pending.append((rec, collect))
            while len(pending) >= in_flight:
                _collect(pending.popleft(), span)
        while pending:
            _collect(pending.popleft(), span)
        window = max([start] + [r["done"] for r in records]) - start
    return records, window


def _collect(item, span):
    rec, collect = item
    try:
        with span("gpubench.collect"):
            rec["answers"] = collect()
    except Exception as e:
        rec["error"] = repr(e)
    rec["done"] = time.perf_counter()

