"""Named spans of the port's host work, recorded by ``torch.profiler``.

    from capreolus_tpu_torch.utils.tracing import TimedSpan, span

    with span("search.score"):
        scores, ords = topk(queries, *corpus)

While a ``torch.profiler`` profile is recording (the trainer's ``profile``
option, or a caller's own ``torch.profiler.profile``), a span enters
``torch.profiler.record_function(name)``: it lands in the profile as a
``user_annotation`` event, on the same clock as the kernels and copies the
card runs, and its parent is the span it nests in on its thread. With no
profile recording, ``span`` checks one flag and returns a shared no-op
context: nothing is built or kept. The profile is the store and its trace
(``export_chrome_trace``) the export.

The profiler records the thread that started it: on torch 2.11 and 2.13 a
span entered on another thread does not reach the trace (a service's spans
while the HTTP front end's micro-batching worker calls it, for one). A span
carries its name only; no request identifier reaches the exported event.

``TimedSpan(name)`` is ``span(name)`` for a caller that also wants its
host-clock time: ``seconds`` sums every entry of the object, ``start`` and
``stop`` are the last entry's ``time.perf_counter()`` readings.

The port's spans (a few per request or step, and one per candidate document
in a rerank):

- services (``serving.py``): ``search.analyze``, ``search.tokenize``,
  ``search.encode``, ``search.prf`` and ``search.score`` at dispatch,
  ``search.fetch`` (the scores' copy to the host) and ``search.hits`` (the
  request's hit lists) at collect; ``RerankingService`` adds
  ``rerank.first_stage`` (at dispatch and at collect), ``rerank.stage``
  holding ``rerank.features`` (``features.query``, one ``features.inputs``
  per candidate, ``features.collate``), ``rerank.calibrate`` (once),
  ``rerank.model`` and ``rerank.sort``;
- features (``extractor/bertpassage.py``): ``features.doc_tokens``, a
  document's passages tokenized on a passage-cache miss;
- rerankers (``reranker/__init__.py``): ``reranker.inputs``, one batch
  array's copy to the device;
- trainer (``trainer/torch_trainer.py``): ``trainer.step`` holding
  ``trainer.forward``, ``trainer.backward`` and ``trainer.optimizer``;
  ``trainer.wait_batch`` (the train loop waiting on its producer).
"""

from __future__ import annotations

import contextlib
import time

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profile records,
    else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NOOP


class TimedSpan:
    """``span(name)`` that keeps its host-clock seconds (``seconds``, summed
    over every entry; ``start`` and ``stop`` of the last one)."""

    __slots__ = ("name", "seconds", "start", "stop", "_span")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.start = self.stop = self._span = None

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop = time.perf_counter()
        self.seconds += self.stop - self.start
        return self._span.__exit__(*exc)
