"""HTTP front end: a JSON API and cross-request micro-batching over any
retrieval service of the port (``RetrievalService``, ``DenseRetrievalService``,
``ColbertRetrievalService``, ``ImpactRetrievalService``,
``HybridRetrievalService`` or ``RerankingService``): the JAX package's
``serving_http.py`` on the port's services.

The device engines want batches (one call per query batch amortizes the
host-to-device hop and fills the card), while serving traffic arrives one
query at a time: the ``MicroBatcher`` bridges the two. Requests park for up to
``window_ms`` while a batch accumulates, then one engine call serves the whole
batch. The HTTP layer is the standard library's ``ThreadingHTTPServer``:

    python -m capreolus_tpu_torch.serving_http --collection dummy --port 8080   # on "cuda"
    python -m capreolus_tpu_torch.serving_http --collection dummy --device cpu
    curl -XPOST localhost:8080/search -d '{"queries": ["covid vaccine"], "k": 10}'

Endpoints:
    POST /search     {"queries": [str, ...], "k": int}  -> {"results": [[[docid, score], ...], ...]}
    GET  /health     -> {"ok": true, "corpus_size": N}
    GET  /stats      -> query/batch counters + latency percentiles (observability)
    GET  /document?docid=X -> {"docid": ..., "text": ...}
    POST /refresh    merge pending incremental index ops (TpuIndex.add/delete_documents)
                     and swap in the new generation (Lucene NRT reopen)
                     -> {"refreshed": bool, "generation": N, "corpus_size": N}
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


class ServingStats:
    """Thread-safe serving counters + bounded latency reservoirs.

    Latencies are kept in rings (last ``maxlen`` observations) so the /stats
    endpoint reports RECENT percentiles at O(1) memory regardless of uptime.
    Two distributions are tracked: ``batch_latency_ms`` is dispatch→deliver —
    under pipelining this INCLUDES time parked in flight behind up to
    ``pipeline_depth - 1`` older batches, i.e. what a request experiences;
    ``service_ms`` is the service call (collect) duration alone, the number
    to watch for engine regressions independent of pipeline depth. A third,
    ``queue_wait_ms``, is each query's wait from ``submit`` until its batch
    is dispatched: the batching window and the time spent behind batches in
    flight.
    """

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=maxlen)
        self._svc = deque(maxlen=maxlen)
        self._wait = deque(maxlen=maxlen)
        self.queries = 0
        self.batches = 0
        self.errors = 0
        self.hedges = 0
        self.hedge_wins = 0
        self._p50_cache = None
        self._p50_at = 0

    def record_hedge(self, backup_won: bool = False):
        with self._lock:
            self.hedges += 1
            if backup_won:
                self.hedge_wins += 1

    def service_p50(self, min_samples: int = 8) -> Optional[float]:
        """Rolling median collect duration (seconds); None until enough
        history exists to set a meaningful hedge deadline. Recomputed at most
        every 16 batches — this is read on the collect hot path and a
        hedge deadline does not need per-batch precision."""
        with self._lock:
            if len(self._svc) < min_samples:
                return None
            if self._p50_cache is None or self.batches - self._p50_at >= 16:
                xs = sorted(self._svc)
                self._p50_cache = xs[len(xs) // 2]
                self._p50_at = self.batches
            return self._p50_cache

    def record_batch(self, n_queries: int, seconds: float,
                     service_seconds: Optional[float] = None):
        with self._lock:
            self.queries += n_queries
            self.batches += 1
            self._lat.append(seconds)
            if service_seconds is not None:
                self._svc.append(service_seconds)

    def record_queue_waits(self, seconds: Sequence[float]):
        """Each query's wait from submit to its batch's dispatch."""
        with self._lock:
            self._wait.extend(seconds)

    def record_error(self):
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            svc = sorted(self._svc)
            wait = sorted(self._wait)
            out = {"queries": self.queries, "batches": self.batches, "errors": self.errors,
                   "hedges": self.hedges, "hedge_wins": self.hedge_wins,
                   "mean_batch_size": round(self.queries / self.batches, 2) if self.batches else 0.0}

        def _pcts(xs):
            pct = lambda p: round(1e3 * xs[min(len(xs) - 1, int(p * len(xs)))], 3)
            return {"p50": pct(0.50), "p90": pct(0.90),
                    "p99": pct(0.99), "max": round(1e3 * xs[-1], 3)}

        if lat:
            out["batch_latency_ms"] = _pcts(lat)
        if svc:
            out["service_ms"] = _pcts(svc)
        if wait:
            out["queue_wait_ms"] = _pcts(wait)
        return out


class MicroBatcher:
    """Cross-request batcher: single-query submissions coalesce into one
    engine call. A request parks for at most ``window_ms`` (the batching
    window) or until ``max_batch`` requests are waiting, whichever is first;
    the worker thread then drains the queue and runs ONE ``service.search``
    over the union. The engine executes under the worker thread only, so
    services with per-call instance state need no extra locking.

    Services that expose ``search_async(queries, k) -> collect`` (every
    service of ``serving.py``) are pipelined: the worker dispatches batch N+1
    while batch N's results are still on their way to the host, keeping up to
    ``pipeline_depth`` batches in flight; an idle arrival's batch is
    collected at once.

    Hedging (``hedge_factor`` > 0, pipelined services only): a collect that
    exceeds max(``hedge_floor_ms``, ``hedge_factor`` x the rolling median
    service time) is taken as stalled and the same batch is dispatched again;
    the first leg to finish wins (results are deterministic) and the loser is
    discarded. Each leg runs on a daemon thread of its own, so stalled losers
    never hold a worker that a later collect needs (the JAX package's fixed
    4-worker pool could deadlock once four losers stalled)."""

    def __init__(self, service, window_ms: float = 2.0, max_batch: Optional[int] = None,
                 pipeline_depth: int = 4, hedge_factor: float = 3.0,
                 hedge_floor_ms: float = 25.0):
        self.service = service
        self.window_s = float(window_ms) / 1000.0
        self.max_batch = int(max_batch or getattr(service, "batch_size", 64))
        dispatch = getattr(service, "search_async", None)
        self._dispatch = dispatch if callable(dispatch) else None
        self.pipeline_depth = max(1, int(pipeline_depth)) if self._dispatch else 1
        self._hedge_factor = float(hedge_factor) if self._dispatch else 0.0
        self._hedge_floor_s = float(hedge_floor_ms) / 1000.0
        self._pending = deque()  # (query, k, slot) triples
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._closed = False
        self.stats = ServingStats()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="capreolus-microbatcher")
        self._worker.start()

    @property
    def batches_run(self) -> int:
        """How often the engine actually ran (alias of stats.batches — one
        counter, one lock; kept as the historical observability name)."""
        with self.stats._lock:
            return self.stats.batches

    def submit(self, query: str, k: int = 10) -> dict:
        """Enqueue one query; returns a slot to pass to ``result``. Submitting
        several queries before collecting lets one caller's batch coalesce
        internally as well as with concurrent callers."""
        slot = {"event": threading.Event(), "result": None, "error": None, "submitted": time.monotonic()}
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append((query, int(k), slot))
            self._wakeup.notify()
        return slot

    def result(self, slot: dict) -> List[Tuple[str, float]]:
        slot["event"].wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        """Blocking single-query API; coalesces with concurrent callers."""
        return self.result(self.submit(query, k))

    def close(self):
        with self._lock:
            self._closed = True
            self._wakeup.notify()
        self._worker.join(timeout=5)

    def _deliver(self, batch, results, t0, svc_s=None):
        if len(results) != len(batch):  # fail loudly, never hang waiters
            raise RuntimeError(f"service returned {len(results)} result lists "
                               f"for {len(batch)} queries")
        self.stats.record_batch(len(batch), time.monotonic() - t0, svc_s)
        for (_, k, slot), hits in zip(batch, results):
            slot["result"] = hits[:k]
            slot["event"].set()

    def _fail(self, batch, e):
        logger.exception("micro-batched search failed")
        self.stats.record_error()
        for _, _, slot in batch:
            slot["error"] = e
            slot["event"].set()

    def _run(self):
        inflight = deque()  # (batch, collect, t0, queries, k_max) — dispatched, not collected

        def run_collect(fn, out):
            try:
                out["results"] = fn()
            except Exception as e:  # surfaced via the winner check
                out["error"] = e
            finally:
                out["done"].set()

        def start_leg(fn, out):
            threading.Thread(target=run_collect, args=(fn, out), daemon=True, name="capreolus-hedge-leg").start()

        def collect_hedged(batch, collect, t0, queries, k_max, deadline_s):
            """Primary collect with a stall deadline; past it, re-dispatch the
            same batch and take whichever finishes first (results are
            deterministic; the loser is discarded on its own daemon thread)."""
            primary = {"done": threading.Event(), "results": None, "error": None}
            t1 = time.monotonic()
            start_leg(collect, primary)
            winner = primary
            if not primary["done"].wait(deadline_s):
                backup = {"done": threading.Event(), "results": None, "error": None}
                backup_dispatched = False
                try:
                    backup_collect = self._dispatch(queries, k=k_max)
                    start_leg(backup_collect, backup)
                    backup_dispatched = True
                except Exception:
                    logger.exception("hedge re-dispatch failed; waiting on primary")
                if backup_dispatched:
                    # first finisher wins; the poll interval grows after 1 s,
                    # since a real stall lasts seconds to minutes
                    poll, waited = 0.005, 0.0
                    while True:
                        if primary["done"].wait(poll):
                            winner = primary
                            break
                        if backup["done"].is_set():
                            winner = backup
                            break
                        waited += poll
                        if waited >= 1.0:
                            poll = 0.05
                    # prefer a SUCCESSFUL result: if the first finisher
                    # errored (e.g. the hedge hit a transient transport
                    # error) and the other leg is still in flight, give it a
                    # bounded chance to deliver before failing the batch
                    if winner["error"] is not None:
                        other = backup if winner is primary else primary
                        if other["done"].wait(30.0) and other["error"] is None:
                            winner = other
                else:
                    primary["done"].wait()
                self.stats.record_hedge(backup_won=winner is not primary)
            t_svc = time.monotonic() - t1
            if winner["error"] is not None:
                self._fail(batch, winner["error"])
            else:
                try:
                    self._deliver(batch, winner["results"], t0, t_svc)
                except Exception as e:
                    self._fail(batch, e)

        def collect_oldest():
            batch, collect, t0, queries, k_max = inflight.popleft()
            p50 = self.stats.service_p50() if self._hedge_factor > 0 else None
            if p50 is not None:
                deadline = max(self._hedge_floor_s, self._hedge_factor * p50)
                collect_hedged(batch, collect, t0, queries, k_max, deadline)
                return
            try:
                t1 = time.monotonic()
                results = collect()
                self._deliver(batch, results, t0, time.monotonic() - t1)
            except Exception as e:
                self._fail(batch, e)

        while True:
            batch = []
            with self._lock:
                while not self._pending and not self._closed and not inflight:
                    self._wakeup.wait()
                if self._closed and not self._pending and not inflight:
                    return
                if self._pending:
                    # batching window: wait out the window (or until full) so
                    # near-simultaneous requests ride the same executable.
                    # With results already in flight, skip the wait — the
                    # collect below is a natural accumulation window.
                    if not inflight:
                        deadline = time.monotonic() + self.window_s
                        while len(self._pending) < self.max_batch:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0 or self._closed:
                                break
                            self._wakeup.wait(timeout=remaining)
                    batch = [self._pending.popleft()
                             for _ in range(min(len(self._pending), self.max_batch))]
            if batch:
                queries = [q for q, _, _ in batch]
                k_max = max(k for _, k, _ in batch)
                t0 = time.monotonic()
                self.stats.record_queue_waits([t0 - slot["submitted"] for _, _, slot in batch])
                try:
                    if self._dispatch is not None:
                        inflight.append((batch, self._dispatch(queries, k=k_max), t0,
                                         queries, k_max))
                    else:
                        results = self.service.search(queries, k=k_max)
                        self._deliver(batch, results, t0, time.monotonic() - t0)
                except Exception as e:
                    self._fail(batch, e)
            # collect when the pipeline is full, or when there's nothing left
            # to dispatch (idle arrivals are collected immediately)
            while inflight and (len(inflight) >= self.pipeline_depth
                                or not (self._pending or batch)):
                collect_oldest()


class _Server(ThreadingHTTPServer):
    # the listen backlog: concurrent clients past the standard library's 5
    # would have their connections reset before a handler thread takes them
    request_queue_size = 128


def make_server(service, host: str = "127.0.0.1", port: int = 0,
                window_ms: float = 2.0) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server; ``port=0`` picks a free port
    (``server.server_address[1]`` reports it). Every query — across requests
    AND within multi-query requests — is routed through one MicroBatcher, so
    concurrent handler threads coalesce into shared engine calls (the batcher's
    worker thread is the only one that touches the device). ``window_ms=0``
    still batches whatever is already queued, just without waiting."""
    batcher = MicroBatcher(service, window_ms=window_ms)
    refresh_lock = threading.Lock()

    def corpus_size():
        return len(getattr(service, "_docids", []) or [])

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through the framework logger
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health":
                self._reply(200, {"ok": True, "corpus_size": corpus_size()})
            elif url.path == "/stats":
                self._reply(200, batcher.stats.snapshot())
            elif url.path == "/document":
                docid = parse_qs(url.query).get("docid", [None])[0]
                if not docid:
                    self._reply(400, {"error": "missing docid"})
                    return
                text = service.get_document(docid)
                if text is None:
                    self._reply(404, {"error": f"unknown docid {docid!r}"})
                else:
                    self._reply(200, {"docid": docid, "text": text})
            else:
                self._reply(404, {"error": f"unknown path {url.path!r}"})

        def do_POST(self):
            path = urlparse(self.path).path
            if path == "/refresh":
                # NRT reopen: merge pending incremental index ops and swap the
                # served engine (service.refresh). In-flight searches finish on
                # the old engine; the lock only serializes concurrent refreshes.
                if not hasattr(service, "refresh"):
                    self._reply(400, {"error": "service does not support refresh"})
                    return
                try:
                    with refresh_lock:
                        changed = bool(service.refresh())
                    gen = getattr(getattr(service, "index", None), "generation", None)
                    self._reply(200, {"refreshed": changed, "generation": gen,
                                      "corpus_size": corpus_size()})
                except Exception as e:
                    logger.exception("refresh failed")
                    self._reply(500, {"error": f"refresh failed: {e}"})
                return
            if path != "/search":
                self._reply(404, {"error": "POST /search or /refresh only"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                queries = req["queries"]
                k = int(req.get("k") or 10)
                want_snippets = bool(req.get("snippets", False))
                if not isinstance(queries, list) or not all(isinstance(q, str) for q in queries):
                    raise ValueError("'queries' must be a list of strings")
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                # submit every query before collecting: a multi-query request
                # coalesces internally and with concurrent requests
                slots = [batcher.submit(q, k) for q in queries]
                results = [batcher.result(s) for s in slots]
            except Exception as e:
                logger.exception("search failed")
                self._reply(500, {"error": f"search failed: {e}"})
                return
            payload = {"results": [[[d, s] for d, s in hits] for hits in results]}
            if want_snippets:
                try:
                    # host-only work (mmap doc store + analyzer) in the handler
                    # thread — never blocks the batcher's device loop
                    payload["snippets"] = [service.snippets(q, hits)
                                           for q, hits in zip(queries, results)]
                except Exception as e:
                    payload["snippets_error"] = str(e)
            self._reply(200, payload)

    server = _Server((host, port), Handler)
    server.batcher = batcher  # exposed so callers can close() it on shutdown
    return server


def main(argv: Optional[List[str]] = None):
    import argparse

    p = argparse.ArgumentParser(description="capreolus_tpu_torch retrieval HTTP server")
    p.add_argument("--collection", default="dummy")
    p.add_argument("--collection-path", default=None)
    p.add_argument("--backend", choices=["sparse", "dense", "colbert", "impact", "rerank", "hybrid"],
                   default="sparse")
    p.add_argument("--model", default="bm25", help="sparse scoring model")
    p.add_argument("--config", default="", help="dotted k=v searcher/reranker config "
                   "string, e.g. 'clusters=1024 nprobe=16' (dense/colbert) or "
                   "'reranker.name=KNRM reranker.extractor.embeddings=glove6b' (rerank)")
    p.add_argument("--checkpoint", default=None,
                   help="trained reranker checkpoint (required for --backend rerank)")
    p.add_argument("--topn", type=int, default=100,
                   help="first-stage candidates fed to the reranker (rerank backend)")
    p.add_argument("--extractor-state", default=None,
                   help="training-time extractor state (extractor_state.pkl written next "
                   "to the checkpoints by rerank.train) — required when the model has "
                   "vocabulary-sized trained params (e.g. finetune=True)")
    p.add_argument("--device", default="cuda", help="the services' device: cuda (the default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    from capreolus_tpu_torch.core.config import config_string_to_dict
    from capreolus_tpu_torch.serving import (ColbertRetrievalService, DenseRetrievalService,
                                             HybridRetrievalService, ImpactRetrievalService,
                                             RerankingService, RetrievalService)

    cfg = config_string_to_dict(args.config) if args.config else {}
    where = dict(collection=args.collection, collection_path=args.collection_path, device=args.device)
    if args.backend == "hybrid":
        # sparse + dense fused per query (RRF); --config keys address the
        # dense leg (e.g. "clusters=1024 nprobe=16 method=interp alpha=0.7")
        method = cfg.pop("method", "rrf")
        alpha = float(cfg.pop("alpha", 0.5))
        sparse = RetrievalService.from_config(model=args.model, **where)
        dense = DenseRetrievalService.from_config(**where, **cfg)
        service = HybridRetrievalService(sparse, dense, method=method, alpha=alpha)
    elif args.backend == "dense":
        service = DenseRetrievalService.from_config(**where, **cfg)
    elif args.backend == "colbert":
        service = ColbertRetrievalService.from_config(**where, **cfg)
    elif args.backend == "impact":
        # learned-sparse serving; --config keys address the impact searcher,
        # e.g. "encoder=splade checkpointfile=..."
        service = ImpactRetrievalService.from_config(**where, **cfg)
    elif args.backend == "rerank":
        if not args.checkpoint:
            p.error("--backend rerank requires --checkpoint")
        import capreolus_tpu_torch

        capreolus_tpu_torch.load_all_modules()
        from capreolus_tpu_torch.reranker import Reranker

        rcfg = dict(cfg.get("reranker", {}))
        name = rcfg.pop("name", "KNRM")
        ext = dict(rcfg.pop("extractor", {}))
        idx = dict(ext.pop("index", {}))
        coll = dict(idx.pop("collection", {}))
        coll.setdefault("name", args.collection)
        if args.collection_path:
            coll.setdefault("path", args.collection_path)
        ext["index"] = {**idx, "collection": coll}
        rcfg["extractor"] = ext
        reranker = Reranker.create(name, rcfg)
        service = RerankingService(reranker.extractor.index, reranker, args.checkpoint, topn=args.topn,
                                   extractor_state_path=args.extractor_state, model=args.model,
                                   device=args.device)
    else:
        service = RetrievalService.from_config(model=args.model, **where, **cfg)
    server = make_server(service, host=args.host, port=args.port)
    logger.info("serving %s retrieval on http://%s:%d", args.backend, *server.server_address)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        server.batcher.close()


if __name__ == "__main__":
    main()
