"""The PyTorch port's HTTP front end (``serving_http.py``: ``ServingStats``,
``MicroBatcher``, ``make_server``, ``main``) against the JAX package's, on the
CPU: the cases of the JAX suite's ``tests/test_serving.py`` micro-batcher and
HTTP tests, run on both packages where a service is involved, and the cases
the port adds: more stalled hedge losers than the JAX pool had workers, the
``/health`` corpus size of every service, ``/refresh`` and ``--device``.

Tolerance: none. Every HTTP payload is compared whole with the JAX server's
over the same index, or with the service's own ``search``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

import capreolus_tpu.serving as jax_serving  # noqa: E402
import capreolus_tpu.serving_http as jax_http  # noqa: E402
import capreolus_tpu_torch.serving as port_serving  # noqa: E402
import capreolus_tpu_torch.serving_http as port_http  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401

QUERIES = ["galaxies collide", "whales in the ocean", "telescope orbit"]


class Server:
    """make_server on a loopback ephemeral port, served on a daemon thread."""

    def __init__(self, module, service, **options):
        self.server = module.make_server(service, port=0, **options)
        host, port = self.server.server_address
        self.base = f"http://{host}:{port}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def get(self, path):
        return json.load(urllib.request.urlopen(self.base + path, timeout=30))

    def post(self, path, body):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        try:
            return 200, json.load(urllib.request.urlopen(urllib.request.Request(
                self.base + path, method="POST", data=data), timeout=30))
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.server.batcher.close()


@pytest.fixture
def servers(tmpdir_as_cache, torch_cache):
    jax_svc = jax_serving.RetrievalService.from_config(collection="dummy")
    port_svc = port_serving.RetrievalService.from_config(collection="dummy", device="cpu")
    pair = (Server(jax_http, jax_svc), Server(port_http, port_svc))
    yield pair
    for s in pair:
        s.close()


# ---------------------------------------------------------------- the micro-batcher
def test_micro_batcher_coalesces(torch_cache):
    svc = port_serving.RetrievalService.from_config(collection="dummy", device="cpu")
    direct = svc.search(QUERIES, k=2)
    batcher = port_http.MicroBatcher(svc, window_ms=5000.0, max_batch=3)
    slots = [batcher.submit(q, k=2) for q in QUERIES]
    out = [batcher.result(s) for s in slots]
    batcher.close()
    assert out == direct
    assert batcher.batches_run == 1  # one engine call


@pytest.mark.parametrize("module", [jax_http, port_http], ids=["jax", "port"])
def test_micro_batcher_fails_loudly_and_propagates_errors(module):
    class Short:
        batch_size = 4

        def search(self, queries, k=10):
            return [[("D1", 1.0)]][: max(0, len(queries) - 1)]  # always one short

    class Boom:
        batch_size = 4

        def search(self, queries, k=10):
            raise RuntimeError("engine down")

    for service, match in ((Short(), "result lists"), (Boom(), "engine down")):
        batcher = module.MicroBatcher(service, window_ms=1.0)
        with pytest.raises(RuntimeError, match=match):
            batcher.search("q", k=1)
        batcher.close()
        assert batcher.stats.snapshot()["errors"] == 1


def test_micro_batcher_pipelines_async_services():
    events = []

    class Async:
        batch_size = 2

        def search_async(self, queries, k=10):
            qs = list(queries)
            events.append(("dispatch", tuple(qs)))

            def collect():
                events.append(("collect", tuple(qs)))
                return [[(q.upper(), float(k))] for q in qs]

            return collect

        def search(self, queries, k=10):
            return self.search_async(queries, k)()

    batcher = port_http.MicroBatcher(Async(), window_ms=200.0, max_batch=2, pipeline_depth=2)
    out = [batcher.result(s) for s in [batcher.submit(f"q{i}", k=1) for i in range(6)]]
    batcher.close()
    assert out == [[(f"Q{i}", 1.0)] for i in range(6)]
    dispatches = [i for i, (kind, _) in enumerate(events) if kind == "dispatch"]
    collects = [i for i, (kind, _) in enumerate(events) if kind == "collect"]
    assert len(dispatches) == len(collects) == 3 and dispatches[1] < collects[0]


def test_micro_batcher_isolates_a_failed_collect_and_falls_back_to_sync():
    class Async:
        batch_size = 1

        def search_async(self, queries, k=10):
            qs = list(queries)

            def collect():
                if "boom" in qs:
                    raise RuntimeError("collect failed")
                return [[(q, 1.0)] for q in qs]

            return collect

    batcher = port_http.MicroBatcher(Async(), window_ms=1.0, max_batch=1, pipeline_depth=2)
    s1, s2, s3 = (batcher.submit(q, k=1) for q in ("ok1", "boom", "ok2"))
    assert batcher.result(s1) == [("ok1", 1.0)]
    with pytest.raises(RuntimeError, match="collect failed"):
        batcher.result(s2)
    assert batcher.result(s3) == [("ok2", 1.0)]
    batcher.close()

    class Sync:
        search_async = None
        batch_size = 4

        def search(self, queries, k=10):
            return [[(q, 1.0)] for q in queries]

    batcher = port_http.MicroBatcher(Sync(), window_ms=1.0)
    assert batcher.pipeline_depth == 1 and batcher.search("x", k=1) == [("x", 1.0)]
    batcher.close()


def test_micro_batcher_close_drains_inflight():
    class Slow:
        batch_size = 1

        def search_async(self, queries, k=10):
            qs = list(queries)

            def collect():
                time.sleep(0.05)
                return [[(q, 1.0)] for q in qs]

            return collect

    batcher = port_http.MicroBatcher(Slow(), window_ms=1.0, max_batch=1, pipeline_depth=4)
    slots = [batcher.submit(f"q{i}", k=1) for i in range(4)]
    batcher.close()
    assert [batcher.result(s) for s in slots] == [[(f"q{i}", 1.0)] for i in range(4)]


class Stalls:
    """Dispatches numbered from 0; those in ``stalled`` hang until released."""

    batch_size = 1

    def __init__(self, stalled, fail=()):
        self.stalled, self.fail = set(stalled), set(fail)
        self.release = threading.Event()
        self.dispatches = []

    def search_async(self, queries, k=10):
        qs = list(queries)
        n = len(self.dispatches)
        self.dispatches.append(tuple(qs))

        def collect():
            if n in self.stalled:
                self.release.wait(30.0)
            if n in self.fail:
                raise RuntimeError("transient transport error")
            return [[(q.upper(), float(k))] for q in qs]

        return collect


def warm(batcher, n=8):
    for i in range(n):  # the rolling median needs 8 samples before a hedge deadline exists
        assert batcher.search(f"warm{i}", k=1) == [(f"WARM{i}", 1.0)]


def test_micro_batcher_hedges_a_stalled_collect():
    svc = Stalls(stalled={8})
    batcher = port_http.MicroBatcher(svc, window_ms=0.0, max_batch=1, pipeline_depth=1, hedge_factor=3.0,
                                     hedge_floor_ms=30.0)
    warm(batcher)
    t0 = time.monotonic()
    assert batcher.search("stalled", k=1) == [("STALLED", 1.0)]
    assert time.monotonic() - t0 < 5.0
    assert batcher.stats.hedges == batcher.stats.hedge_wins == 1
    assert svc.dispatches[-2:] == [("stalled",), ("stalled",)]
    assert batcher.search("after", k=1) == [("AFTER", 1.0)]
    svc.release.set()
    batcher.close()


def test_more_than_four_stalled_hedge_losers_do_not_stop_serving():
    """Six batches whose primaries stall for good: each is rescued by its
    hedge, and serving goes on; the JAX package's fixed 4-worker pool would
    queue the fifth primary behind four stuck losers and spin forever."""
    stalled = {8, 10, 12, 14, 16, 18}
    svc = Stalls(stalled=stalled)
    batcher = port_http.MicroBatcher(svc, window_ms=0.0, max_batch=1, pipeline_depth=1, hedge_factor=3.0,
                                     hedge_floor_ms=30.0)
    warm(batcher)
    t0 = time.monotonic()
    for i in range(len(stalled)):
        assert batcher.search(f"s{i}", k=1) == [(f"S{i}", 1.0)]
    assert time.monotonic() - t0 < 10.0
    assert batcher.stats.hedges == batcher.stats.hedge_wins == len(stalled)
    assert sum(t.name == "capreolus-hedge-leg" for t in threading.enumerate()) >= len(stalled)  # the losers
    assert batcher.search("after", k=1) == [("AFTER", 1.0)]
    svc.release.set()
    batcher.close()


def test_hedge_prefers_the_successful_leg():
    svc = Stalls(stalled={8}, fail={9})
    batcher = port_http.MicroBatcher(svc, window_ms=0.0, max_batch=1, pipeline_depth=1, hedge_factor=3.0,
                                     hedge_floor_ms=30.0)
    warm(batcher)
    threading.Timer(0.3, svc.release.set).start()
    assert batcher.search("rescued", k=1) == [("RESCUED", 1.0)]
    assert batcher.stats.hedges == 1 and batcher.stats.errors == 0
    batcher.close()


def test_serving_stats_snapshot_matches_jax():
    got, want = port_http.ServingStats(), jax_http.ServingStats()
    for stats in (got, want):
        for i in range(20):
            stats.record_batch(1 + i % 3, 0.001 * (i + 1), 0.0005 * (i + 1))
        stats.record_error()
        stats.record_hedge(backup_won=True)
    assert got.snapshot() == want.snapshot()
    assert got.service_p50() == want.service_p50()


# ---------------------------------------------------------------- the HTTP server
def test_http_roundtrip_matches_jax(servers):
    jax_server, port_server = servers
    for server in servers:
        assert server.get("/health") == {"ok": True, "corpus_size": 3}
    for body in ({"queries": ["galaxies collide"], "k": 2}, {"queries": QUERIES, "k": 3},
                 {"queries": ["galaxies collide"], "k": None}, {"queries": ["orbit telescope launch"], "k": 2,
                                                                "snippets": True}):
        got, want = port_server.post("/search", body), jax_server.post("/search", body)
        assert got[0] == 200 and got[1]["results"][0]
        assert json.dumps(got[1]) == json.dumps(want[1]) or _close(got[1], want[1])
    assert port_server.get("/document?docid=D003") == jax_server.get("/document?docid=D003")
    for body in (b"{}", b"[1]", b'{"queries": "x"}'):
        assert port_server.post("/search", body)[0] == jax_server.post("/search", body)[0] == 400
    assert port_server.post("/nope", {})[0] == 404
    stats = port_server.get("/stats")
    assert stats["queries"] >= 6 and stats["batches"] >= 1 and stats["errors"] == 0
    assert stats["batch_latency_ms"]["p99"] >= stats["batch_latency_ms"]["p50"] > 0


def _close(got, want):
    """The same docids and snippets; scores within 1e-6 relative (BM25 scores
    are not bit-identical to the JAX CPU engine's; rankings are)."""
    assert got.keys() == want.keys()
    assert got.get("snippets") == want.get("snippets")
    for a, b in zip(got["results"], want["results"]):
        assert [d for d, _ in a] == [d for d, _ in b]
        assert all(abs(x - y) <= 1e-6 * max(1.0, abs(y)) for (_, x), (_, y) in zip(a, b))
    return True


def test_http_refresh_serves_the_new_generation(servers):
    _, port_server = servers
    svc = port_server.server.batcher.service
    svc.index.add_documents([("NEW1", "zebra stampede across the savanna")])
    code, out = port_server.post("/refresh", b"")
    assert code == 200 and out == {"refreshed": True, "generation": 1, "corpus_size": 4}
    assert port_server.post("/search", {"queries": ["zebra stampede"], "k": 3})[1]["results"][0][0][0] == "NEW1"
    assert port_server.post("/refresh", b"")[1]["refreshed"] is False
    svc.index.delete_documents(["NEW1"])
    assert port_server.post("/refresh", b"")[1] == {"refreshed": True, "generation": 2, "corpus_size": 3}
    assert port_server.post("/search", {"queries": ["zebra stampede"], "k": 3})[1]["results"] == [[]]


def test_health_reports_the_corpus_of_every_service(tmpdir_as_cache, torch_cache):
    encoder = dict(allowrandominit=True, maxdoclen=32, maxqlen=8, batch=4, tokenizer=OFFLINE_TOKENIZER)
    sparse = port_serving.RetrievalService.from_config(collection="dummy", device="cpu")
    dense = port_serving.DenseRetrievalService.from_config(collection="dummy", device="cpu", **encoder)
    services = [sparse, dense,
                port_serving.ColbertRetrievalService.from_config(collection="dummy", device="cpu", dim=8, **encoder),
                port_serving.ImpactRetrievalService.from_config(collection="dummy", device="cpu", **encoder),
                port_serving.HybridRetrievalService(sparse, dense)]
    for svc in services:
        server = Server(port_http, svc)
        try:
            assert server.get("/health") == {"ok": True, "corpus_size": 3}, type(svc).__name__
            code, out = server.post("/search", {"queries": QUERIES, "k": 2, "snippets": True})
            assert code == 200 and out["results"] == [[[d, s] for d, s in h] for h in svc.search(QUERIES, k=2)]
            assert out["snippets"] == [svc.snippets(q, h) for q, h in zip(QUERIES, svc.search(QUERIES, k=2))]
            code, out = server.post("/refresh", b"")
            if isinstance(svc, port_serving.HybridRetrievalService):  # as JAX's: its legs refresh
                assert code == 400 and out == {"error": "service does not support refresh"}
            else:
                assert code == 200 and out["refreshed"] is False
        finally:
            server.close()
    assert services[-1].batch_size == 4


def test_concurrent_clients_coalesce_and_get_their_own_results(torch_cache):
    svc = port_serving.RetrievalService.from_config(collection="dummy", device="cpu")
    server = Server(port_http, svc)
    want = {q: svc.search([q], k=3)[0] for q in QUERIES}
    results = {}

    def client(i):
        q = QUERIES[i % len(QUERIES)]
        results[i] = (q, server.post("/search", {"queries": [q], "k": 3})[1]["results"][0])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.close()
    assert all(hits == [[d, s] for d, s in want[q]] for q, hits in results.values()) and len(results) == 24


def test_verdict_store_survives_concurrent_mutation_and_flush(tmp_path):
    """The pruning verdict store is mutated and flushed from several threads
    (a hedge's backup dispatch beside a collect): every change goes under the
    engine's lock and a flush dumps a snapshot, so none raises and none is lost."""
    import numpy as np

    from capreolus_tpu_torch.index.tpu import IndexData
    from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

    data = IndexData(term_offsets=np.array([0, 2]), doc_ids=np.array([0, 1], np.int32), tfs=np.array([1, 2], np.int32),
                     doclens=np.array([3, 4], np.int32), norm_doclens=np.array([3, 4], np.int32),
                     docid_strings=["a", "b"], vocab={"t": 0})
    data.verdict_path = str(tmp_path / "verdicts.json")
    engine = ScoringEngine(DeviceIndex(data, device="cpu"))
    errors = []

    def writer(t):
        try:
            for i in range(40):
                engine._store_verdict_entry("stream", (t * 100 + i, 0.9, 0.4), {"verdict": bool(i % 2), "n": i})
        except Exception as e:  # noqa: BLE001 - the assertion below reports it
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    on_disk = json.loads((tmp_path / "verdicts.json").read_text())
    assert len(on_disk) == 6 * 40


def test_main_takes_a_device_and_defaults_to_the_card(monkeypatch, torch_cache):
    made = {}

    class FakeServer:
        server_address = ("127.0.0.1", 0)

        def __init__(self, service):
            self.batcher = port_http.MicroBatcher(service)
            made["service"] = service

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            made["shutdown"] = True

        def server_close(self):
            pass

    monkeypatch.setattr(port_http, "make_server", lambda service, host, port: FakeServer(service))
    port_http.main(["--collection", "dummy", "--device", "cpu"])
    assert made["service"].device == torch.device("cpu") and made["shutdown"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_http.main(["--collection", "dummy"])
