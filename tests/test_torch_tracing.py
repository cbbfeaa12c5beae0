"""The port's spans (``capreolus_tpu_torch/utils/tracing.py``) on the CPU:
nothing is built while no profile records; under ``torch.profiler`` each span
is a ``user_annotation`` event nested in its parent; the services and the
trainer step name their parts; the MicroBatcher reports each query's wait."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import capreolus_tpu_torch

capreolus_tpu_torch.load_all_modules()

from capreolus_tpu_torch import serving_http  # noqa: E402
from capreolus_tpu_torch.utils import tracing  # noqa: E402
from capreolus_tpu_torch.utils.tracing import TimedSpan, span  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401


def recording():
    """The flag ``span`` reads: whether a ``torch.profiler`` profile records."""
    return torch.autograd.profiler._is_profiler_enabled


def spans_of(path):
    """The trace's ``user_annotation`` events: [(name, start_us, end_us)] by start."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e.get("ph") == "X"), key=lambda s: (s[1], -s[2]))


def traced(fn, tmp_path):
    """(fn()'s result, the spans it recorded) under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return result, spans_of(path)


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def names(spans, prefix=""):
    return [name for name, _, _ in spans if name.startswith(prefix)]


def test_no_profile_builds_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function built with no profile recording")

    monkeypatch.setattr(tracing, "record_function", refuse)
    assert not recording()
    ran = []
    with span("a"), span("b"):
        ran.append(1)
    timed = TimedSpan("c")
    with timed:
        ran.append(2)
    with timed:
        ran.append(3)
    assert ran == [1, 2, 3] and timed.seconds >= timed.stop - timed.start > 0
    assert span("a") is span("b")  # one shared no-op: nothing kept per span


def test_nested_spans_are_user_annotations_inside_their_parent(tmp_path):
    def work():
        assert recording()
        with span("outer"):
            with span("inner"):
                time.sleep(0.002)
            with TimedSpan("timed") as t:
                time.sleep(0.002)
        return t

    t, spans = traced(work, tmp_path)
    by = {s[0]: s for s in spans}
    assert names(spans) == ["outer", "inner", "timed"]
    assert inside(by["inner"], by["outer"]) and inside(by["timed"], by["outer"])
    assert by["inner"][2] <= by["timed"][1]
    # the host clock's reading lies inside the profiler's event (microseconds, rounded)
    assert 0.0015 < t.seconds and t.seconds * 1e6 <= by["timed"][2] - by["timed"][1] + 50


def test_the_trainers_profile_option_records_spans(tmp_path):
    from capreolus_tpu_torch.trainer.torch_trainer import TorchTrainer

    profiler = TorchTrainer._start_profile(torch.device("cpu"))
    with span("trainer.step"):
        pass
    TorchTrainer._stop_profile(profiler, tmp_path / "profile")
    assert names(spans_of(tmp_path / "profile" / "trace.json")) == ["trainer.step"]
    assert not recording()


@pytest.fixture
def tiny_bert(torch_cache, tmp_path):
    from chip_smoke import seeded_bert_params
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.serving import RerankingService

    ckpt = save_params(seeded_bert_params(get_bert_config("tiny"), seed=4, std=0.05), tmp_path / "bert.npz")
    reranker = Reranker.create("BERTMaxP", {"pretrained": "tiny", "trainer": {"batch": 2}})
    return RerankingService(Index.create("tpu", {"collection": {"name": "dummy"}}), reranker, str(ckpt), topn=3,
                            device="cpu")


def test_reranking_service_spans_and_the_passage_cache(tiny_bert, tmp_path):
    svc = tiny_bert
    query = "galaxies collide"
    first, spans = traced(lambda: svc.search([query], k=3), tmp_path)
    stages = dict(svc.last_stage_ms)
    candidates = first_stage_candidates(svc, query)
    assert first[0] and len(candidates) >= 2
    assert names(spans, "features.inputs") == ["features.inputs"] * len(candidates)
    assert names(spans, "features.doc_tokens") == ["features.doc_tokens"] * len(set(candidates))
    inputs = [s for s in spans if s[0] == "features.inputs"]
    assert all(any(inside(d, i) for i in inputs) for d in spans if d[0] == "features.doc_tokens")
    by = {s[0]: s for s in spans}
    for child in ("features.query", "features.collate"):
        assert inside(by[child], by["rerank.features"])
    for child in ("rerank.features", "rerank.model", "rerank.sort"):
        assert inside(by[child], by["rerank.stage"])
    assert names(spans, "rerank.first_stage") == ["rerank.first_stage"] * 2
    assert names(spans, "search.") == ["search.analyze", "search.score", "search.fetch", "search.hits"]
    assert any(inside(s, by["rerank.model"]) for s in spans if s[0] == "reranker.inputs")
    assert set(stages) == {"first_stage", "rerank", "features"} and 0 < stages["features"] <= stages["rerank"]
    assert stages["features"] * 1e3 <= by["rerank.features"][2] - by["rerank.features"][1] + 50

    second, spans = traced(lambda: svc.search([query], k=3), tmp_path)
    assert second == first
    assert names(spans, "features.doc_tokens") == []
    assert names(spans, "features.inputs") == ["features.inputs"] * len(candidates)
    assert set(svc.last_stage_ms) == {"first_stage", "rerank", "features"}


def first_stage_candidates(svc, query):
    """The first stage's candidates of ``query``, as the rerank stage sees them."""
    from capreolus_tpu_torch.serving import RetrievalService

    return [d for d, _ in RetrievalService.search(svc, [query], k=svc.topn)[0]]


def test_colbert_service_request_gives_each_search_span_once(torch_cache, tmp_path):
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    svc = ColbertRetrievalService.from_config(
        collection="dummy", max_k=3, device="cpu", allowrandominit=True, dim=8, maxdoclen=32, maxqlen=8, batch=4,
        tokenizer={"pretrained": "definitely-not-a-real-model-xyz"})
    queries = ["telescope galaxies", "whales in the ocean", "galaxies collide"]
    untraced = svc.search(queries, k=3)
    traced_hits, spans = traced(lambda: svc.search(queries, k=3), tmp_path)
    assert traced_hits == untraced and all(len(h) == 3 for h in untraced)
    assert names(spans, "search.") == ["search.tokenize", "search.encode", "search.score", "search.fetch",
                                       "search.hits"]


def test_a_train_step_spans_its_inputs_forward_backward_and_optimizer(tiny_bert, tmp_path):
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    svc = tiny_bert
    reranker, trainer = svc.reranker, svc.reranker.trainer
    model = reranker.model
    svc.rerank_batch("q", "galaxies collide", ["D001"])  # the live query's tokens
    samples = [reranker.extractor.id2vec("q", d, negid=n, label=[1, 0]) for d, n in (("D001", "D002"),
                                                                                   ("D003", "D002"))]
    batches = {k: np.asarray(v)[None] for k, v in collate(samples, ARRAY_KEYS).items()}
    optimizer = trainer.make_optimizer(reranker, model)
    loss, spans = traced(lambda: trainer.train_step(reranker, model, optimizer, batches, 0,
                                                    trainer.step_seed(0, 0)), tmp_path)
    assert torch.isfinite(loss)
    step = [s for s in spans if s[0] == "trainer.step"]
    assert len(step) == 1
    held = [s for s in spans if s[0] != "trainer.step"]
    assert all(inside(s, step[0]) for s in held)
    assert names(held, "trainer.") == ["trainer.forward", "trainer.backward", "trainer.optimizer"]
    by = {s[0]: s for s in held}
    puts = [s for s in held if s[0] == "reranker.inputs"]
    assert len(puts) == 6 and all(inside(p, by["trainer.forward"]) for p in puts)
    assert by["trainer.forward"][2] <= by["trainer.backward"][1] <= by["trainer.optimizer"][1]


def test_serving_stats_report_the_queue_wait():
    stats = serving_http.ServingStats(maxlen=4)
    assert "queue_wait_ms" not in stats.snapshot()
    stats.record_queue_waits([0.001, 0.002, 0.003])
    stats.record_queue_waits([0.004, 0.010])  # a ring of the last 4
    wait = stats.snapshot()["queue_wait_ms"]
    assert wait == {"p50": 4.0, "p90": 10.0, "p99": 10.0, "max": 10.0}


class Echo:
    batch_size = 8

    def search(self, queries, k=10):
        return [[(q, 1.0)] for q in queries]


def test_the_microbatcher_records_each_querys_wait_for_its_batch():
    window_ms = 100.0
    batcher = serving_http.MicroBatcher(Echo(), window_ms=window_ms, max_batch=8)
    try:
        slots = [batcher.submit(f"q{i}", k=1) for i in range(3)]
        assert [batcher.result(s) for s in slots] == [[(f"q{i}", 1.0)] for i in range(3)]
        stats = batcher.stats.snapshot()
    finally:
        batcher.close()
    wait = stats["queue_wait_ms"]
    # each query waited out (most of) its batch's window, and not much more
    assert stats["queries"] == 3 and stats["errors"] == 0
    assert 0.5 * window_ms <= wait["p50"] <= wait["max"] < 10 * window_ms


def _hits_by_loop(scores, ords, docids, stop_at_zero, limit):
    """Each row's (docid, score) pairs as a plain loop reads them."""
    out = []
    for srow, orow in zip(scores, ords):
        hits = []
        for s, o in zip(srow, orow):
            if stop_at_zero and s <= 0.0:
                break
            if int(o) >= limit or not np.isfinite(s):
                continue
            hits.append((docids[int(o)], float(s)))
        out.append(hits)
    return out


@pytest.mark.parametrize("kind", ["positive_prefix", "impact", "embedding"])
def test_hit_lists_keep_rank_order_and_each_services_filter(kind, tmp_path):
    from capreolus_tpu_torch.serving import _hit_lists, _positive_prefix

    rng = np.random.default_rng(7)
    scores = -np.sort(-rng.normal(size=(3, 12)).astype(np.float32), axis=1)
    scores[:, -1] = -np.inf
    ords = rng.integers(0, 12, size=(3, 12))
    docids = [f"d{i}" for i in range(10)]
    if kind == "positive_prefix":
        ords = ords % 10
        keep, stop, limit = _positive_prefix, True, 10
    elif kind == "impact":
        keep, stop, limit = (lambda s, o: _positive_prefix(s, o) & (o < 10)), True, 10
    else:
        keep, stop, limit = (lambda s, o: (o < 8) & np.isfinite(s)), False, 8
    got, recorded = traced(lambda: _hit_lists([(2, scores[:2], ords[:2]), (1, scores[2:], ords[2:])], docids, keep),
                           tmp_path)
    assert got == _hits_by_loop(scores, ords, docids, stop, limit)
    assert names(recorded, "search.") == ["search.hits"]
