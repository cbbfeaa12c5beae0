"""The per-layer metrics that read the program's spans (``lib/spans.py``),
from hand-made traces whose host ops are nested spans: means over the
window's finished requests or steps, self time, the passage cache's hit
share, 0.0 where the parents ran without children, None where no parent ran,
and nothing outside the window."""

from types import SimpleNamespace

import pytest

from lib import registry
from lib.spans import Spans
from lib.trace import Trace

WINDOW = (1_000.0, 101_000.0)  # trace microseconds
NEW = ["hits_ms", "doc_tokens_ms", "bert_inputs_ms", "collate_ms", "passage_cache_hits", "step_inputs_ms"]


def run_of(host_ops, requests=2):
    host_ops = [("gpubench.window", *WINDOW)] + host_ops
    return SimpleNamespace(trace=Trace([], host_ops, WINDOW), finished=[{}] * requests)


def read(name, run):
    return registry.load_module("metrics", name).read(run)


def rerank_request(t, misses):
    """One request's features spans from ``t`` (us): the query, three
    candidates of 1,000 us each (the first ``misses`` with a 600-us cache
    miss inside), the collation; 4,500 us in all."""
    ops = [("rerank.features", t, t + 4_500), ("features.query", t, t + 500)]
    for i in range(3):
        s = t + 500 + 1_000 * i
        ops.append(("features.inputs", s, s + 1_000))
        if i < misses:
            ops.append(("features.doc_tokens", s + 100, s + 700))
            ops.append(("aten::empty", s + 200, s + 300))  # a torch op inside is no child span
    ops.append(("features.collate", t + 3_500, t + 4_500))
    return ops


def test_the_features_metrics_are_means_that_add_up():
    run = run_of(rerank_request(2_000, misses=3) + rerank_request(20_000, misses=1))
    assert read("doc_tokens_ms", run) == pytest.approx((3 + 1) * 0.6 / 2)
    assert read("bert_inputs_ms", run) == pytest.approx((6 * 1.0 - 4 * 0.6) / 2)
    assert read("collate_ms", run) == pytest.approx(1.0)
    assert read("passage_cache_hits", run) == pytest.approx(100.0 * (1 - 4 / 6))
    features_ms = 1e3 * Spans(run.trace).seconds("rerank.features") / 2
    query_ms = 1e3 * Spans(run.trace).seconds("features.query") / 2
    parts = [read(m, run) for m in ("doc_tokens_ms", "bert_inputs_ms", "collate_ms")]
    assert features_ms == pytest.approx(4.5) and query_ms + sum(parts) == pytest.approx(features_ms)


def test_a_warm_passage_cache_reads_zero_misses_and_full_hits():
    run = run_of(rerank_request(2_000, misses=0))
    assert read("doc_tokens_ms", run) == 0.0 and read("passage_cache_hits", run) == 100.0
    assert read("bert_inputs_ms", run) == pytest.approx(3.0 / 2)


def test_hits_and_step_inputs():
    serve = run_of([("search.score", 2_000, 2_400), ("search.fetch", 3_000, 3_100), ("search.hits", 3_100, 4_100),
                    ("search.score", 5_000, 5_400), ("search.hits", 6_000, 6_500)], requests=2)
    assert read("hits_ms", serve) == pytest.approx(0.75)
    steps = []
    for t in (2_000, 12_000, 22_000):
        steps += [("trainer.step", t, t + 9_000), ("trainer.forward", t, t + 4_000)]
        steps += [("reranker.inputs", t + 100 * i, t + 100 * i + 50) for i in range(6)]
    steps.append(("reranker.inputs", 40_000, 40_500))  # outside any step: the reference's own copies
    assert read("step_inputs_ms", run_of(steps, requests=3)) == pytest.approx(6 * 0.05)


def test_zero_where_parents_ran_without_children():
    assert read("hits_ms", run_of([("search.score", 2_000, 2_400)])) == 0.0
    assert read("step_inputs_ms", run_of([("trainer.step", 2_000, 9_000)])) == 0.0
    features = run_of([("rerank.features", 2_000, 3_000)])
    for name in ("doc_tokens_ms", "bert_inputs_ms", "collate_ms"):
        assert read(name, features) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_none_where_no_parent_ran(name):
    assert read(name, run_of([("gpubench.collect", 2_000, 9_000), ("aten::mm", 2_100, 2_200)])) is None
    assert read(name, SimpleNamespace(trace=None, finished=[{}])) is None


@pytest.mark.parametrize("name", NEW)
def test_spans_outside_the_window_are_not_counted(name):
    warm = rerank_request(-20_000, misses=3) + [("search.score", -9_000, -8_000), ("search.hits", -8_000, -7_000),
                                                ("trainer.step", -6_000, -1_000), ("reranker.inputs", -5_000, -4_000)]
    assert read(name, run_of(warm)) is None
    straddling = [("search.score", 500, 1_500), ("search.hits", 900, 1_200), ("trainer.step", 100_500, 102_000),
                  ("reranker.inputs", 100_600, 100_700)] + rerank_request(100_000, misses=1)
    assert read(name, run_of(straddling)) is None


EXPECTED = {  # name: (unit, better, source, layer, moves, workloads)
    "hits_ms": ("ms", "lower", "program_span", "service", "queries_per_s", ["colbert-bf16-b64", "colbert-int8-b64"]),
    "doc_tokens_ms": ("ms", "lower", "program_span", "features", "queries_per_s.rerank", ["maxp-int8-rerank"]),
    "bert_inputs_ms": ("ms", "lower", "program_span", "features", "queries_per_s.rerank", ["maxp-int8-rerank"]),
    "collate_ms": ("ms", "lower", "program_span", "features", "queries_per_s.rerank", ["maxp-int8-rerank"]),
    "passage_cache_hits": ("%", "higher", "program_counter", "features", "queries_per_s.rerank",
                           ["maxp-int8-rerank"]),
    "step_inputs_ms": ("ms", "lower", "program_span", "trainer inputs, traced only: copies without their wait",
                       "train_samples_per_s", ["maxp-train"]),
}


@pytest.mark.parametrize("name", NEW)
def test_the_new_metrics_are_in_the_benchmark_with_their_cells(bench, name):
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert name in entries
    m = entries[name]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == EXPECTED[name]
