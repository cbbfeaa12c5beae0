"""Slice 8 as a whole: the PyTorch port's ``rank.searcheval`` on the CPU over
the JAX suite's 50k-doc golden corpus (``tests/test_e2e_golden.py``), against
PARITY.md's five pins and that suite's float64 brute-force referee.

- MAP and nDCG@20 of BM25, QLDirichlet, BM25RM3, SDM and fusion (RRF of BM25
  and QLDirichlet) within 2e-3 of PARITY.md:86-92, the golden's own tolerance
  (f32 sums against the f64 referee swap adjacent same-grade docs);
- BM25 and QLDirichlet within 2e-3 of the referee's metrics, and BM25's top-50
  order per query equal to the referee's (Lucene's docid tie-break included);
- ``chip_smoke.golden_corpus`` is that suite's corpus: equal docs, topics and
  qrels, so the card's phase 8 runs on it.

One module-scoped corpus; the plain index is shared by BM25, QLDirichlet,
BM25RM3 and fusion, the positional one is built once for SDM.
"""

import pytest
import torch

import capreolus_tpu_torch

capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402
from capreolus_tpu_torch.task import Task  # noqa: E402
from capreolus_tpu_torch.utils.trec import load_trec_run  # noqa: E402
from chip_smoke import golden_corpus, register_golden, write_golden  # noqa: E402
# imported under the name pytest gives the module (tests/ is on sys.path), so its
# JAX collection and module state are the ones its own tests use
from test_e2e_golden import GOLDEN, TOL, _build_corpus, _referee_metrics, _referee_run  # noqa: E402


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden corpus written as the JAX suite writes it, registered as the
    port's ``e2e_golden`` collection and benchmark; the port's caches and
    results (and the referee's JAX analyzer cache) under the module's tmpdir."""
    base = tmp_path_factory.mktemp("torch_rank_golden")
    docs, topics, qrels = golden_corpus()
    register_golden(*write_golden(docs, topics, qrels, str(base)), sorted(topics))
    saved = (port_constants["CACHE_BASE_PATH"], port_constants["RESULTS_BASE_PATH"], jax_constants["CACHE_BASE_PATH"])
    port_constants["CACHE_BASE_PATH"], port_constants["RESULTS_BASE_PATH"] = base / "cache", base / "results"
    jax_constants["CACHE_BASE_PATH"] = base / "jax_cache"
    try:
        yield {"docs": docs, "topics": topics, "qrels": qrels}
    finally:
        port_constants["CACHE_BASE_PATH"], port_constants["RESULTS_BASE_PATH"], jax_constants["CACHE_BASE_PATH"] = saved


def searcheval(searcher):
    """(cross-validated metrics, the first run file) of the port's rank.searcheval on the CPU."""
    task = Task.create("rank", {"benchmark": {"name": "e2e_golden"}, "searcher": searcher})
    task.device = "cpu"
    score = task.searcheval()["score"]
    out = task.get_results_path() / "search"
    run_files = sorted(p for p in out.iterdir() if p.is_file() and p.name.startswith("searcher_"))
    return score, load_trec_run(run_files[0])


def test_chip_smoke_golden_corpus_is_the_jax_suites(golden):
    docs, topics, qrels = _build_corpus()
    assert golden["docs"] == docs
    assert golden["topics"] == topics
    assert golden["qrels"] == qrels


@pytest.mark.parametrize("name,model", [("BM25", "bm25"), ("QLDirichlet", "qld")])
def test_exact_searchers_match_the_referee_and_the_pins(golden, name, model):
    score, run = searcheval({"name": name})
    ref_run = _referee_run(golden, model)
    ref = _referee_metrics(ref_run, golden["qrels"])
    for metric in ("map", "ndcg_cut_20"):
        assert score[metric] == pytest.approx(ref[metric], abs=TOL), (metric, score[metric], ref[metric])
        assert score[metric] == pytest.approx(GOLDEN[name][metric], abs=TOL), (metric, score[metric])
    if name == "BM25":  # the run file's order, score desc then docid asc, against the referee's
        for qid, ranked in ref_run.items():
            got = sorted(run[qid].items(), key=lambda kv: (-kv[1], kv[0]))[:50]
            assert [d for d, _ in got] == [d for d, _ in ranked[:50]], f"top-50 order differs for {qid}"


@pytest.mark.parametrize("name", ["BM25RM3", "SDM", "fusion"])
def test_composed_searchers_match_the_pins(golden, name):
    searcher = {"name": name}
    if name == "fusion":
        searcher = {"name": "fusion", "searcher1": {"name": "BM25"}, "searcher2": {"name": "QLDirichlet"}}
    score, _ = searcheval(searcher)
    for metric in ("map", "ndcg_cut_20"):
        assert score[metric] == pytest.approx(GOLDEN[name][metric], abs=TOL), (metric, score[metric])
