"""The PyTorch port's exact scoring engine against the JAX engine, on the CPU.

Same corpus, same queries: the doc ordinals must be IDENTICAL (Lucene's
ascending-ordinal tie-break included) for all eight scoring models and for a
parameter grid. Scores agree within rtol 1e-6: both sides compute in f32 with
the same op order, but XLA's CPU backend fuses multiply-adds into FMAs, folds
divisions by constants and has its own log/pow, which moves single scores by a
few ulp. An atol of 1e-7 covers the QL/DFR family, whose per-term score is a
difference of two logs of order 1: a small score keeps their absolute rounding
(about 1e-7), not a relative one.

SPL is the exception to identical ordinals: its score -log((lam^x - lam) /
(1 - lam)) cancels most digits of lam^x, so one ulp of difference between
XLA's and torch's f32 log1p / pow becomes up to about 1.3e-5 relative in the score (measured on this corpus).
Documents whose SPL scores lie that close may swap; the test allows a swap
only between ranks whose scores agree within SPL_RTOL on both sides.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu.searcher.scoring import DeviceIndex as JaxDeviceIndex  # noqa: E402
from capreolus_tpu.searcher.scoring import ScoringEngine as JaxEngine  # noqa: E402
from capreolus_tpu_torch.core import constants as torch_constants  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402
from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine  # noqa: E402
# sibling test modules are imported under the names pytest gives them (tests/
# is on sys.path): a second copy of a module that registers modules at import
# (test_e2e_golden's collection reads its own module state) would replace them
from test_bm25_bruteforce import brute_force_bm25  # noqa: E402
from test_torch_index import write_trec_corpus  # noqa: E402

MODEL_PARAMS = {
    "bm25": {"k1": 0.9, "b": 0.4},
    "impact": {},
    "qld": {"mu": 1000.0},
    "qljm": {"lam": 0.1},
    "inl2": {"c": 1.0},
    "spl": {"c": 1.0},
    "f2exp": {"s": 0.5},
    "f2log": {"s": 0.5},
}
QUERIES = ["galaxy telescope", "whale ocean gravity", "running w3 w3 w17", "orbit launch hopeful w1",
           "the whale's computation", "zebra w250 w299", "nothingmatcheshere", "w0 w1 w2 w4 w5 w6"]
SCORE_RTOL = 1e-6
SCORE_ATOL = 1e-7
SPL_RTOL = 1e-4


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both packages' engines over one ~2k-doc TREC corpus (module-scoped build)."""
    base = tmp_path_factory.mktemp("torch_scoring")
    docs = write_trec_corpus(base / "corpus", num_docs=2000, seed=11)
    saved_jax, saved_torch = jax_constants["CACHE_BASE_PATH"], torch_constants["CACHE_BASE_PATH"]
    jax_constants["CACHE_BASE_PATH"] = base / "jax_cache"
    torch_constants["CACHE_BASE_PATH"] = base / "torch_cache"
    try:
        cfg = {"collection": {"name": "dummy", "path": str(base / "corpus")}}
        jax_index, torch_index = JaxIndex.create("tpu", cfg), TorchIndex.create("tpu", cfg)
        term_lists = []
        vocab = torch_index.data.vocab
        for q in QUERIES:
            terms = torch_index.analyze(q)
            term_lists.append([(vocab[t], float(terms.count(t))) for t in dict.fromkeys(terms) if t in vocab])
        yield {
            "jax": JaxEngine(JaxDeviceIndex(jax_index.data)),
            "torch": ScoringEngine(DeviceIndex(torch_index.data, device="cpu")),
            "term_lists": term_lists,
            "index": torch_index,
            "docs": docs,
        }
    finally:
        jax_constants["CACHE_BASE_PATH"] = saved_jax
        torch_constants["CACHE_BASE_PATH"] = saved_torch


def _assert_same_results(jax_out, torch_out):
    (js, jo), (ts, to) = jax_out, torch_out
    assert ts.shape == js.shape and to.shape == jo.shape
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL, atol=SCORE_ATOL, equal_nan=True)


def _assert_same_up_to_near_ties(jax_out, torch_out, rtol):
    (js, jo), (ts, to) = jax_out, torch_out
    assert ts.shape == js.shape and to.shape == jo.shape
    # rank by rank the scores agree, so a swapped pair holds near-equal scores
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=SCORE_ATOL, equal_nan=True)
    # and each document keeps its score: a swap moves two near-equal scores
    for q in range(jo.shape[0]):
        jmap = dict(zip(jo[q].tolist(), js[q].tolist()))
        for o, s in zip(to[q].tolist(), ts[q].tolist()):
            if o in jmap:
                assert s == pytest.approx(jmap[o], rel=rtol, abs=SCORE_ATOL, nan_ok=True), (q, o)


@pytest.mark.parametrize("model", sorted(MODEL_PARAMS))
def test_exact_engine_matches_jax(engines, model):
    params = MODEL_PARAMS[model]
    jax_out = engines["jax"].search(engines["term_lists"], model=model, params=params, topk=1000,
                                    exact_topk=True)
    torch_out = engines["torch"].search(engines["term_lists"], model=model, params=params, topk=1000)
    if model == "spl":
        _assert_same_up_to_near_ties(jax_out, torch_out, SPL_RTOL)
    else:
        _assert_same_results(jax_out, torch_out)


@pytest.mark.parametrize("model,grid", [("bm25", {"k1": [0.9, 1.2], "b": [0.4, 0.8]}),
                                        ("qld", {"mu": [500.0, 1000.0, 2500.0]})])
def test_parameter_grid_matches_jax(engines, model, grid):
    jax_out = engines["jax"].search(engines["term_lists"], model=model, grid=grid, topk=200, exact_topk=True)
    torch_out = engines["torch"].search(engines["term_lists"], model=model, grid=grid, topk=200)
    assert torch_out[0].shape == tuple(len(grid[k]) for k in sorted(grid)) + (len(QUERIES), 200)
    _assert_same_results(jax_out, torch_out)


def test_grid_point_equals_single_search(engines):
    grid = {"k1": [0.9, 1.2], "b": [0.4, 0.8]}
    scores, ords = engines["torch"].search(engines["term_lists"], model="bm25", grid=grid, topk=50)
    single_s, single_o = engines["torch"].search(engines["term_lists"], model="bm25",
                                                 params={"k1": 1.2, "b": 0.4}, topk=50)
    # axes are (b, k1) in sorted-name order
    np.testing.assert_array_equal(ords[0, 1], single_o)
    np.testing.assert_array_equal(scores[0, 1], single_s)


def test_exact_engine_matches_bruteforce_referee(engines):
    """The JAX suite's independent float64 BM25 referee, by import."""
    index = engines["index"]
    analyzer = index._analyzer()
    docs_tokens = {docid: analyzer.analyze(text) for docid, text in engines["docs"]}
    docids = index.data.docid_strings
    scores, ords = engines["torch"].search(engines["term_lists"], model="bm25",
                                           params={"k1": 1.2, "b": 0.75}, topk=len(docids))
    for qi, query in enumerate(QUERIES):
        expected = brute_force_bm25(docs_tokens, analyzer.analyze(query), k1=1.2, b=0.75)
        got = {docids[o]: float(s) for s, o in zip(scores[qi], ords[qi]) if s > 0}
        assert set(got) == set(expected), query
        for docid, score in expected.items():
            assert got[docid] == pytest.approx(score, rel=1e-4), (query, docid)


def test_edge_cases(engines):
    engine = engines["torch"]
    scores, ords = engine.search([], model="bm25", params=MODEL_PARAMS["bm25"], topk=10)
    assert scores.shape == (0, 10) and ords.shape == (0, 10)
    # no query term in the vocabulary: all-zero scores, ordinals in index order
    scores, ords = engine.search([[]], model="bm25", params=MODEL_PARAMS["bm25"], topk=5)
    assert (scores == 0).all() and ords.tolist() == [[0, 1, 2, 3, 4]]
    # topk beyond the corpus is clipped to N
    scores, _ = engine.search(engines["term_lists"][:1], model="bm25", params=MODEL_PARAMS["bm25"], topk=10**6)
    assert scores.shape == (1, engine.dindex.num_docs)
    # exact_topk=False takes the tiered path: the exact path's ranking over the matching docs
    ts, to = engine.search(engines["term_lists"], model="bm25", params=MODEL_PARAMS["bm25"], topk=100,
                           exact_topk=False)
    es, eo = engine.search(engines["term_lists"], model="bm25", params=MODEL_PARAMS["bm25"], topk=100)
    valid = ts > 0
    assert (valid == (es > 0)).all() and valid.any()
    np.testing.assert_array_equal(to[valid], eo[valid])
    np.testing.assert_allclose(ts[valid], es[valid], rtol=1e-5)
    with pytest.raises(ValueError):
        engine.search(engines["term_lists"], model="bm99")
    with pytest.raises(ValueError):  # flat accumulator index must stay within int32
        engine._check_accumulator_bounds(2**31 // engine.dindex.num_docs + 1)
