"""The PyTorch port's exact block-max pruning against the JAX package's, on the
CPU (the counterpart of ``tests/test_block_max.py``).

Exactness contract: pruned results are BIT-IDENTICAL to exhaustive tiered
scoring (ordinals, scores and Lucene's ascending-ordinal tie-break), with the
native span builder and with the numpy one. The host side equals JAX's
exactly: prune tables, thresholds (``compute_theta``), each span builder's
spans and statistics against its JAX counterpart, and the docid reorderings;
the native and numpy builders agree in their statistics within 5% of tiles. The
verdict store is driven under controlled clocks: its probes, persistence, tie
retirement and healing, a verdict settled on one device not read for
another, and flushes from two engines (and many threads) keeping every entry.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.index import reorder as jax_reorder  # noqa: E402
from capreolus_tpu.index import tpu as jax_index_tpu  # noqa: E402
from capreolus_tpu.searcher.scoring import DeviceIndex as JaxDeviceIndex  # noqa: E402
from capreolus_tpu.searcher.scoring import ScoringEngine as JaxEngine  # noqa: E402
from capreolus_tpu_torch.index import reorder as port_reorder  # noqa: E402
from capreolus_tpu_torch.index import tpu as port_index_tpu  # noqa: E402
from capreolus_tpu_torch.searcher import scoring  # noqa: E402
from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine  # noqa: E402
from test_torch_native import jax_native  # noqa: E402,F401 (a fixture)
from test_torch_tiered import corpus  # noqa: E402

PARAMS = {"k1": 0.9, "b": 0.4}
KEY10 = (10, PARAMS["k1"], PARAMS["b"])
CLUSTERED = {"num_docs": 6000, "nnz": 120_000, "clustered": True}


def engine_of(pdata, verdict_path=None):
    pdata.verdict_path = None if verdict_path is None else str(verdict_path)
    return ScoringEngine(DeviceIndex(pdata, "cpu"))


def batches_of(jdata, rng, n_batches, per_batch=8, terms=4, min_df=50):
    cands = np.where(np.diff(jdata.term_offsets) > min_df)[0]
    return [[[(int(t), 1.0) for t in rng.choice(cands, size=terms, replace=False)] for _ in range(per_batch)]
            for _ in range(n_batches)]


def assert_bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def exhaustive(engine, batch, topk=10):
    return engine.search(batch, model="bm25", params=PARAMS, topk=topk, exact_topk=False)


@pytest.fixture(scope="module")
def random_corpus():
    jdata, pdata, rng = corpus(seed=0, num_docs=5000, nnz=100_000)
    cands = np.where(np.diff(jdata.term_offsets) > 30)[0]
    queries = [[(int(t), 1.0) for t in rng.choice(cands, size=n, replace=False)]
               for n in (1, 2, 4, 4, 6, 8) for _ in range(3)]
    return jdata, pdata, queries


@pytest.fixture(scope="module")
def clustered():
    jdata, pdata, rng = corpus(seed=7, **CLUSTERED)
    return jdata, pdata, batches_of(jdata, rng, 1, per_batch=16)[0]


@pytest.mark.parametrize("heavy_df", [1, 200])
def test_prune_tables_equal_jax(random_corpus, heavy_df):
    jdata = random_corpus[0]
    args = (jdata.term_offsets, jdata.doc_ids, jdata.tfs, jdata.norm_doclens, jdata.num_docs)
    ours = port_index_tpu.build_prune_tables(*args, heavy_df=heavy_df)
    ref = jax_index_tpu.build_prune_tables(*args, heavy_df=heavy_df)
    assert sorted(ours) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
        assert np.asarray(ours[name]).dtype == np.asarray(ref[name]).dtype, name
    assert port_index_tpu.pick_range_size(jdata.num_docs) == jax_index_tpu.pick_range_size(jdata.num_docs)


@pytest.mark.parametrize("topk", [10, 100])
def test_theta_equals_jax_and_is_a_lower_bound(random_corpus, topk):
    """compute_theta must equal JAX's and never exceed the true k-th best
    score (otherwise a top-k doc could be pruned)."""
    jdata, pdata, queries = random_corpus
    engine = engine_of(pdata)
    theta = engine.compute_theta(queries, params=PARAMS, topk=topk)
    np.testing.assert_array_equal(theta, JaxEngine(JaxDeviceIndex(jdata)).compute_theta(queries, PARAMS, topk))
    kth = exhaustive(engine, queries, topk)[0][:, topk - 1]
    ok = (theta <= kth + 1e-4) | (theta < 0)
    assert ok.all() and (theta > 0).any(), (theta[~ok], kth[~ok])


@pytest.mark.parametrize("topk", [10, 100])
def test_spans_equal_jax_numpy_spans(clustered, topk, monkeypatch):
    jdata, pdata, queries = clustered
    engine, ref_engine = engine_of(pdata), JaxEngine(JaxDeviceIndex(jdata))
    ours = engine._spans_pruned(queries, "bm25", PARAMS, engine.compute_theta(queries, PARAMS, topk))
    ref = ref_engine._spans_pruned(queries, "bm25", PARAMS, ref_engine.compute_theta(queries, PARAMS, topk))
    assert engine.last_prune_stats == ref_engine.last_prune_stats
    assert (ours is None) == (ref is None)
    if ours is not None:
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    # without the native library, the engine's span builder is the numpy path
    monkeypatch.setenv("CAPREOLUS_NATIVE", "0")
    built = engine._build_prune_spans(queries, "bm25", PARAMS, topk)
    assert (built is None) == (ours is None)
    for a, b in zip(built or (), ours or ()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("topk", [10, 100, 1000])
def test_pruned_bit_identical(random_corpus, clustered, topk):
    for _, pdata, queries in (random_corpus, clustered):
        engine = engine_of(pdata)
        assert_bits_equal(engine.search_pruned(queries, model="bm25", params=PARAMS, topk=topk),
                          exhaustive(engine, queries, topk))
        spans = engine._build_prune_spans(queries, "bm25", PARAMS, topk)
        if spans is not None:  # the explicit pruned pass, whatever the probe decided
            assert_bits_equal(engine.search(queries, params=PARAMS, topk=topk, prune_spans=spans),
                              exhaustive(engine, queries, topk))
        theta = engine.compute_theta(queries, PARAMS, topk)
        assert_bits_equal(engine.search(queries, params=PARAMS, topk=topk, prune_theta=theta),
                          exhaustive(engine, queries, topk))


def test_pruning_drops_tiles_on_the_clustered_corpus(clustered, monkeypatch):
    """On a topically clustered corpus pruning skips lanes AND whole tiles
    while staying bit-identical; the probe leaves a sticky decision. The
    probe's clock is the test's (``FakeTime``, advanced by each scoring call:
    a pruned pass 6 ms, an exhaustive one 10 ms), so its A/B settles a
    verdict whatever the host's load."""
    _, pdata, queries = clustered
    engine = engine_of(pdata)
    ref = exhaustive(engine, queries)
    clock, search = FakeTime(), engine.search

    def ticking_search(*a, **kw):
        clock.t += 0.006 if kw.get("prune_spans") is not None else 0.010
        return search(*a, **kw)

    engine.search = ticking_search
    monkeypatch.setattr(scoring.time, "perf_counter", clock.perf_counter)
    assert_bits_equal(engine.search_pruned(queries, model="bm25", params=PARAMS, topk=10), ref)
    st = engine.last_prune_stats
    assert st["kept_lanes"] < 0.7 * st["total_lanes"], st
    assert st["kept_tiles"] < 0.9 * st["total_tiles"], st
    assert engine._prune_tiles_ok[KEY10] is True
    assert isinstance(engine._prune_effective[KEY10], bool)
    assert_bits_equal(engine.search_pruned(queries, model="bm25", params=PARAMS, topk=10), ref)


@pytest.mark.parametrize("mode", ["terms", "bp"])
def test_docreorder_ordinals_equal_jax(mode):
    jdata, _, _ = corpus(seed=7, num_docs=3000, nnz=40_000, clustered=True)
    term_ids = np.repeat(np.arange(jdata.num_terms), np.diff(jdata.term_offsets)).astype(np.int64)
    shuffled = np.random.RandomState(1).permutation(jdata.num_docs)[jdata.doc_ids.astype(np.int64)]
    if mode == "terms":
        ours = port_index_tpu.reorder_doc_ids(term_ids, shuffled, jdata.num_docs, jdata.num_terms)
        ref = jax_index_tpu.reorder_doc_ids(term_ids, shuffled, jdata.num_docs, jdata.num_terms)
    else:
        ours = port_reorder.bp_reorder(term_ids, shuffled, jdata.num_docs)
        ref = jax_reorder.bp_reorder(term_ids, shuffled, jdata.num_docs)
    np.testing.assert_array_equal(ours, ref)
    assert sorted(ours.tolist()) == list(range(jdata.num_docs))  # a permutation


def test_grid_and_maxpostings_fall_back(random_corpus):
    """Pruning auto-disables for grids, caps and other models; explicit misuse raises."""
    _, pdata, queries = random_corpus
    engine = engine_of(pdata)
    assert engine.supports_pruning("bm25")
    assert not engine.supports_pruning("bm25", grid={"k1": [0.9, 1.2]})
    assert not engine.supports_pruning("bm25", max_postings_per_term=100)
    assert not engine.supports_pruning("qld")
    with pytest.raises(ValueError, match="pruning"):
        engine.search(queries, model="qld", params={"mu": 1000.0}, topk=10,
                      prune_theta=np.zeros(len(queries), np.float32))
    with pytest.raises(ValueError, match="pruning"):
        engine.search(queries, grid={"k1": [0.9, 1.2]}, params={"b": 0.4}, topk=10,
                      prune_theta=np.zeros(len(queries), np.float32))
    without_tables = engine_of(corpus(seed=0, num_docs=500, nnz=5000)[1])
    without_tables.dindex.prune = None
    assert not without_tables.supports_pruning("bm25")


def test_table_less_terms_stay_exact():
    """heavy_df > 1 leaves low-df terms WITHOUT block-max tables; their full
    spans are kept and their global bound charged to every range, so results
    stay bit-identical (and the spans equal JAX's)."""
    jdata, pdata, rng = corpus(seed=7, **CLUSTERED, heavy_df=60)
    engine, ref_engine = engine_of(pdata), JaxEngine(JaxDeviceIndex(jdata))
    queries = batches_of(jdata, rng, 1, per_batch=16)[0]
    df = np.diff(jdata.term_offsets)
    light = [t for q in queries for t, _ in q if df[t] < 60]
    assert light and all(pdata.prune_tables["rt_offsets"][t + 1] == pdata.prune_tables["rt_offsets"][t]
                         for t in light)
    theta = engine.compute_theta(queries, params=PARAMS, topk=10)
    spans = engine._spans_pruned(queries, "bm25", PARAMS, theta)
    st = engine.last_prune_stats
    assert spans is not None and st["kept_tiles"] < st["total_tiles"], st
    ref = ref_engine._spans_pruned(queries, "bm25", PARAMS, ref_engine.compute_theta(queries, PARAMS, 10))
    for a, b in zip(spans, ref):
        np.testing.assert_array_equal(a, b)
    assert_bits_equal(engine.search(queries, params=PARAMS, topk=10, prune_spans=spans), exhaustive(engine, queries))


def span_case(kind):
    """(JAX data, port data, queries): the clustered corpus, or its draw with
    ``heavy_df`` 60 (test_table_less_terms_stay_exact's), where some query terms
    have no block-max tables."""
    jdata, pdata, rng = corpus(seed=7, **CLUSTERED, **({"heavy_df": 60} if kind == "table_less" else {}))
    queries = batches_of(jdata, rng, 1, per_batch=16)[0]
    if kind == "table_less":
        assert any(pdata.prune_tables["rt_offsets"][t + 1] == pdata.prune_tables["rt_offsets"][t]
                   for q in queries for t, _ in q)
    return jdata, pdata, queries


@pytest.mark.parametrize("topk", [10, 100])
@pytest.mark.parametrize("kind", ["clustered", "table_less"])
def test_native_spans_equal_jax_native_spans(jax_native, monkeypatch, kind, topk):
    """The native span builder (native/pruner.cpp) gives the JAX package's
    native spans array for array, with its statistics, and the pruned pass over
    them is bit-identical to exhaustive scoring."""
    monkeypatch.delenv("CAPREOLUS_NATIVE", raising=False)
    jdata, pdata, queries = span_case(kind)
    engine, ref_engine = engine_of(pdata), JaxEngine(JaxDeviceIndex(jdata))
    ours = engine._build_prune_spans(queries, "bm25", PARAMS, topk)
    ref = ref_engine._build_prune_spans(queries, "bm25", PARAMS, topk)
    assert engine.last_prune_stats == ref_engine.last_prune_stats
    assert (ours is None) == (ref is None) and (ours is not None or topk > 10)
    for a, b in zip(ours or (), ref or ()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if ours is not None:
        assert_bits_equal(engine.search(queries, params=PARAMS, topk=topk, prune_spans=ours),
                          exhaustive(engine, queries, topk))


@pytest.mark.parametrize("kind", ["clustered", "table_less"])
def test_native_and_numpy_span_stats_agree(monkeypatch, kind):
    """The two builders sample other threshold candidates, so their spans
    differ: total lanes and tiles are equal, kept tiles within 5% of the total
    (the rule of tests/test_block_max.py), and both pruned passes are exact."""
    jdata, pdata, queries = span_case(kind)
    engine = engine_of(pdata)
    ref = exhaustive(engine, queries)
    stats = {}
    for native in ("1", "0"):
        monkeypatch.setenv("CAPREOLUS_NATIVE", native)
        spans = engine._build_prune_spans(queries, "bm25", PARAMS, 10)
        stats[native] = dict(engine.last_prune_stats)
        assert spans is not None, (native, stats[native])
        assert_bits_equal(engine.search(queries, params=PARAMS, topk=10, prune_spans=spans), ref)
    nat, num = stats["1"], stats["0"]
    assert nat["total_lanes"] == num["total_lanes"] and nat["total_tiles"] == num["total_tiles"]
    assert abs(nat["kept_tiles"] - num["kept_tiles"]) <= 0.05 * num["total_tiles"], stats


# ---------------------------------------------------------------- pipelined streams
def test_search_stream_exhaustive_bit_identical():
    jdata, pdata, rng = corpus(seed=11, **CLUSTERED)
    engine = engine_of(pdata)
    batches = batches_of(jdata, rng, 4)
    for b, res in zip(batches, engine.search_stream(batches, params=PARAMS, topk=10, materialize=False, window=2)):
        assert_bits_equal(res.get(), exhaustive(engine, b))
    assert engine._prune_stream_effective == {}  # no pruning state was touched


def test_long_stream_probe_sets_a_sticky_decision():
    """A long pruned stream runs the in-stream wall-clock A/B; every result,
    probe segments included, is bit-identical; a sticky "pruning loses" runs
    later streams exhaustive, and adaptive=False still forces pruning."""
    jdata, pdata, rng = corpus(seed=12, **CLUSTERED)
    engine = engine_of(pdata)
    batches = batches_of(jdata, rng, ScoringEngine.PRUNE_LONG_STREAM)
    results = list(engine.search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False, window=2))
    assert engine.last_stream_probe is not None
    assert engine._prune_stream_effective.get(KEY10) in (True, False, None)
    assert engine._prune_tiles_ok.get(KEY10) is True
    for b, res in zip(batches, results):
        assert_bits_equal(res.get(), exhaustive(engine, b))

    engine._prune_stream_effective[KEY10] = False
    list(engine.search_pruned_stream(batches[:2], params=PARAMS, topk=10, materialize=False, window=2))
    engine.last_prune_stats = None
    forced = list(engine.search_pruned_stream(batches[:2], params=PARAMS, topk=10, materialize=False, window=2,
                                              adaptive=False))
    assert engine.last_prune_stats is not None  # span building ran
    for b, res in zip(batches[:2], forced):
        assert_bits_equal(res.get(), exhaustive(engine, b))


def test_pruned_stream_bit_identical_and_structural_retire():
    jdata, pdata, rng = corpus(seed=9, **CLUSTERED)
    engine = engine_of(pdata)
    batches = batches_of(jdata, rng, 3)
    for b, res in zip(batches, engine.search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False,
                                                           window=2)):
        assert_bits_equal(res.get(), exhaustive(engine, b))
    st = engine.last_prune_stats
    assert st["kept_tiles"] < 0.9 * st["total_tiles"], st

    # uniformly random corpus: the probe batch shows no tile savings -> sticky off
    rjdata, rpdata, rrng = corpus(seed=10, num_docs=6000, nnz=120_000)
    rengine = engine_of(rpdata)
    rbatches = batches_of(rjdata, rrng, 2)
    pending = rengine.search_pruned_stream(rbatches, params=PARAMS, topk=10, materialize=False)
    first = next(pending)  # the lazy stream probes on first dispatch
    assert rengine._prune_tiles_ok.get(KEY10) is False and rengine._prune_effective.get(KEY10) is False
    for b, res in zip(rbatches, [first, *pending]):
        assert_bits_equal(res.get(), exhaustive(rengine, b))


# ---------------------------------------------------------------- the verdict store
class FakeTime:
    """A probe clock the test advances; ``perf_counter`` replaces time.perf_counter."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def test_prune_verdict_persistence(tmp_path):
    """A structural (no tile savings) retire persists after TWO engines'
    observations; then a FRESH engine never builds spans. Within-noise ties
    retire after PRUNE_TIE_LIMIT looks, and search_pruned honours the store."""
    jdata, pdata, rng = corpus(seed=21, num_docs=6000, nnz=120_000)
    vpath = tmp_path / "v.json"
    batches = batches_of(jdata, rng, 2)
    engine = engine_of(pdata, vpath)
    list(engine.search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False))
    assert engine._prune_tiles_ok.get(KEY10) is False
    vs = json.loads(vpath.read_text())
    assert not any(v.get("verdict") is False for v in vs.values())  # one look: not settled
    assert any(v.get("ties", 0) == 1 for v in vs.values())
    list(engine_of(pdata, vpath).search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False))
    vs = json.loads(vpath.read_text())
    assert any(v.get("verdict") is False for v in vs.values())
    assert all(k.startswith(f"v{ScoringEngine.PRUNE_VERDICT_SCHEMA}:") and ":cpu:" in k for k in vs)

    fresh = engine_of(pdata, vpath)
    fresh._build_prune_spans = None  # would raise if a span build were attempted
    assert len(list(fresh.search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False))) == 2
    assert fresh._prune_tiles_ok.get(KEY10) is False and fresh.last_prune_stats is None

    tkey = (77, 0.9, 0.4)
    e3 = engine_of(pdata, vpath)
    e3._record_verdict("stream", tkey, tie=True)
    assert e3._persisted_verdict("stream", tkey) is None
    e3._record_verdict("stream", tkey, tie=True)
    assert e3._persisted_verdict("stream", tkey) is False
    assert engine_of(pdata, vpath)._persisted_verdict("stream", tkey) is False

    e5 = engine_of(pdata, vpath)
    assert_bits_equal(e5.search_pruned(batches[0], model="bm25", params=PARAMS, topk=10), exhaustive(e5, batches[0]))
    assert e5._prune_effective.get(KEY10) is False


def test_stream_level_alternation_settles_and_retires_on_tie(monkeypatch, tmp_path):
    """Short streams alternate whole streams between modes and, when enough
    looks show no separation (a frozen clock), retire pruning; a settled-False
    regime builds no spans."""
    jdata, pdata, rng = corpus(seed=22, **CLUSTERED)
    engine = engine_of(pdata, tmp_path / "v.json")
    batches = batches_of(jdata, rng, 8)
    monkeypatch.setattr(scoring.time, "perf_counter", lambda: 0.0)
    modes = []
    orig_prep = engine._prepare_tiered

    def spying_prep(term_lists, model, max_postings=0, spans=None):
        modes.append(spans is not None)
        return orig_prep(term_lists, model, max_postings, spans=spans)

    engine._prepare_tiered = spying_prep
    for _ in range(2 * ScoringEngine.PRUNE_SAMPLE_RING):
        results = list(engine.search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False, window=2))
        assert len(results) == len(batches)
        assert_bits_equal(results[0].get(), exhaustive(engine, batches[0]))
    assert True in modes and False in modes
    assert engine._prune_stream_effective.get(KEY10) is False
    assert engine._persisted_verdict("stream", KEY10) is False
    calls = []
    orig = engine._build_prune_spans
    engine._build_prune_spans = lambda *a, **k: calls.append(1) or orig(*a, **k)
    list(engine.search_pruned_stream(batches[:2], params=PARAMS, topk=10, materialize=False, window=2))
    assert calls == []


def test_poisoned_stream_verdict_heals(monkeypatch, tmp_path):
    """A persisted stream verdict is a prior: under a clock where pruned
    batches cost 1.2x exhaustive ones, the periodic re-exploration flips a
    poisoned "pruning wins" on disk and in memory."""
    jdata, pdata, rng = corpus(seed=23, **CLUSTERED)
    vpath = tmp_path / "v.json"
    engine_of(pdata, vpath)._record_verdict("stream", KEY10, True)  # poisoned
    engine = engine_of(pdata, vpath)
    batches = batches_of(jdata, rng, 8)
    clock = FakeTime()
    pruned_prebuilts = set()
    orig_prep, orig_search = engine._prepare_tiered, engine.search

    def tagging_prep(term_lists, model, max_postings=0, spans=None):
        out = orig_prep(term_lists, model, max_postings, spans=spans)
        if spans is not None:
            pruned_prebuilts.add(id(out))
        return out

    def ticking_search(*a, **kw):
        pb = kw.get("_prebuilt")
        pruned = pb is not None and id(pb) in pruned_prebuilts
        pruned_prebuilts.discard(id(pb))
        clock.t += 0.012 if pruned else 0.010
        return orig_search(*a, **kw)

    engine._prepare_tiered, engine.search = tagging_prep, ticking_search
    monkeypatch.setattr(scoring.time, "perf_counter", clock.perf_counter)
    flipped_at = None
    for i in range(2 * ScoringEngine.PRUNE_RECHECK_EVERY):
        results = list(engine.search_pruned_stream(batches, params=PARAMS, topk=10, materialize=False, window=2))
        if flipped_at is None and engine._prune_stream_effective.get(KEY10) is False:
            flipped_at = i
        assert_bits_equal(results[-1].get(), orig_search(batches[-1], params=PARAMS, topk=10, exact_topk=False))
    assert flipped_at is not None, "the poisoned verdict never healed"
    assert engine_of(pdata, vpath)._persisted_verdict("stream", KEY10) is False


def test_sync_poisoned_verdict_heals(monkeypatch, tmp_path):
    """search_pruned (the serving entry) re-probes every 64th call under a
    settled verdict; a clear opposite margin flips it."""
    jdata, pdata, rng = corpus(seed=24, **CLUSTERED)
    vpath = tmp_path / "v.json"
    engine_of(pdata, vpath)._record_verdict("sync", KEY10, True)  # poisoned
    engine = engine_of(pdata, vpath)
    engine._prune_tiles_ok[KEY10] = True
    batch = batches_of(jdata, rng, 1)[0]
    clock = FakeTime()
    orig_search = engine.search

    def ticking_search(*a, **kw):
        clock.t += 0.012 if kw.get("prune_spans") is not None else 0.010
        return orig_search(*a, **kw)

    engine.search = ticking_search
    monkeypatch.setattr(scoring.time, "perf_counter", clock.perf_counter)
    for _ in range(8 * ScoringEngine.PRUNE_RECHECK_EVERY):
        got = engine.search_pruned(batch, model="bm25", params=PARAMS, topk=10)
    assert engine._prune_effective.get(KEY10) is False
    assert engine_of(pdata, vpath)._persisted_verdict("sync", KEY10) is False
    assert_bits_equal(got, orig_search(batch, params=PARAMS, topk=10, exact_topk=False))


def test_a_verdict_settled_on_the_cpu_is_not_read_for_the_card(monkeypatch, tmp_path):
    _, pdata, _ = corpus(seed=25, num_docs=500, nnz=5000)
    vpath = tmp_path / "v.json"
    cpu = engine_of(pdata, vpath)
    cpu._record_verdict("sync", KEY10, True)
    assert engine_of(pdata, vpath)._persisted_verdict("sync", KEY10) is True
    # the same index cache served by an engine on a card (named as the engine names it)
    monkeypatch.setattr(scoring, "_device_name", lambda d: "cuda:NVIDIA H100 80GB HBM3" if d.type == "cuda" else d.type)
    card = engine_of(pdata, vpath)
    card.dindex.device = torch.device("cuda")
    assert card._verdict_key("sync", KEY10) != cpu._verdict_key("sync", KEY10)
    assert "NVIDIA H100" in card._verdict_key("sync", KEY10)
    assert card._persisted_verdict("sync", KEY10) is None


def test_flushes_from_two_engines_keep_both_entries(tmp_path):
    """Two engines that loaded the store before either wrote: each flush
    merges the file's entries, so neither overwrites the other's verdict."""
    _, pdata, _ = corpus(seed=26, num_docs=500, nnz=5000)
    vpath = tmp_path / "v.json"
    a, b = engine_of(pdata, vpath), engine_of(pdata, vpath)
    a._load_verdicts(), b._load_verdicts()
    a._record_verdict("sync", (10, 0.9, 0.4), True)
    b._record_verdict("sync", (20, 0.9, 0.4), False)
    a._record_verdict("stream", (30, 0.9, 0.4), tie=True)
    fresh = engine_of(pdata, vpath)
    assert fresh._persisted_verdict("sync", (10, 0.9, 0.4)) is True
    assert fresh._persisted_verdict("sync", (20, 0.9, 0.4)) is False
    assert fresh._verdict_entry("stream", (30, 0.9, 0.4)) == {"ties": 1}
    # and a flush brings the other engine's entries into this engine's view
    assert a._persisted_verdict("sync", (20, 0.9, 0.4)) is False


def test_concurrent_records_lose_no_verdict(tmp_path):
    """Threads recording verdicts on one engine and on a second one at once,
    with a short switch interval: every entry reaches the file."""
    _, pdata, _ = corpus(seed=27, num_docs=500, nnz=5000)
    vpath = tmp_path / "v.json"
    engines = [engine_of(pdata, vpath), engine_of(pdata, vpath)]
    errors = []

    def record(i):
        try:
            for j in range(10):
                engines[i % 2]._record_verdict("sync", (1000 * i + j, 0.9, 0.4), bool(j % 2))
        except Exception as e:  # noqa: BLE001 - surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=record, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    stored = json.loads(vpath.read_text())
    assert len(stored) == 80
    fresh = engine_of(pdata, vpath)
    assert all(fresh._persisted_verdict("sync", (1000 * i + j, 0.9, 0.4)) is bool(j % 2)
               for i in range(8) for j in range(10))
