"""The PyTorch port's tiered scoring path against the JAX package's, on the CPU
(the counterpart of ``tests/test_compact_topk.py``).

Both engines score one synthetic corpus (``test_block_max._make_corpus``, a
few thousand docs) built once and handed to each package's ``IndexData``.

- the host-side tier packing (units, tiers, offsets, permutation): EQUAL, bit
  for bit, with and without a maxpostings cap;
- tiered scores against JAX's tiered path and against the port's own exact
  path, for all 8 models: within rtol 1e-5 (the tiered path sums a duplicate
  run as a tree, the exact path in term order, and XLA's CPU backend fuses
  multiply-adds), the same doc at each rank but for near-ties, where two docs
  that trade places score within that tolerance of each other;
- a parameter grid and ``search_fused`` the same way, and each grid point
  bit-identical to a single-point search;
- packed ordinal words EQUAL to JAX's at every width 1-24, and to a
  big-integer reference packer;
- ``score_dtype="bfloat16"``: the port's f32 scores equal JAX's bf16 scores
  widened to f32;
- the empty batch's shapes, and Lucene's tie-break (ascending ordinal) on a
  corpus of equal scores.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.index.tpu import IndexData as JaxIndexData  # noqa: E402
from capreolus_tpu.searcher.scoring import DeviceIndex as JaxDeviceIndex  # noqa: E402
from capreolus_tpu.searcher.scoring import ScoringEngine as JaxEngine  # noqa: E402
from capreolus_tpu_torch.index.tpu import IndexData  # noqa: E402
from capreolus_tpu_torch.searcher import scoring  # noqa: E402
from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine  # noqa: E402
from chip_smoke import ranking_rows_faults  # noqa: E402
from test_block_max import _make_corpus  # noqa: E402

RTOL = 1e-5
PARAMS = {"k1": 0.9, "b": 0.4}
MODEL_PARAMS = {
    "bm25": PARAMS,
    "impact": {},
    "qld": {"mu": 1000.0},
    "qljm": {"lam": 0.1},
    "inl2": {"c": 1.0},
    "spl": {"c": 1.0},
    "f2exp": {"s": 0.5},
    "f2log": {"s": 0.5},
}


def port_data(data):
    """The port's IndexData over a JAX IndexData's arrays (prune tables included)."""
    return IndexData(term_offsets=data.term_offsets, doc_ids=data.doc_ids, tfs=data.tfs, doclens=data.doclens,
                     norm_doclens=data.norm_doclens, docid_strings=None, vocab=None,
                     prune_tables=data.prune_tables)


def corpus(seed=0, num_docs=4000, nnz=60_000, **kw):
    """(JAX IndexData, port IndexData, rng) of one ``_make_corpus`` draw."""
    data, rng = _make_corpus(seed=seed, num_docs=num_docs, nnz=nnz, **kw)
    return data, port_data(data), rng


def random_queries(data, rng, sizes=(1, 2, 4, 4, 6, 8), per_size=3, min_df=30):
    df = np.diff(data.term_offsets)
    cands = np.where(df > min_df)[0]
    return [[(int(t), 1.0 + i % 2) for i, t in enumerate(rng.choice(cands, size=n, replace=False))]
            for n in sizes for _ in range(per_size)]


def assert_same_ranking(a, b, rtol=RTOL, what=""):
    """Two (scores, ords) results [..., Q, k] agree row by row: the same number
    of matching docs (score > 0), scores rank by rank and each doc in both rows
    within ``rtol`` of the row's top score, and the same doc at each rank but
    for near-ties (``chip_smoke.ranking_rows_faults``)."""
    (sa, oa), (sb, ob) = a, b
    assert sa.shape == sb.shape and oa.shape == ob.shape, what
    k = sa.shape[-1]
    faults = ranking_rows_faults((sa.reshape(-1, k), oa.reshape(-1, k)), (sb.reshape(-1, k), ob.reshape(-1, k)), rtol)
    assert not faults, (what, faults)


@pytest.fixture(scope="module")
def engines():
    jdata, pdata, rng = corpus(seed=3, clustered=True)
    queries = random_queries(jdata, rng) + [[]]  # an empty query must not break anything
    return {"jax": JaxEngine(JaxDeviceIndex(jdata)), "port": ScoringEngine(DeviceIndex(pdata, "cpu")),
            "queries": queries}


@pytest.mark.parametrize("cap", [0, 40])
def test_packed_units_equal_jax(engines, cap):
    q = engines["queries"]
    ours = engines["port"]._build_tiered(q, "bm25", cap)
    ref = engines["jax"]._build_tiered(q, "bm25", cap)
    np.testing.assert_array_equal(ours[0], ref[0])  # packed [5, u_pad]: tile, w1, w2, lo, hi
    assert ours[0].dtype == ref[0].dtype == np.int32
    assert ours[1] == ref[1]  # tiers (uw, qt_pad, qt, qbase)
    np.testing.assert_array_equal(ours[2], ref[2])  # u0s
    np.testing.assert_array_equal(ours[3], ref[3])  # inv_order
    assert ours[4] == ref[4]  # r_max


@pytest.mark.parametrize("model", sorted(MODEL_PARAMS))
def test_tiered_matches_jax_and_the_exact_path(engines, model):
    q, params = engines["queries"], MODEL_PARAMS[model]
    ours = engines["port"].search(q, model=model, params=params, topk=200, exact_topk=False)
    ref = engines["jax"].search(q, model=model, params=params, topk=200, exact_topk=False)
    exact = engines["port"].search(q, model=model, params=params, topk=200, exact_topk=True)
    assert ours[0].dtype == np.float32 and ours[1].dtype == np.int32
    assert_same_ranking(ours, ref, what=f"{model} vs JAX tiered")
    assert_same_ranking(ours, exact, what=f"{model} vs the port's exact path")
    # past the matching docs the tiered path pads with the sentinel ordinal
    assert (ours[1][ours[0] <= 0] == engines["port"].dindex.num_docs).all()


@pytest.mark.parametrize("model", sorted(MODEL_PARAMS))
def test_explain_matches_jax(engines, model):
    """``ScoringEngine.explain`` against the JAX engine's, for each model: the
    same terms, weights, tfs and doc lengths; each contribution and the total
    within RTOL of JAX's (the formula in f32 on either side), and the total
    equal to the engine's own score for the document within RTOL."""
    port, jax_engine, params = engines["port"], engines["jax"], MODEL_PARAMS[model]
    checked = 0
    for terms in engines["queries"][:-1:3]:
        scores, ords = port.search([terms], model=model, params=params, topk=5, exact_topk=True)
        other = int(np.setdiff1d(np.arange(port.dindex.num_docs), ords[0])[0])  # a doc outside the top 5
        for doc, score in list(zip(ords[0].tolist(), scores[0].tolist())) + [(other, 0.0)]:
            ours = port.explain(terms, doc, model=model, params=params)
            ref = jax_engine.explain(terms, doc, model=model, params=params)
            assert ours["model"] == ref["model"] == model
            assert [{k: v for k, v in t.items() if k != "contribution"} for t in ours["terms"]] == \
                [{k: v for k, v in t.items() if k != "contribution"} for t in ref["terms"]]
            np.testing.assert_allclose([t["contribution"] for t in ours["terms"]],
                                       [t["contribution"] for t in ref["terms"]], rtol=RTOL, atol=1e-6)
            assert ours["total"] == pytest.approx(ref["total"], rel=RTOL, abs=1e-6)
            if score > 0:
                assert ours["total"] == pytest.approx(score, rel=RTOL, abs=1e-6)
            checked += 1
    assert checked >= 20


def test_tiered_grid_matches_jax(engines):
    q = engines["queries"]
    grid = {"k1": [0.9, 1.2], "b": [0.4, 0.75]}
    ours = engines["port"].search(q, grid=grid, topk=50, exact_topk=False)
    ref = engines["jax"].search(q, grid=grid, topk=50, exact_topk=False)
    exact = engines["port"].search(q, grid=grid, topk=50, exact_topk=True)
    assert ours[0].shape == (2, 2, len(q), 50)  # axes b, k1 (sorted names), then Q
    assert_same_ranking(ours, ref, what="grid vs JAX")
    assert_same_ranking(ours, exact, what="grid vs exact")
    single = engines["port"].search(q, params={"k1": 1.2, "b": 0.4}, topk=50, exact_topk=False)
    np.testing.assert_array_equal(ours[0][0, 1], single[0])
    np.testing.assert_array_equal(ours[1][0, 1], single[1])


def test_grid_chunks_give_the_same_bits(engines, monkeypatch):
    """A grid scored in chunks of points (TIER_GRID_LANES) equals it scored at once."""
    q = engines["queries"]
    grid = {"k1": [0.6, 0.9, 1.2], "b": [0.4, 0.75]}
    whole = engines["port"].search(q, grid=grid, topk=50, exact_topk=False)
    monkeypatch.setattr(scoring, "TIER_GRID_LANES", 1)
    chunked = engines["port"].search(q, grid=grid, topk=50, exact_topk=False)
    np.testing.assert_array_equal(whole[0], chunked[0])
    np.testing.assert_array_equal(whole[1], chunked[1])


def test_search_fused_matches_search(engines):
    rng = np.random.Generator(np.random.PCG64(5))
    jdata = engines["jax"].dindex.host
    batches = [random_queries(jdata, rng, sizes=(2, 3, 4), per_size=2) for _ in range(3)]
    fused = engines["port"].search_fused(batches, params=PARAMS, topk=25)
    ref = engines["jax"].search_fused(batches, params=PARAMS, topk=25)
    assert fused[0].shape == (3, 6, 25)
    assert_same_ranking(fused, ref, what="search_fused vs JAX")
    for si, batch in enumerate(batches):
        s, o = engines["port"].search(batch, params=PARAMS, topk=25, exact_topk=False)
        np.testing.assert_array_equal(fused[0][si], s)
        np.testing.assert_array_equal(fused[1][si], o)


def _sparse_corpus(bits, seed=0):
    """A corpus of 2^bits - 1 docs (ordinals packed at ``bits`` bits) holding
    only ~120 postings in 3 terms, for both packages."""
    n = (1 << bits) - 1
    rng = np.random.Generator(np.random.PCG64(seed + bits))
    offsets, docs, tfs = [0], [], []
    for _ in range(3):
        d = np.unique(rng.integers(0, n, size=min(n, 40)))
        docs.append(d)
        tfs.append(rng.integers(1, 5, size=len(d)))
        offsets.append(offsets[-1] + len(d))
    doclens = np.full(n, 7, np.int32)
    kw = dict(term_offsets=np.asarray(offsets, np.int64), doc_ids=np.concatenate(docs).astype(np.int32),
              tfs=np.concatenate(tfs).astype(np.int32), doclens=doclens, norm_doclens=doclens.copy(),
              docid_strings=None, vocab=None)
    return JaxIndexData(**kw), IndexData(**kw)


@pytest.mark.parametrize("bits", range(1, 25))
def test_packed_ordinal_words_equal_jax(bits):
    jdata, pdata = _sparse_corpus(bits)
    assert scoring.ord_pack_bits(pdata.num_docs) == bits
    queries = [[(0, 1.0), (1, 2.0)], [(2, 1.0)], [(1, 1.0)]]
    ours = ScoringEngine(DeviceIndex(pdata, "cpu")).search(queries, params=PARAMS, topk=37, exact_topk=False,
                                                             pack_ords=True, materialize=False)
    ref = JaxEngine(JaxDeviceIndex(jdata)).search(queries, params=PARAMS, topk=37, exact_topk=False,
                                                  pack_ords=True, materialize=False)
    g, wpg = scoring._ord_pack_geometry(bits)
    assert ours.ords.dtype == torch.int32 and ours.ords.shape[-1] == wpg
    np.testing.assert_array_equal(ours.ords.numpy().view(np.uint32), np.asarray(ref.ords))
    (s, o), (rs, ro) = ours.get(), ref.get()
    np.testing.assert_array_equal(o, ro)
    np.testing.assert_allclose(s, rs, rtol=1e-6)


@pytest.mark.parametrize("bits", [1, 5, 9, 18, 24])
def test_pack_bits_matches_a_big_integer_packer(bits):
    rng = np.random.Generator(np.random.PCG64(9))
    k = 37
    g, wpg = scoring._ord_pack_geometry(bits)
    kp = ((k + g - 1) // g) * g
    vals = rng.integers(0, 1 << bits, size=(3, k))
    pad = (1 << bits) - 1
    words = scoring._pack_bits(torch.from_numpy(vals.astype(np.int32)), bits, k, pad).numpy().view(np.uint32)
    full = np.concatenate([vals, np.full((3, kp - k), pad)], axis=1)
    for r in range(3):
        stream = 0
        for i, v in enumerate(full[r].tolist()):
            stream |= int(v) << (bits * i)
        want = [(stream >> (32 * j)) & 0xFFFFFFFF for j in range(kp * bits // 32)]
        assert words[r].reshape(-1).tolist() == want
    np.testing.assert_array_equal(scoring.unpack_doc_ords_bits(words, k, bits), vals)


def test_bf16_scores_equal_jax_widened(engines):
    q = engines["queries"]
    ours = engines["port"].search(q, params=PARAMS, topk=100, exact_topk=False, score_dtype="bfloat16",
                                  pack_ords=True)
    ref = engines["jax"].search(q, params=PARAMS, topk=100, exact_topk=False, score_dtype="bfloat16",
                                pack_ords=True)
    assert ours[0].dtype == np.float32 and str(ref[0].dtype) == "bfloat16"  # the recorded difference
    f32 = engines["port"].search(q, params=PARAMS, topk=100, exact_topk=False)
    # bf16 rounding of the f32 scores; ties in bf16 keep the f32 order
    np.testing.assert_array_equal(ours[0], torch.from_numpy(f32[0]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(ours[1], f32[1])
    same = ours[1] == ref[1]
    assert same.mean() > 0.99
    np.testing.assert_array_equal(ours[0][same], ref[0].astype(np.float32)[same])
    pending = engines["port"].search(q, params=PARAMS, topk=100, exact_topk=False, score_dtype="bfloat16",
                                     materialize=False)
    assert pending.scores.dtype == torch.bfloat16  # half the bytes cross to the host


def test_tiered_empty_batch(engines):
    engine = engines["port"]
    scores, ords = engine.search([], params=PARAMS, topk=20, exact_topk=False)
    assert scores.shape == (0, 20) and ords.shape == (0, 20)
    scores, ords = engine.search([], params=PARAMS, topk=20, exact_topk=False, materialize=False).get()
    assert scores.shape == (0, 20) and ords.shape == (0, 20)
    scores, ords = engine.search([], params={"b": 0.4}, topk=20, exact_topk=False, grid={"k1": [0.8, 0.9, 1.2]})
    assert scores.shape == (3, 0, 20) and ords.shape == (3, 0, 20)


def test_ties_break_by_ascending_ordinal():
    """Every doc holding the term scores the same: the tiered path ranks them
    by ascending ordinal, as the exact path and JAX do (Lucene's docid
    tie-break), also when k cuts through the ties and under pruning."""
    n = 3000
    docs = np.arange(1, n, 3, dtype=np.int32)[::-1].copy()  # postings stored in descending doc order
    other = np.arange(0, n, 7, dtype=np.int32)
    kw = dict(term_offsets=np.asarray([0, len(docs), len(docs) + len(other)], np.int64),
              doc_ids=np.concatenate([docs, other]), tfs=np.ones(len(docs) + len(other), np.int32),
              doclens=np.full(n, 10, np.int32), norm_doclens=np.full(n, 10, np.int32),
              docid_strings=None, vocab=None)
    engine = ScoringEngine(DeviceIndex(IndexData(**kw), "cpu"))
    jax_engine = JaxEngine(JaxDeviceIndex(JaxIndexData(**kw)))
    queries = [[(0, 1.0)], [(0, 1.0), (1, 1.0)]]
    s, o = engine.search(queries, params=PARAMS, topk=100, exact_topk=False)
    assert (s[0] == s[0, 0]).all() and o[0].tolist() == sorted(docs.tolist())[:100]
    for ref in (engine.search(queries, params=PARAMS, topk=100, exact_topk=True),
                jax_engine.search(queries, params=PARAMS, topk=100, exact_topk=False)):
        np.testing.assert_array_equal(o, ref[1])
        np.testing.assert_allclose(s, ref[0], rtol=1e-6)
    # docs holding both terms come first, each score level in ascending ordinal
    both = sorted(set(docs.tolist()) & set(other.tolist()))
    assert len(both) > 100 and o[1].tolist() == both[:100]
