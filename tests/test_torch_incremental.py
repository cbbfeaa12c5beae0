"""Incremental indexing and NRT refresh in the PyTorch port against the JAX
package, on the CPU: ``index/segments.py``, ``TpuIndex.add_documents`` /
``delete_documents`` / ``refresh`` / ``compact_doc_stores``, the generation-
aware caches of the dense, ColBERT and impact searchers and every service's
``refresh()`` (``tests/test_incremental.py`` and
``tests/test_incremental_embeddings.py`` in the JAX suite).

Tolerances: none. After the same add and delete ops the port's merged index
artifacts equal JAX's array for array (vocab, docids, lengths, norms, CSR,
postings, forward index, prune tables, doc spans) and a fresh port build's;
BM25 runs over them are bit-identical; a searcher's incrementally rebuilt
cache equals a fresh encode of the surviving corpus bit for bit (the
encoders are deterministic per document on the CPU); ``refresh()`` returns
what JAX's returns after each op.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.collection import Collection as JaxCollection  # noqa: E402
from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.core import ConfigOption as JaxConfigOption  # noqa: E402
from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu_torch.collection import Collection  # noqa: E402
from capreolus_tpu_torch.core import ConfigError, ConfigOption  # noqa: E402
from capreolus_tpu_torch.index import Index  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401

WORDS = ["ocean", "galaxy", "telescope", "whale", "comet", "reef", "orbit", "plankton",
         "nebula", "current", "tide", "star", "coral", "probe", "sonar", "lens"]


def make_docs(n, seed=7):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [(f"D{i:04d}", " ".join(rng.choice(WORDS, size=int(rng.integers(5, 40))).tolist())) for i in range(n)]


ALL_DOCS = make_docs(60)
NAME = "torch_incr_sliceable"


def _get_path(collection):
    cache = collection.get_cache_path() / "corpus"
    fn = cache / "docs.tsv"
    if not fn.exists():
        cache.mkdir(parents=True, exist_ok=True)
        with open(fn, "wt", encoding="utf-8") as f:
            for docid, text in ALL_DOCS[: collection.config["take"]]:
                f.write(f"{docid}\t{text}\n")
    return cache


@JaxCollection.register
class JaxSliceable(JaxCollection):
    """A prefix of ALL_DOCS, so that a fresh build over any prefix referees a grown index."""

    module_name = NAME
    collection_type = "tsv"
    config_spec = JaxCollection.config_spec + [JaxConfigOption("take", 40, "docs to yield")]
    get_path = _get_path


@Collection.register
class PortSliceable(Collection):
    module_name = NAME
    collection_type = "tsv"
    config_spec = Collection.config_spec + [ConfigOption("take", 40, "docs to yield")]
    get_path = _get_path


def index_cfg(take, **options):
    return {"collection": {"name": NAME, "take": take}, **options}


def pair(take, **options):
    """(JAX index, port index) over the same prefix, both built."""
    jax_index, port_index = JaxIndex.create("tpu", index_cfg(take, **options)), Index.create("tpu", index_cfg(take, **options))
    jax_index.create_index()
    port_index.create_index()
    return jax_index, port_index


def assert_same_index(a, b):
    """Every array a search or a feedback model reads, and the doc spans."""
    da, db = a.data, b.data
    assert da.docid_strings == db.docid_strings
    assert da.vocab == db.vocab
    for name in ("term_offsets", "doc_ids", "tfs", "doclens", "norm_doclens", "fwd_offsets", "fwd_term_ids",
                 "fwd_tfs"):
        np.testing.assert_array_equal(np.asarray(getattr(da, name)), np.asarray(getattr(db, name)), err_msg=name)
    assert set(da.prune_tables) == set(db.prune_tables)
    for key in da.prune_tables:
        np.testing.assert_array_equal(da.prune_tables[key], db.prune_tables[key], err_msg=key)
    np.testing.assert_array_equal(a._doc_spans, b._doc_spans)
    for docid in da.docid_strings[:: max(1, len(da.docid_strings) // 7)]:
        assert a.get_doc(docid) == b.get_doc(docid)


def bm25_runs(index):
    searcher = Searcher.create("BM25", {"hits": 20, "index": index.config})
    searcher.index = index
    searcher.device = "cpu"
    engine = searcher.get_engine()
    runs = {}
    for qid, text in [("q1", "galaxy telescope orbit"), ("q2", "whale ocean reef"), ("q3", "comet star nebula probe")]:
        scores, ords = engine.search([searcher.query_weights(text, engine)], model="bm25", params={"k1": 0.9, "b": 0.4},
                                     topk=min(20, engine.dindex.num_docs))
        docids = engine.dindex.host.docid_strings
        runs[qid] = [(docids[int(o)], float(s)) for s, o in zip(scores[0], ords[0])]
    return runs


# ---------------------------------------------------------------- the index
@pytest.mark.parametrize("storepositions", [False, True])
def test_merged_artifacts_equal_jax_and_a_fresh_build(tmpdir_as_cache, torch_cache, storepositions):
    jax_index, port_index = pair(40, storepositions=storepositions)
    for index in (jax_index, port_index):
        index.add_documents(ALL_DOCS[40:52])
        index.add_documents(ALL_DOCS[52:60])  # two pending ops replay in order
    assert port_index.refresh() == jax_index.refresh() == 1
    assert port_index._loaded_generation == jax_index._loaded_generation == 1
    assert_same_index(jax_index, port_index)
    fresh = Index.create("tpu", index_cfg(60, storepositions=storepositions))
    fresh.create_index()
    assert_same_index(fresh, port_index)
    assert bm25_runs(port_index) == bm25_runs(fresh)  # bit-identical scores and tie order
    if storepositions:
        for ordinal in (0, 41, 59):
            np.testing.assert_array_equal(port_index.get_doc_term_ids(ordinal), jax_index.get_doc_term_ids(ordinal))

    deleted = ["D0003", "D0017", "D0042", "D0059"]
    for index in (jax_index, port_index):
        index.delete_documents(deleted)
    assert port_index.refresh() == jax_index.refresh() == 2
    assert_same_index(jax_index, port_index)
    assert port_index.get_doc("D0003") is None and port_index.get_doc("D0045") == dict(ALL_DOCS)["D0045"]
    assert port_index.get_df("galaxi") == jax_index.get_df("galaxi")


def test_engine_and_verdict_store_follow_the_generation(tmpdir_as_cache, torch_cache):
    searcher = Searcher.create("BM25", {"index": index_cfg(40)})
    searcher.device = "cpu"
    engine0 = searcher.get_engine()
    assert searcher.get_engine() is engine0
    searcher.index.add_documents(ALL_DOCS[40:45])
    searcher.index.refresh()
    engine1 = searcher.get_engine()
    assert engine1 is not engine0 and engine1.dindex.num_docs == 45
    # the tile cache and the pruning verdicts live in the generation's directory: none serves another
    assert engine0._verdict_path() != engine1._verdict_path()
    assert "gen-1" in str(engine1._verdict_path())


def test_writes_refuse_what_jax_refuses(tmpdir_as_cache, torch_cache):
    jax_index, port_index = pair(40)
    cases = [(lambda ix: ix.add_documents([("D0001", "dup")]), ValueError),
             (lambda ix: ix.add_documents([("N1", "a"), ("N1", "b")]), ValueError),
             (lambda ix: ix.add_documents([]), ValueError),
             (lambda ix: ix.delete_documents(["NOPE"]), ValueError),
             (lambda ix: ix.delete_documents([d for d, _ in ALL_DOCS[:40]]), ValueError),
             (lambda ix: ix.delete_documents([]), ValueError)]
    for op, error in cases:
        with pytest.raises(error) as want:
            op(jax_index)
        with pytest.raises(error) as got:
            op(port_index)
        assert str(got.value) == str(want.value)
    jax_bp, port_bp = pair(40, docreorder="terms")
    with pytest.raises(JaxConfigError) as want:
        jax_bp.add_documents(ALL_DOCS[40:41])
    with pytest.raises(ConfigError) as got:
        port_bp.add_documents(ALL_DOCS[40:41])
    assert str(got.value) == str(want.value)


def test_writer_lock_and_consumed_op_names(tmpdir_as_cache, torch_cache):
    from capreolus_tpu_torch.index import segments

    _, port_index = pair(40)
    path = port_index.get_index_path()
    lock = path / "write.lock"
    lock.write_text("999999999")  # a stale lock (no such pid) is broken
    port_index.add_documents(ALL_DOCS[40:42])
    assert not lock.exists()
    import os

    lock.write_text(str(os.getppid()))  # a live writer's lock refuses
    with pytest.raises(IOError, match="write.lock"):
        port_index.add_documents(ALL_DOCS[42:43])
    lock.unlink()
    port_index.refresh()
    # an add after a merge takes a fresh sequence number and is not dropped
    port_index.add_documents(ALL_DOCS[42:44])
    assert [op.name for op in segments.pending_ops(path)] == ["00000002-add"]
    port_index.refresh()
    assert port_index.data.docid_strings[-2:] == ["D0042", "D0043"]
    assert sorted(p.name for p in path.glob("gen-*")) == ["gen-1", "gen-2"]


def test_compact_doc_stores_matches_jax(tmpdir_as_cache, torch_cache):
    jax_index, port_index = pair(40, storepositions=True)
    for index in (jax_index, port_index):
        index.add_documents(ALL_DOCS[40:50])
        index.delete_documents(["D0001", "D0002", "D0044"])
        index.refresh()
    assert port_index.compact_doc_stores() == jax_index.compact_doc_stores() > 0
    jax_index.refresh()
    port_index.refresh()
    assert port_index.generation == jax_index.generation == 2
    assert_same_index(jax_index, port_index)
    for ordinal in (0, 20, 46):
        np.testing.assert_array_equal(port_index.get_doc_term_ids(ordinal), jax_index.get_doc_term_ids(ordinal))


def test_generation_survives_a_new_process(tmpdir_as_cache, torch_cache):
    _, port_index = pair(40)
    port_index.add_documents(ALL_DOCS[40:43])
    port_index.refresh()
    again = Index.create("tpu", index_cfg(40))  # a new reader over the same directory
    assert again.data.num_docs == 43 and again._loaded_generation == 1
    assert again.get_doc("D0042") == dict(ALL_DOCS)["D0042"]


# ---------------------------------------------------------------- the searchers' caches
CACHE_CASES = {
    "dense": ({"pretrained": "tiny", "allowrandominit": True, "maxdoclen": 32, "maxqlen": 8, "batch": 8},
              lambda s: np.asarray(s._doc_embeddings())),
    "colbert": ({"dim": 8, "maxdoclen": 16, "maxqlen": 8, "batch": 4, "allowrandominit": True},
                lambda s: (lambda e, m: (np.asarray(e), np.asarray(m)))(*s._token_cache(
                    s.index.data.docid_strings, s.index._loaded_generation))),
    "impact": ({"pretrained": "tiny", "allowrandominit": True, "maxdoclen": 32, "batch": 8},
               lambda s: s._raw_doc_major(list(s.index.data.docid_strings), s.index._loaded_generation)),
}


@pytest.mark.parametrize("family", sorted(CACHE_CASES))
def test_caches_encode_only_added_docs_and_equal_a_fresh_encode(torch_cache, family):
    options, read = CACHE_CASES[family]
    grown = Searcher.create(family, {**options, "tokenizer": OFFLINE_TOKENIZER, "index": index_cfg(12)})
    grown.device = "cpu"
    read(grown)
    assert grown.docs_encoded == 12
    grown.index.add_documents(ALL_DOCS[12:15])
    grown.index.delete_documents(["D0003", "D0007"])
    grown.index.refresh()
    merged = read(grown)
    assert grown.docs_encoded == 12 + 3  # only the added docs
    assert "_gen1" in str(grown._current_doc_cache_file() if family != "impact" else
                          sorted((grown._cache_file().parent).glob("*_gen1*"))[0])

    fresh = Searcher.create(family, {**options, "tokenizer": OFFLINE_TOKENIZER, "index": index_cfg(15)})
    fresh.device = "cpu"
    fresh.index.delete_documents(["D0003", "D0007"])
    fresh.index.refresh()
    assert fresh.index.data.docid_strings == grown.index.data.docid_strings
    want = read(fresh)
    for got, ref in zip(merged if isinstance(merged, tuple) else (merged,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(got, ref)
    assert fresh.docs_encoded == 13

    # a generation whose docs are unchanged (a doc-store compaction) hardlinks the cache, encoding nothing
    grown.index.compact_doc_stores()
    grown.index.refresh()
    again = read(grown)
    assert grown.docs_encoded == 15
    for got, ref in zip(again if isinstance(again, tuple) else (again,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(got, ref)


def test_dense_ivf_engine_is_not_served_across_generations(torch_cache):
    searcher = Searcher.create("dense", {"pretrained": "tiny", "allowrandominit": True, "maxdoclen": 32, "maxqlen": 8,
                                         "batch": 8, "clusters": 2, "nprobe": 2, "tokenizer": OFFLINE_TOKENIZER,
                                         "index": index_cfg(12)})
    searcher.device = "cpu"
    topk0, meta0, n0 = searcher.build_topk(5)
    assert searcher.build_topk(5)[0] is topk0  # memoized within a generation
    searcher.index.delete_documents(["D0000"])
    searcher.index.refresh()
    topk1, meta1, n1 = searcher.build_topk(5)
    assert topk1 is not topk0 and n1 == n0 - 1


# ---------------------------------------------------------------- the services
def services(family):
    """(JAX service, port service) of one family over the collection's default 40-doc prefix."""
    import capreolus_tpu.serving as jax_serving
    import capreolus_tpu_torch.serving as port_serving

    where = dict(collection=NAME)
    if family == "bm25":
        jax_svc = jax_serving.RetrievalService(JaxIndex.create("tpu", index_cfg(40)))
        port_svc = port_serving.RetrievalService(Index.create("tpu", index_cfg(40)), device="cpu")
        return jax_svc, port_svc, lambda svc: svc.index
    cls = {"dense": "DenseRetrievalService", "colbert": "ColbertRetrievalService",
           "impact": "ImpactRetrievalService"}[family]
    options = {"dense": {"maxdoclen": 32, "maxqlen": 8, "batch": 4},
               "colbert": {"dim": 8, "maxdoclen": 16, "maxqlen": 8, "batch": 4},
               "impact": {"maxdoclen": 32, "maxqlen": 8, "batch": 4}}[family]
    options.update(allowrandominit=True, tokenizer=OFFLINE_TOKENIZER)
    jax_svc = getattr(jax_serving, cls).from_config(**where, **options)
    port_svc = getattr(port_serving, cls).from_config(device="cpu", **where, **options)
    return jax_svc, port_svc, lambda svc: svc.searcher.index


@pytest.mark.parametrize("family", ["bm25", "dense", "colbert", "impact"])
def test_refresh_returns_what_jax_returns(tmpdir_as_cache, torch_cache, family):
    jax_svc, port_svc, index_of = services(family)
    got, want = [port_svc.refresh()], [jax_svc.refresh()]  # nothing pending
    for op in (lambda ix: ix.add_documents([("NEWDOC", "zebra stampede savanna dawn galaxy")]),
               lambda ix: ix.delete_documents(["NEWDOC", "D0002"])):
        for svc, out in ((jax_svc, want), (port_svc, got)):
            op(index_of(svc))
            out.append(svc.refresh())
            out.append(svc.refresh())  # nothing new since
    assert got == want == [False, True, False, True, False]
    assert len(port_svc._docids) == len(jax_svc._docids) == 39
    hits = port_svc.search(["zebra stampede savanna"], k=39)[0]
    assert all(d not in ("NEWDOC", "D0002") for d, _ in hits)
