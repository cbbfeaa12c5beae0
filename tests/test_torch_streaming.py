"""The PyTorch port's host-streaming postings path, on the CPU (the counterpart
of ``tests/test_streaming.py``).

Above ``hbm_budget`` the tile arrays stay on the host and each batch uploads
only its working set (the unique tiles its units touch). On a corpus four
times over the budget, streamed results are BIT-IDENTICAL to the resident
engine's tiered results: exhaustive, block-max pruned, capped, for the QL
family and through the pipelined ``search_stream``. The disk tile cache of a
memory-mapped index gives the same bits and the JAX cache's format; the
``hbmbudget`` searcher option streams and writes the resident run files,
which equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher  # noqa: E402
from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine  # noqa: E402
from test_torch_block_max import assert_bits_equal, batches_of  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_tiered import corpus  # noqa: E402

PARAMS = {"k1": 0.9, "b": 0.4}


@pytest.fixture(scope="module")
def engines():
    jdata, pdata, rng = corpus(seed=11, num_docs=8000, nnz=160_000, clustered=True)
    resident = ScoringEngine(DeviceIndex(pdata, "cpu"))
    budget = resident.dindex.tile_bytes / 4  # the corpus is 4x over the budget
    streaming = ScoringEngine(DeviceIndex(pdata, "cpu", hbm_budget=budget))
    assert streaming.dindex.streaming and not resident.dindex.streaming
    # JAX's byte count: int32 docs and bf16 tf and doc-length payloads, 8 B per posting
    assert resident.dindex.tile_bytes == resident.dindex.n_tiles * 512 * 8
    queries = batches_of(jdata, rng, 1, per_batch=24, min_df=30)[0]
    return resident, streaming, queries, jdata


@pytest.mark.parametrize("topk", [10, 1000])
def test_streaming_bit_identical(engines, topk):
    resident, streaming, queries, _ = engines
    assert_bits_equal(streaming.search(queries, model="bm25", params=PARAMS, topk=topk),
                      resident.search(queries, model="bm25", params=PARAMS, topk=topk, exact_topk=False))
    st = streaming.last_stream_stats
    assert 0 < st["tiles_uploaded"] < st["total_tiles"]  # a working SET, not the corpus
    assert st["bytes_uploaded"] >= st["tiles_uploaded"] * 512 * 8


def test_streaming_with_pruning_and_caps(engines):
    resident, streaming, queries, _ = engines
    ref = resident.search(queries, model="bm25", params=PARAMS, topk=10, exact_topk=False)
    assert_bits_equal(streaming.search_pruned(queries, model="bm25", params=PARAMS, topk=10), ref)
    spans = streaming._build_prune_spans(queries, "bm25", PARAMS, 10)
    assert spans is not None  # the clustered corpus drops tiles: the streamed pruned pass runs
    assert_bits_equal(streaming.search(queries, params=PARAMS, topk=10, prune_spans=spans), ref)
    # approximate caps stream the same capped span set
    assert_bits_equal(streaming.search(queries, params=PARAMS, topk=10, max_postings_per_term=64),
                      resident.search(queries, params=PARAMS, topk=10, max_postings_per_term=64))


@pytest.mark.parametrize("model,params", [("qld", {"mu": 1000.0}), ("inl2", {"c": 1.0})])
def test_streaming_ql_family(engines, model, params):
    """Models that read exact doc lengths stream the lazily-built exact-dl payload."""
    resident, streaming, queries, _ = engines
    assert_bits_equal(streaming.search(queries, model=model, params=params, topk=10),
                      resident.search(queries, model=model, params=params, topk=10, exact_topk=False))


def test_streamed_pipeline_bit_identical(engines):
    resident, streaming, _, jdata = engines
    batches = batches_of(jdata, np.random.Generator(np.random.PCG64(3)), 4)
    for pruned in (False, True):
        out = streaming.search_stream(batches, params=PARAMS, topk=10, materialize=False, window=2,
                                      pruned=pruned, adaptive=False)
        for b, res in zip(batches, out):
            assert_bits_equal(res.get(), resident.search(b, params=PARAMS, topk=10, exact_topk=False))
    # a streaming engine never takes the exact path, whatever the caller asks
    assert not streaming.exact_path(True)
    assert_bits_equal(streaming.search(batches[0], params=PARAMS, topk=10, exact_topk=True),
                      resident.search(batches[0], params=PARAMS, topk=10, exact_topk=False))


def test_disk_tile_cache(engines, tmp_path):
    """An index with a tile_dir (index.mmap) keeps the tile payloads on disk in
    the JAX cache's format, resident or streamed, with the same bits."""
    resident, _, queries, jdata = engines
    data = resident.dindex.host
    data.tile_dir = tmp_path / "tiles"
    try:
        on_disk = ScoringEngine(DeviceIndex(data, "cpu"))
        streamed = ScoringEngine(DeviceIndex(data, "cpu", hbm_budget=1.0))
    finally:
        data.tile_dir = None
    meta = np.load(tmp_path / "tiles" / "meta.npz")
    assert str(meta["tf_dtype"]) == "bf16" and str(meta["ndl_dtype"]) == "bf16"
    assert np.load(tmp_path / "tiles" / "tf.npy", mmap_mode="r").dtype == np.uint16
    assert isinstance(streamed.dindex.tf_tiles_np, np.memmap)
    ref = resident.search(queries, params=PARAMS, topk=100, exact_topk=False)
    for engine in (on_disk, streamed):
        assert_bits_equal(engine.search(queries, params=PARAMS, topk=100, exact_topk=False), ref)
    assert_bits_equal(streamed.search(queries, model="qld", params={"mu": 1000.0}, topk=10),
                      resident.search(queries, model="qld", params={"mu": 1000.0}, topk=10, exact_topk=False))
    assert (tmp_path / "tiles" / "exact_dl.npy").exists()
    assert (on_disk._verdict_path() or "").startswith(str(tmp_path / "tiles"))


def test_searcher_hbmbudget_config(tmpdir_as_cache, torch_cache, tmp_path):
    """searcher.hbmbudget selects streaming mode; the run files equal the
    resident default's and the JAX package's, and the option stays out of the
    cache path."""
    topicsfn = tmp_path / "topics.tsv"
    topicsfn.write_text("1\ttelescope galaxies\n2\twhales ocean\n")
    runs = {}
    for label, config in (("resident", {}), ("tiny", {"hbmbudget": 1e-6})):
        searcher = Searcher.create("BM25", {**config, "index": {"collection": {"name": "dummy"}}})
        searcher.device = "cpu"
        out = searcher.query_from_file(topicsfn, tmp_path / label)
        runs[label] = Searcher.load_trec_run(next(f for f in out.iterdir() if f.name != "done"))
        assert searcher.get_engine().dindex.streaming == (label == "tiny")
        runs[label + "_path"] = searcher.get_cache_path().relative_to(tmp_path)
    jax = JaxSearcher.create("BM25", {"hbmbudget": 1e-6, "index": {"collection": {"name": "dummy"}}})
    out = jax.query_from_file(topicsfn, tmp_path / "jax")
    jax_run = JaxSearcher.load_trec_run(next(f for f in out.iterdir() if f.name != "done"))
    assert runs["resident"] == runs["tiny"] == jax_run and all(runs["tiny"].values())
    assert runs["resident_path"] == runs["tiny_path"]
