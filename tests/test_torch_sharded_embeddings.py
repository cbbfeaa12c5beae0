"""The dense and ColBERT searchers' doc-sharded engines (``shards > 1``) in the
PyTorch port, on a mesh of ``torch.device("cpu")`` repeated 4 times, against
the port's own single-device engines and the JAX package's sharded searchers
(JAX on its forced 8-device host mesh).

Tolerances:
- sharded against the same package's resident engine: rankings identical;
  int8 dense and every ColBERT score bit for bit (a doc's score does not
  depend on the other docs of its call; int32 products and elementwise
  epilogues); bf16 dense within 1e-5 relative (the same product blocks);
- dense against JAX's sharded searcher: ``tests/test_torch_dense.py``'s run
  tolerance, 1e-3 with near-ties (bf16 rounding of embeddings 1e-7 apart);
- ColBERT against JAX's sharded engine from equal inputs (JAX's f16 cache,
  one set of query embeddings): 1e-4 with near-ties, the MaxSim tolerance of
  ``tests/test_torch_colbert.py`` (f32 sums in other orders); JAX pads its
  shards to ``chunk * shards`` docs, the port does not (K3 and X1 take any
  number of docs);
- pad rows never win (n = 6 over 4 shards, hits = 1, as
  ``tests/test_dense.py::test_dense_sharded_pad_rows_never_win``); a shard
  with no docs contributes nothing;
- each refusal with JAX's message; the services' ``refresh()`` under shards
  encodes only the added docs and serves what a single-device service serves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from test_torch_colbert import QUERIES, SEARCHER, jax_tiny_checkpoint  # noqa: E402
from test_torch_cuda import assert_same_ranking  # noqa: E402
from test_torch_dense import SEARCH_TOL, world  # noqa: E402,F401
from test_torch_dense import jax_searcher as jax_dense  # noqa: E402
from test_torch_dense import port_searcher as port_dense  # noqa: E402
from test_torch_incremental import ALL_DOCS, NAME  # noqa: E402
from test_torch_index import torch_cache, write_trec_corpus  # noqa: E402,F401
from test_torch_bert import OFFLINE_TOKENIZER  # noqa: E402
from torch_dense_util import load_run, ranked  # noqa: E402

SHARDS = 4
DEVICES = ["cpu"] * SHARDS
RTOL = 1e-5
MAXSIM_TOL = 1e-4


def sharded(searcher):
    searcher.devices = DEVICES
    return searcher


def run_of(searcher, topics, out_dir):
    return load_run(searcher.query_from_file(topics, out_dir))


# ---------------------------------------------------------------- dense
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_dense_sharded_equals_resident_and_matches_jax(world, quantize):
    options = {"quantize": quantize, "hits": 40}
    single = run_of(port_dense(world, **options), world["topics"], world["tmp"] / f"single_{quantize}")
    port = sharded(port_dense(world, shards=SHARDS, **options))
    got = run_of(port, world["topics"], world["tmp"] / f"sharded_{quantize}")
    assert len(port._shard_corpus[1]) == SHARDS
    assert list(got) == list(single)
    for qid in single:
        assert list(got[qid]) == list(single[qid]), qid  # rankings identical
        for docid, score in single[qid].items():
            if quantize == "int8":
                assert got[qid][docid] == score, (qid, docid)
            else:
                assert got[qid][docid] == pytest.approx(score, rel=RTOL, abs=1e-6), (qid, docid)
    # the engine's own scores, before the run file's six decimals
    topk, parts, n = port.build_topk(40)
    ref_topk, ref_docs, _ = port_dense(world, **options).build_topk(40)
    q = port.embed_queries(["galaxy telescope orbit", "whale ocean", "zebra cafe naive"])
    (gs, go), (ws, wo) = topk(q, parts), ref_topk(q, ref_docs)
    torch.testing.assert_close(go, wo, rtol=0, atol=0)
    torch.testing.assert_close(gs, ws, rtol=0 if quantize == "int8" else RTOL, atol=0 if quantize == "int8" else 1e-6)

    want = run_of(jax_dense(world, shards=SHARDS, **options), world["topics"], world["tmp"] / f"jax_{quantize}")
    assert list(got) == list(want)
    for qid in want:
        assert_same_ranking(ranked(got[qid]), ranked(want[qid]), SEARCH_TOL, f"{quantize} sharded vs JAX, {qid}")


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_dense_sharded_pad_rows_never_win(world, quantize):
    """n = 6 over 4 shards (per shard 2, the last shard pad rows only): with
    hits = 1 a pad's score 0 must not displace the best real doc (-0.1)."""
    v = np.full(6, -1.0, np.float32)
    v[5] = -0.1
    emb = np.repeat(v[:, None], 16, axis=1) / 16.0
    searcher = sharded(port_dense(world, shards=SHARDS, quantize=quantize))
    parts = searcher._upload_shards(emb, [torch.device(d) for d in DEVICES])
    topk = searcher._sharded_topk(6, 1, [torch.device(d) for d in DEVICES])
    scores, ords = topk(torch.ones((1, 16)), parts)
    assert int(ords[0, 0]) == 5, ords
    assert float(scores[0, 0]) == pytest.approx(-0.1, abs=2e-3)
    # every row's pad: the last shard's rows score 0 yet are never selected
    scores, ords = sharded(port_dense(world, shards=SHARDS, quantize=quantize))._sharded_topk(
        6, 6, [torch.device(d) for d in DEVICES])(torch.ones((1, 16)), parts)
    assert sorted(ords[0].tolist()) == list(range(6)) and bool(torch.isfinite(scores).all())


DENSE_REFUSALS = [({"hbmbudget": 0.0001}, "streaming"), ({"clusters": 2}, "ivf"), ({"quantize": "int4"}, "int4")]


@pytest.mark.parametrize("options,what", DENSE_REFUSALS, ids=[w for _, w in DENSE_REFUSALS])
def test_dense_refusals_raise_jax_messages(world, options, what):
    with pytest.raises(JaxConfigError) as want:
        jax_dense(world, shards=2, **options).build_topk(10)
    with pytest.raises(ConfigError) as got:
        sharded(port_dense(world, shards=2, **options)).build_topk(10)
    assert str(got.value) == str(want.value)


def test_too_few_devices_raise_jax_message(world):
    with pytest.raises(ValueError, match=r"searcher.shards=4 but only 2 devices are available"):
        s = port_dense(world, shards=4)
        s.devices = ["cpu"] * 2
        s.build_topk(10)


# ---------------------------------------------------------------- ColBERT
def colbert_pair(tmpdir_as_cache, torch_cache, corpus_docs, **options):
    """(port searcher, JAX searcher) with shared weights over the dummy
    collection (3 docs: one shard empty) or a seeded corpus."""
    config = dict(SEARCHER, **options)
    if corpus_docs:
        corpus_dir = tmpdir_as_cache / "corpus"
        write_trec_corpus(corpus_dir, num_docs=corpus_docs, seed=9, min_len=10, max_len=60)
        config["index"] = {"collection": {"name": "dummy", "path": str(corpus_dir)}}
    jax_searcher = JaxSearcher.create("colbert", {**config, "allowrandominit": True})
    jax_searcher.index.create_index()
    ckpt = jax_tiny_checkpoint(jax_searcher, torch_cache / "colbert.npz")
    port = TorchSearcher.create("colbert", {**config, "checkpointfile": ckpt})
    port.device = "cpu"
    return port, jax_searcher, ckpt, config


@pytest.mark.parametrize("quantize,corpus_docs", [("none", 0), ("none", 50), ("int8", 50)])
def test_colbert_sharded_equals_resident_and_matches_jax(tmpdir_as_cache, torch_cache, monkeypatch, quantize,
                                                         corpus_docs):
    port, jax_searcher, ckpt, config = colbert_pair(tmpdir_as_cache, torch_cache, corpus_docs,
                                                    quantize=quantize, shards=SHARDS, chunk=4)
    sharded(port)
    resident = TorchSearcher.create("colbert", {**config, "checkpointfile": ckpt, "shards": 1})
    resident.device = "cpu"
    n_docs = corpus_docs or 3
    hits = min(20, n_docs)
    q = port.encode_queries(port._tokenize(QUERIES, 8))
    topk, parts, n = port.build_topk(hits)
    ref_topk, ref_corpus, _ = resident.build_topk(hits)
    assert n == n_docs and len(parts) == SHARDS and (parts[-1] is None) == (n_docs < SHARDS)
    (gs, go), (ws, wo) = topk(q, *parts), ref_topk(q, *ref_corpus)
    torch.testing.assert_close(go, wo, rtol=0, atol=0)
    torch.testing.assert_close(gs, ws, rtol=0, atol=0)  # bit for bit
    for query in QUERIES[:2]:  # the searcher's own query path
        assert port.query(query) == resident.query(query)

    # JAX's sharded engine from equal inputs: its f16 cache, one set of query embeddings
    jax_sharded = JaxSearcher.create("colbert", {**config, "allowrandominit": True})  # flax's init, as jax_searcher's
    j_topk, j_corpus, j_n = jax_sharded.build_topk(hits)
    emb_fn, mask_fn = jax_sharded._doc_cache_file(), jax_sharded._mask_file()
    equal_inputs = TorchSearcher.create("colbert", {**config, "checkpointfile": ckpt})
    equal_inputs.device = "cpu"
    sharded(equal_inputs)
    monkeypatch.setattr(equal_inputs, "_token_cache",
                        lambda *_: (np.load(emb_fn, mmap_mode="r"), np.load(mask_fn, mmap_mode="r")))
    e_topk, e_parts, _ = equal_inputs.build_topk(hits)
    es, eo = (x.numpy() for x in e_topk(q, *e_parts))
    js, jo = (np.asarray(x) for x in j_topk(jnp.asarray(q.numpy()), *j_corpus))
    assert j_n == n_docs
    for qi in range(len(QUERIES)):
        got = [(int(o), float(s)) for s, o in zip(es[qi], eo[qi]) if np.isfinite(s)]
        want = [(int(o), float(s)) for s, o in zip(js[qi], jo[qi]) if np.isfinite(s) and o < n_docs]
        assert_same_ranking(got, want, MAXSIM_TOL, f"{quantize} colbert sharded vs JAX, query {qi}")


COLBERT_REFUSALS = [
    ({"prefilter": 2, "shards": 2}, "create"),
    ({"quantize": "int4", "shards": 2}, "create"),
    ({"hbmbudget": 1e-4, "shards": 2}, "query"),
]


@pytest.mark.parametrize("options,when", COLBERT_REFUSALS, ids=["prefilter-shards", "int4-shards", "streaming-shards"])
def test_colbert_refusals_raise_jax_messages(tmpdir_as_cache, torch_cache, options, when):
    def attempt(create, error, port):
        with pytest.raises(error) as info:
            searcher = create("colbert", {**SEARCHER, "allowrandominit": True, **options})
            searcher.device = "cpu"
            if port:
                sharded(searcher)
            searcher.index.create_index()
            searcher.query(QUERIES[0])
        return str(info.value)

    assert attempt(TorchSearcher.create, ConfigError, True) == attempt(JaxSearcher.create, JaxConfigError, False)


# ---------------------------------------------------------------- the services
SERVICE_OPTIONS = {"dense": {"maxdoclen": 32, "maxqlen": 8, "batch": 4},
                   "colbert": {"dim": 8, "maxdoclen": 16, "maxqlen": 8, "batch": 4}}


@pytest.mark.parametrize("family,quantize", [("dense", "none"), ("dense", "int8"), ("colbert", "none"),
                                             ("colbert", "int8")])
def test_services_serve_and_refresh_under_shards(torch_cache, family, quantize):
    import capreolus_tpu_torch.serving as port_serving

    cls = getattr(port_serving, {"dense": "DenseRetrievalService", "colbert": "ColbertRetrievalService"}[family])
    options = dict(SERVICE_OPTIONS[family], allowrandominit=True, tokenizer=OFFLINE_TOKENIZER, quantize=quantize,
                   index={"collection": {"name": NAME}})
    svc = cls(sharded(TorchSearcher.create(family, dict(options, shards=SHARDS))), max_k=50, device="cpu")
    assert svc.searcher.devices == DEVICES and len(svc._corpus) in (1, SHARDS)
    queries = ["galaxy telescope orbit", "whale ocean reef", "comet star nebula probe"]

    def single_hits():  # the same seeded encoder, over the caches the sharded service wrote
        single = cls(TorchSearcher.create(family, {**options, "index": svc.searcher.index.config}), max_k=50,
                     device="cpu")
        return single.search(queries, k=50)

    assert svc.search(queries, k=50) == single_hits()
    encoded = svc.searcher.docs_encoded
    svc.searcher.index.add_documents(ALL_DOCS[40:43])
    svc.searcher.index.delete_documents(["D0003"])
    assert svc.refresh() is True
    assert svc.searcher.docs_encoded == encoded + 3  # only the added docs
    assert len(svc._docids) == 42 and svc.max_k == 42
    hits = svc.search(queries, k=50)
    assert all(d != "D0003" for h in hits for d, _ in h)
    assert len(hits[0]) == 42 and {"D0040", "D0041", "D0042"} <= {d for d, _ in hits[0]}  # every doc served
    assert hits == single_hits()
    assert svc.refresh() is False
