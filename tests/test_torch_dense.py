"""The dense searcher of the PyTorch port (``searcher/dense.py`` with
``ivf.py``, ``streamed.py`` and ``embedding_cache.py``, and
``ops/quantization.py``'s MIPS scorers) against the JAX package on the CPU,
over a 126-doc corpus holding 6 duplicate documents, with the JAX searcher's
random-init encoder carried over as the port's ``checkpointfile``.

Tolerances:
- embeddings: 1e-5 (the tiny f32 encoder's sums in other orders).
- search (every engine): the same docids in the same order but for
  near-ties, scores within 1e-3. An embedding 1e-7 from JAX's can round one
  component to the neighbouring bf16 value (2^-8 of it), or one int8 / int4
  code the other way, which moves a score by up to about 5e-4; fed the same
  inputs, the int32 products and the f32 epilogues are equal bit for bit,
  and so are the rankings of one package's engines.
- exact ties (duplicate documents; int8 codes): ascending ordinal, as
  ``jax.lax.top_k`` orders them, in both packages.
- streamed against resident: equal bit for bit.
- IVF: JAX's Lloyd iterations and final assignment from the same sample:
  centroids within 1e-5, assignments equal but where a row's two best
  centroids are within 1e-5; ``build_cells`` equal; JAX's layout file gives
  the JAX hits.
"""

import shutil

import jax
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
from capreolus_tpu_torch.searcher import dense as port_dense  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_cuda import assert_same_ranking  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from torch_dense_util import (TOPICS, jax_dense_checkpoint, load_run, ranked, searcher_config,  # noqa: E402
                              write_dense_corpus, write_topics)

EMB_TOL = 1e-5
SEARCH_TOL = 1e-3


@pytest.fixture
def world(tmpdir_as_cache, torch_cache):
    """The corpus, the topics file, and the JAX searcher's encoder saved as a checkpoint."""
    coll = write_dense_corpus(tmpdir_as_cache / "corpus")
    jax_searcher = JaxSearcher.create("dense", searcher_config(coll))
    ckpt = jax_dense_checkpoint(jax_searcher, torch_cache / "dense.npz")
    return {"coll": coll, "topics": write_topics(tmpdir_as_cache / "topics.tsv"), "ckpt": ckpt,
            "tmp": tmpdir_as_cache, "jax": jax_searcher}


def port_searcher(world, **options):
    s = TorchSearcher.create("dense", searcher_config(world["coll"], **{"checkpointfile": world["ckpt"], **options}))
    s.device = "cpu"
    return s


def jax_searcher(world, **options):
    return JaxSearcher.create("dense", searcher_config(world["coll"], **options))


def search_both(world, name, **options):
    port, jx = port_searcher(world, **options), jax_searcher(world, **options)
    port_run = load_run(port.query_from_file(world["topics"], world["tmp"] / f"port_{name}"))
    jax_run = load_run(jx.query_from_file(world["topics"], world["tmp"] / f"jax_{name}"))
    return port, jx, port_run, jax_run


def assert_runs_agree(port_run, jax_run, tol, what):
    assert list(port_run) == list(jax_run), what
    for qid in jax_run:
        assert_same_ranking(ranked(port_run[qid]), ranked(jax_run[qid]), tol, f"{what}, {qid}")


def test_embeddings_match_jax(world):
    port = port_searcher(world)
    jx = world["jax"]
    port.index.create_index()
    docids = port.index.data.docid_strings
    texts = [port.index.get_doc(d) for d in docids[:40]]
    for attr, maxlen in (("maxdoclen", 32), ("maxqlen", 8)):
        port._embed_maxlen = jx._embed_maxlen = maxlen
        sample = texts if attr == "maxdoclen" else list(TOPICS.values())
        assert_within(port._embed_texts(sample), jx._embed_texts(sample), EMB_TOL, f"embeddings at {attr}")


@pytest.mark.parametrize("mode,options,tol", [
    ("exact", {}, SEARCH_TOL),
    ("approx", {"topkmode": "approx", "recalltarget": 0.9}, SEARCH_TOL),
    ("cls", {"pooling": "cls", "hits": 30}, SEARCH_TOL),
    ("prf", {"prf": 3, "prfalpha": 1.0, "prfbeta": 0.5, "hits": 40}, SEARCH_TOL),
    ("int8", {"quantize": "int8", "hits": 40}, SEARCH_TOL),
    ("int4_rescore", {"quantize": "int4", "rescore": 60, "hits": 30}, SEARCH_TOL),
    ("int4_raw", {"quantize": "int4", "rescore": 0, "hits": 30}, SEARCH_TOL),
    ("streamed", {"hbmbudget": 0.002, "hits": 50}, SEARCH_TOL),
])
def test_search_matches_jax(world, mode, options, tol):
    """Each engine's run file against JAX's, ``approx`` (exact selection in the
    port) against JAX's ``approx_max_k`` on the CPU."""
    port, _, port_run, jax_run = search_both(world, mode, **options)
    assert_runs_agree(port_run, jax_run, tol, mode)
    assert all(len(v) == min(int(port.config["hits"]), 126) for v in port_run.values())


def test_duplicate_documents_rank_by_ascending_ordinal(world):
    """Duplicate documents tie exactly (equal embeddings; int8 codes tie more
    pairs): every exact tie in the port's engine lists the lower ordinal
    first, and each original precedes its duplicate in both packages."""
    for quantize in ("none", "int8"):
        port, jx = port_searcher(world, quantize=quantize), jax_searcher(world, quantize=quantize)
        topk, docs, n = port.build_topk(126)
        scores, ords = topk(port.embed_queries(list(TOPICS.values())), docs)
        jtopk, jdocs, _ = jx.build_topk(126)
        jx._embed_maxlen = 8
        _, jords = jtopk(jnp.asarray(jx._embed_texts(list(TOPICS.values()))), jdocs)
        docids = port.index.data.docid_strings
        ordinal = {d: i for i, d in enumerate(docids)}
        ties = 0
        for qi in range(len(TOPICS)):
            s, o = scores[qi].tolist(), ords[qi].tolist()
            for j in range(len(s) - 1):
                if s[j] == s[j + 1]:
                    ties += 1
                    assert o[j] < o[j + 1], (quantize, qi, j)
            for row in (o, np.asarray(jords[qi]).tolist()):
                pos = {docids[x]: r for r, x in enumerate(row)}
                for i in range(6):
                    assert pos[f"T{i:05d}"] < pos[f"DUP{i}"], (quantize, qi, i)
            assert all(ordinal[f"T{i:05d}"] < ordinal[f"DUP{i}"] for i in range(6))
        assert ties >= 6 * len(TOPICS), (quantize, ties)


def test_quantized_scores_match_jax():
    """Fed the same queries, ``int8_mips_scores`` and ``int4_mips_scores``
    equal the JAX functions bit for bit: the int32 products, and the f32
    epilogue in its order, which differs between int4's unchunked and
    chunked paths (``row_chunk`` lowered so that the chunked path runs)."""
    from capreolus_tpu.ops import quantization as jq
    from capreolus_tpu_torch.ops import quantization as pq

    rng = np.random.Generator(np.random.PCG64(5))
    q = rng.standard_normal((5, 47)).astype(np.float32)
    q[3] = 0.0  # an all-zero query: scale 1
    docs = rng.standard_normal((50, 47)).astype(np.float32)
    codes, scale = pq.quantize_rows(docs)
    np.testing.assert_array_equal(codes, jq.quantize_rows(docs)[0])
    got = pq.int8_mips_scores(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.int8_mips_scores(jnp.asarray(q), jnp.asarray(codes),
                                                                       jnp.asarray(scale))))
    p4, s4 = pq.quantize_rows_int4(docs)
    for row_chunk in (131072, 16):
        got = pq.int4_mips_scores(torch.from_numpy(q), torch.from_numpy(p4), torch.from_numpy(s4),
                                  row_chunk=row_chunk).numpy()
        want = np.asarray(jq.int4_mips_scores(jnp.asarray(q), jnp.asarray(p4), jnp.asarray(s4), row_chunk=row_chunk))
        np.testing.assert_array_equal(got, want, err_msg=f"row_chunk {row_chunk}")
    # the two epilogue orders round differently somewhere, so each is its own path
    unchunked = pq.int4_mips_scores(torch.from_numpy(q), torch.from_numpy(p4), torch.from_numpy(s4)).numpy()
    chunked = pq.int4_mips_scores(torch.from_numpy(q), torch.from_numpy(p4), torch.from_numpy(s4), row_chunk=16).numpy()
    assert np.abs(unchunked - chunked).max() < 1e-6


@pytest.mark.parametrize("quantize", ["none", "int8", "int4"])
def test_streamed_equals_resident_bit_for_bit(world, quantize):
    """A budget of a few chunks (and ``hbmbudget=0``, one row a chunk) streams
    the corpus; scores and ordinals equal the resident engine's bit for bit."""
    resident = port_searcher(world, quantize=quantize, rescore=0, hits=50)
    topk_r, docs_r, n = resident.build_topk(50)
    q = resident.embed_queries(list(TOPICS.values()))
    want = topk_r(q, docs_r)
    for budget in (0.003, 0):
        streamed = port_searcher(world, quantize=quantize, rescore=0, hits=50, hbmbudget=budget)
        topk_s, docs_s, _ = streamed.build_topk(50)
        assert isinstance(docs_s, port_dense._HostCorpus) and streamed.stream_chunks >= 4
        got = topk_s(q, docs_s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (quantize, budget)


def test_streamed_pad_rows_never_win(world):
    """12 docs in 8-doc chunks, every score negative, the best four in the
    padded last chunk: the zero pad rows must not evict them (the mask runs
    before each chunk's selection)."""
    v = np.full(12, -1.0, np.float32)
    v[8:] = -0.1
    emb = np.repeat(v[:, None], 16, axis=1) / 16.0
    searcher = port_searcher(world, hbmbudget=512 / 1e6)
    topk = searcher._streamed_topk(port_dense._HostCorpus(emb.astype(np.float32)), hits=4)
    scores, ords = topk(torch.ones((1, 16)), None)
    assert set(ords[0].tolist()) == {8, 9, 10, 11}, ords
    np.testing.assert_allclose(scores[0].numpy(), -0.1, atol=2e-3)


def test_ivf_kmeans_and_cells_match_jax():
    """From JAX's own sample (its threefry permutation passed as
    ``sample_idx``), Lloyd's iterations and the final assignment."""
    from capreolus_tpu.searcher import ivf as jax_ivf
    from capreolus_tpu_torch.searcher import ivf as port_ivf

    rng = np.random.Generator(np.random.PCG64(7))
    n, dim, k = 600, 16, 8
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    docs = centers[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, dim)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    jdocs = jnp.asarray(docs, jnp.bfloat16)
    j_cent, j_assign = jax_ivf.spherical_kmeans(jdocs, k, iters=4, sample_cap=400, slab=256)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n))[:400]
    pdocs = torch.from_numpy(docs).to(torch.bfloat16)
    p_cent, p_assign = port_ivf.spherical_kmeans(pdocs, k, iters=4, sample_cap=400, slab=256, sample_idx=perm)
    assert_within(p_cent.numpy(), np.asarray(j_cent), EMB_TOL, "IVF centroids from JAX's sample")
    sims = port_ivf.bf16_sims(pdocs, p_cent).numpy()
    top2 = np.sort(sims, axis=1)[:, -2:]
    differ = p_assign != j_assign
    assert np.all(top2[differ, 1] - top2[differ, 0] <= EMB_TOL), "an assignment differs away from a near-tie"
    assert differ.mean() < 0.01
    for got, want in zip(port_ivf.build_cells(j_assign, k), jax_ivf.build_cells(j_assign, k)):
        np.testing.assert_array_equal(got, want)
    # the port's own draw trains too (its cells are its own)
    cent, assign = port_ivf.spherical_kmeans(pdocs, k, iters=2, sample_cap=300)
    assert cent.shape == (k, dim) and assign.shape == (n,) and assign.dtype == np.int32


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_layout_from_jax_gives_jax_hits(world, quantize):
    """JAX's trained layout (``.npz``) copied to the port's ``_ivf_cache_file``:
    the same probes, hence the JAX searcher's hits; then the disk layout
    restores without k-means."""
    options = {"clusters": 6, "nprobe": 2, "quantize": quantize, "hits": 40}
    jx = jax_searcher(world, **options)
    jax_run = load_run(jx.query_from_file(world["topics"], world["tmp"] / f"jax_ivf_{quantize}"))
    port = port_searcher(world, **options)
    port._doc_embeddings()
    dest = port._ivf_cache_file()
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(jx._ivf_cache_file(), dest)
    port_run = load_run(port.query_from_file(world["topics"], world["tmp"] / f"port_ivf_{quantize}"))
    assert_runs_agree(port_run, jax_run, SEARCH_TOL, f"IVF {quantize}")
    assert any(len(v) < 40 for v in port_run.values())  # two of six cells hold fewer than 40 docs for some query


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_full_probe_equals_exact(world, quantize):
    """``nprobe = clusters`` probes every cell: the exact engine's hits (its
    own cells, trained and cached on first use)."""
    exact = port_searcher(world, quantize=quantize, hits=50)
    ivf = port_searcher(world, quantize=quantize, hits=50, clusters=5, nprobe=5)
    q = exact.embed_queries(list(TOPICS.values()))
    topk_e, docs_e, _ = exact.build_topk(50)
    topk_i, meta, _ = ivf.build_topk(50)
    assert ivf._ivf_cache_file().exists()
    (se, oe), (si, oi) = topk_e(q, docs_e), topk_i(q, meta)
    docids = exact.index.data.docid_strings
    for qi in range(len(TOPICS)):
        assert_same_ranking([(docids[o], s) for s, o in zip(si[qi].tolist(), oi[qi].tolist())],
                            [(docids[o], s) for s, o in zip(se[qi].tolist(), oe[qi].tolist())],
                            SEARCH_TOL, f"IVF full probe, query {qi}")


def test_embedding_cache_key_and_disjointness(world):
    """The cache key ignores results-only options, tracks pooling, the
    tokenizer in use and the random-init marker (``tests/test_dense.py``);
    a second searcher reuses the file."""
    searcher = port_searcher(world)
    searcher.query_from_file(world["topics"], world["tmp"] / "o1")
    cache_fn = searcher._doc_cache_file()
    assert cache_fn.exists() and cache_fn.parent.name == "dense"
    assert port_searcher(world, hits=7)._doc_cache_file() == cache_fn
    assert port_searcher(world, pooling="cls")._doc_cache_file() != cache_fn
    random_init = port_searcher(world, checkpointfile=None)
    assert random_init._doc_cache_file() != cache_fn and random_init._random_init
    from capreolus_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer

    vocabfn = world["tmp"] / "vocab.txt"
    vocabfn.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "tele", "##scope"]))
    s_tok = port_searcher(world)
    s_tok._doc_cache_file()
    s_tok.tokenizer.bert_tokenizer = WordPieceTokenizer(str(vocabfn))
    assert s_tok._doc_cache_file() != cache_fn
    mtime = cache_fn.stat().st_mtime_ns
    port_searcher(world).query_from_file(world["topics"], world["tmp"] / "o2")
    assert cache_fn.stat().st_mtime_ns == mtime
    assert (cache_fn.parent / (cache_fn.name + ".docids")).read_text().splitlines() == \
        list(searcher.index.data.docid_strings)


@pytest.mark.parametrize("options", [{"pooling": "max"}, {"topkmode": "sorta"}, {"quantize": "int2"},
                                     {"prf": 50, "hits": 10}])
def test_validation_messages_match_jax(world, options):
    with pytest.raises(JaxConfigError) as want:
        jax_searcher(world, **options)
    with pytest.raises(ConfigError) as got:
        port_searcher(world, **options)
    assert str(got.value) == str(want.value)


def test_unported_and_invalid_combinations_raise(world):
    """``shards > 1`` raised here until the doc-sharded engine was ported
    (tests/test_torch_sharded_embeddings.py holds it against JAX): without
    ``devices`` its shards are cards, and too few raise JAX's ValueError,
    as too short an explicit ``devices`` list does on every machine."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="searcher.shards=2 but only 0 devices are available"):
            port_searcher(world, shards=2).build_topk(10)
    one_device = port_searcher(world, shards=2)
    one_device.devices = ["cpu"]
    with pytest.raises(ValueError, match="searcher.shards=2 but only 1 devices are available"):
        one_device.build_topk(10)
    with pytest.raises(ConfigError, match="needs the corpus device-resident"):
        port_searcher(world, clusters=2, hbmbudget=0).build_topk(10)
    with pytest.raises(ConfigError, match="int4 is the capacity tier"):
        port_searcher(world, clusters=2, quantize="int4").build_topk(10)
    with pytest.raises(ValueError, match="no 'bert' submodule"):
        bad = world["tmp"] / "bad.npz"
        np.savez(bad, **{"params/classifier/kernel": np.zeros((2, 1), np.float32)})
        port_searcher(world, checkpointfile=str(bad))._encoder()
    with pytest.raises(RuntimeError, match="refusing"):
        port_searcher(world, pretrained="not-a-real-model-xyz", checkpointfile=None)._encoder()
    # TF32 is no longer refused: the encoder and k-means run under matmul_f32 (tests/test_torch_tf32.py on the card)
    searcher = port_searcher(world)
    model = searcher._encoder()
    seen, forward = [], model.forward
    model.forward = lambda *a, **k: (seen.append(torch.backends.cuda.matmul.allow_tf32), forward(*a, **k))[1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        topk, docs, _ = searcher.build_topk(10)
        topk(searcher.embed_queries(["galaxy"]), docs)
        assert seen and not any(seen) and torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_biencoder_dev_best_serves_in_both_dense_searchers(world, writer):
    """A biencoder ``dev.best`` written by either package's trainer is the
    ``checkpointfile`` of both packages' dense searchers: the same hits."""
    import json

    from capreolus_tpu.reranker import Reranker as JaxReranker
    from capreolus_tpu_torch.reranker import Reranker as TorchReranker

    cfg = {"pretrained": "tiny", "allowrandominit": True,
           "extractor": {"maxqlen": 8, "maxdoclen": 32, "tokenizer": OFFLINE_TOKENIZER,
                         "index": {"collection": world["coll"]}}}
    path = world["tmp"] / writer / "dev.best"
    path.parent.mkdir()
    if writer == "port":
        rr = TorchReranker.create("biencoder", json.loads(json.dumps(cfg)))
        rr.trainer.save_checkpoint(path, rr.init_params(7), None, rr)
    else:
        rr = JaxReranker.create("biencoder", json.loads(json.dumps(cfg)))
        batch = {"query": np.ones((1, 8), np.int64), "posdoc": np.ones((1, 32), np.int64)}
        rr.trainer.save_checkpoint(path, rr.init_params(jax.random.PRNGKey(7), batch), {}, rr)
    ckpt = str(path) + ".params"
    port = port_searcher(world, checkpointfile=ckpt, hits=30)
    jx = jax_searcher(world, checkpointfile=ckpt, hits=30)
    port_run = load_run(port.query_from_file(world["topics"], world["tmp"] / f"p_{writer}"))
    jax_run = load_run(jx.query_from_file(world["topics"], world["tmp"] / f"j_{writer}"))
    assert_runs_agree(port_run, jax_run, SEARCH_TOL, f"{writer} dev.best")
