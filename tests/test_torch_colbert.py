"""Slice 3 module by module and as a whole: the PyTorch port's MaxSim (K3's
plain version), ColBERT model, late-interaction searcher and
``ColbertRetrievalService`` against the JAX package, on the CPU.

Tolerances (stated per test; ``pytest -s`` prints each measured error):
- MaxSim at equal inputs, 1e-4: both sides round q and docs to bf16 and take
  exact f32 products; only the order of the f32 sums differs. ``-inf`` entries
  (invalid docs) must match exactly.
- ColBERT embeddings from the same weights, 1e-5 at the tiny config and 1e-4 at
  BERT-base width (one layer): f32 encoders whose LayerNorm variance and
  matmul sums run in other orders; per-pair MaxSim scores 1e-4 and 1e-3.
- f32 -> f16 -> bf16 corpus conversion: bit-identical.
- Searcher and service scores, 1e-2: the JAX suite's own tolerance for bf16
  MaxSim sums (``tests/test_colbert.py``), since query embeddings that differ
  by f32 rounding can round to neighbouring bf16 values; docids in the same
  order. The f16 doc-embedding caches agree within 1e-3 (one f16 step near 1)
  and their masks exactly.

Both sides use the hash-wordpiece tokenizer: the JAX berttokenizer is given a
``pretrained`` name that cannot exist, so that it takes the same offline
branch as the port.
"""

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

from capreolus_tpu.ops.maxsim import maxsim_scores as jax_maxsim_scores  # noqa: E402
from capreolus_tpu.ops.maxsim import maxsim_scores_ref as jax_maxsim_scores_ref  # noqa: E402
from capreolus_tpu.reranker.bert import BertConfig as JaxBertConfig  # noqa: E402
from capreolus_tpu.reranker.colbert import ColBERTModel as JaxColBERTModel  # noqa: E402
from capreolus_tpu.reranker.colbert import insert_marker as jax_insert_marker  # noqa: E402
from capreolus_tpu.reranker.colbert import maxsim as jax_pair_maxsim  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.serving import ColbertRetrievalService as JaxColbertService  # noqa: E402
from capreolus_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from capreolus_tpu.utils import caching as jax_caching  # noqa: E402
from capreolus_tpu.utils.trec import load_trec_run as jax_load_trec_run  # noqa: E402
from capreolus_tpu.utils.trec import write_trec_run as jax_write_trec_run  # noqa: E402
from capreolus_tpu_torch.convert import bert_state_dict, save_params  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.ops import maxsim as ms  # noqa: E402
from capreolus_tpu_torch.reranker.bert import BertConfig  # noqa: E402
from capreolus_tpu_torch.reranker.colbert import DOC_MARKER, MASK_ID, QUERY_MARKER, ColBERTModel  # noqa: E402
from capreolus_tpu_torch.reranker.colbert import insert_marker, maxsim as pair_maxsim  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from capreolus_tpu_torch.searcher.late_interaction import topk_lower_ordinal_first  # noqa: E402
from capreolus_tpu_torch.serving import ColbertRetrievalService  # noqa: E402
from capreolus_tpu_torch.tokenizer import Tokenizer as TorchTokenizer  # noqa: E402
from capreolus_tpu_torch.utils import caching  # noqa: E402
from capreolus_tpu_torch.utils.trec import load_trec_run, write_trec_run  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER, VOCAB, assert_within  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_knrm import flatten_params  # noqa: E402

MAXSIM_TOL = 1e-4
SEARCH_TOL = 1e-2
CACHE_TOL = 1e-3
TINY = JaxBertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)
TINY_TORCH = BertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)
SEARCHER = {"dim": 8, "maxdoclen": 32, "maxqlen": 8, "batch": 4, "tokenizer": OFFLINE_TOKENIZER,
            "index": {"collection": {"name": "dummy"}}}
QUERIES = ["telescope galaxies", "whales in the ocean", "galaxies collide", "orbit launch telescope observed"]


# ---------------------------------------------------------------- MaxSim (K3's plain version)
def maxsim_case(n_q, lq, ld, c, dim, seed, masked_docs=(4,)):
    """q [Q, Lq, dim], docs [C, Ld, dim] f32 and an int8 mask [C, Ld] with
    ragged holes and fully masked docs, as in the JAX suite's kernel test; the
    embeddings are L2-normalised, as ColBERT's are, so a score is at most Lq."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def unit(*shape):
        x = rng.standard_normal(shape)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    q, docs = unit(n_q, lq, dim), unit(c, ld, dim)
    mask = (rng.random((c, ld)) > 0.3).astype(np.int8)
    for d in masked_docs:
        if d < c:
            mask[d] = 0
    return q, docs, mask


def port_inputs(q, docs, mask):
    """The token-major arguments of ``maxsim_scores``, built as the JAX test builds them."""
    docs_t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(docs, 0, 1)))
    bias_t = torch.from_numpy(np.where(mask.T > 0, 0.0, -1e9).astype(np.float32))
    return torch.from_numpy(q), docs_t, bias_t, torch.from_numpy(mask.any(axis=1))


def assert_maxsim_equal(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=f"{what}: -inf entries")
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    assert_within(got[finite], want[finite], tol, what)


MAXSIM_SHAPES = [(3, 5, 7, 11, 24), (1, 32, 40, 9, 128), (2, 3, 1, 5, 8)]


@pytest.mark.parametrize("shape", MAXSIM_SHAPES)
def test_maxsim_scores_matches_jax_reference(shape):
    q, docs, mask = maxsim_case(*shape, seed=sum(shape))
    want = np.asarray(jax_maxsim_scores_ref(jnp.asarray(q), jnp.asarray(docs), jnp.asarray(mask)))
    got = ms.maxsim_scores(*port_inputs(q, docs, mask)).numpy()
    assert_maxsim_equal(got, want, MAXSIM_TOL, f"maxsim_scores vs JAX maxsim_scores_ref {shape}")
    ref = ms.maxsim_scores_ref(torch.from_numpy(q), torch.from_numpy(docs), torch.from_numpy(mask)).numpy()
    assert_maxsim_equal(ref, want, MAXSIM_TOL, f"port maxsim_scores_ref vs JAX {shape}")


@pytest.mark.parametrize("shape", MAXSIM_SHAPES)
def test_maxsim_scores_matches_pallas_kernel_interpret(shape):
    q, docs, mask = maxsim_case(*shape, seed=sum(shape) + 1)
    jq, docs_t, bias_t, valid = (jnp.asarray(x.numpy()) for x in port_inputs(q, docs, mask))
    want = np.asarray(jax_maxsim_scores(jq, docs_t, bias_t, valid, interpret=True, block_docs=8))
    got = ms.maxsim_scores(*port_inputs(q, docs, mask)).numpy()
    assert_maxsim_equal(got, want, MAXSIM_TOL, f"maxsim_scores vs Pallas (interpret) {shape}")


def test_maxsim_plain_slices_the_corpus(monkeypatch):
    """The plain version scores the docs in slices that keep its similarity
    tensor bounded; the slice size changes no result."""
    q, docs, mask = maxsim_case(2, 5, 7, 23, 16, seed=3, masked_docs=(0, 22))
    args = port_inputs(q, docs, mask)
    whole = ms.maxsim_scores_plain(*args)
    monkeypatch.setattr(ms, "PLAIN_CHUNK_ELEMENTS", 2 * 5 * 7 * 3)  # 3 docs per slice
    sliced = ms.maxsim_scores_plain(*args)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    assert np.isneginf(sliced.numpy()[:, [0, 22]]).all()


def test_cpu_maxsim_never_takes_the_kernel(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the CUDA binding was called for CPU tensors")

    monkeypatch.setattr(ms, "maxsim", boom)
    args = port_inputs(*maxsim_case(2, 4, 6, 5, 8, seed=4))
    torch.testing.assert_close(ms.maxsim_scores(*args), ms.maxsim_scores_plain(*args))


def test_maxsim_raises_off_cpu_and_cuda():
    meta = [torch.empty(s, device="meta") for s in ((1, 2, 8), (3, 4, 8), (3, 4))]
    with pytest.raises(ValueError, match="unsupported device"):
        ms.maxsim_scores(*meta, torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ms.maxsim(*port_inputs(*maxsim_case(1, 2, 3, 4, 8, seed=5)))


# ---------------------------------------------------------------- ColBERT model
def test_marker_insertion_and_query_augmentation_match_jax():
    rng = np.random.Generator(np.random.PCG64(6))
    toks = rng.integers(1000, 30522, size=(3, 8)).astype(np.int32)
    toks[:, 0] = 101
    toks[0, 4:], toks[1, 6:] = 0, 0
    toks[0, 3], toks[1, 5], toks[2, 7] = 102, 102, 102
    toks = np.concatenate([toks, np.array([[101, 7, 8, 9, 102, 0, 0, 0]], np.int32)])
    for marker in (QUERY_MARKER, DOC_MARKER):
        want = np.asarray(jax_insert_marker(jnp.asarray(toks), marker))
        got = insert_marker(torch.from_numpy(toks), marker).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-1], [101, DOC_MARKER, 7, 8, 9, 102, 0, 0])
    q = insert_marker(torch.from_numpy(toks), QUERY_MARKER)
    aug = torch.where(q == 0, MASK_ID, q)
    assert bool((aug != 0).all()) and int(aug[-1, -1]) == MASK_ID


def colbert_pair(jax_cfg, port_cfg, dim, ld, lq, seed, vocab):
    """JAX ColBERTModel params from ``init``, the port's model loaded from them
    through ``convert``, and query / doc ids ([CLS] ... [SEP] then pads)."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def ids(n, length):
        out = np.zeros((n, length), np.int32)
        for i, m in enumerate(rng.integers(3, length + 1, size=n)):
            out[i, :m] = rng.integers(1000, vocab, size=m)
            out[i, 0], out[i, m - 1] = 101, 102
        return out

    qtoks, dtoks = ids(3, lq), ids(3, ld)
    jax_model = JaxColBERTModel(jax_cfg, dim=dim)
    variables = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(qtoks), jnp.asarray(dtoks))
    model = ColBERTModel(port_cfg, dim=dim)
    model.load_state_dict(bert_state_dict(flatten_params(variables)))
    return jax_model, variables, model.eval(), qtoks, dtoks


@pytest.mark.parametrize("width", ["tiny", "base-1-layer"])
def test_colbert_model_matches_jax(width):
    if width == "tiny":
        args = (TINY, TINY_TORCH, 8, 32, 8, 21, 5000)
        emb_tol, score_tol = 1e-5, 1e-4
    else:  # BERT-base width, one layer, dim 128, Ld 180
        args = (JaxBertConfig(num_layers=1), BertConfig(num_layers=1), 128, 180, 32, 22, 30522)
        emb_tol, score_tol = 1e-4, 1e-3
    jax_model, variables, model, qtoks, dtoks = colbert_pair(*args)
    jq, _ = jax_model.apply(variables, jnp.asarray(qtoks), method=JaxColBERTModel.encode_query)
    jd, jmask = jax_model.apply(variables, jnp.asarray(dtoks), method=JaxColBERTModel.encode_doc)
    with torch.inference_mode():
        q, none = model.encode_query(torch.from_numpy(qtoks))
        d, mask = model.encode_doc(torch.from_numpy(dtoks))
        scores = model(torch.from_numpy(qtoks), torch.from_numpy(dtoks))
    assert none is None
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert_within(q.numpy(), jq, emb_tol, f"ColBERT {width} query embeddings")
    assert_within(d.numpy(), jd, emb_tol, f"ColBERT {width} doc embeddings")
    want = np.asarray(jax_model.apply(variables, jnp.asarray(qtoks), jnp.asarray(dtoks)))
    assert_within(scores.numpy(), want, score_tol, f"ColBERT {width} per-pair MaxSim")
    # the per-pair maxsim alone, on identical embeddings
    same = np.asarray(jax_pair_maxsim(jq, jd, jmask))
    got = pair_maxsim(*(torch.from_numpy(np.array(x)) for x in (jq, jd, jmask))).numpy()
    assert_within(got, same, 1e-5, f"per-pair maxsim {width} on equal embeddings")


# ---------------------------------------------------------------- corpus precision
def test_corpus_f16_then_bf16_rounding_is_bit_identical_to_jax():
    """The doc cache holds f16; the device corpus is its bf16 rounding. Values
    across f16's range, ties and subnormals included."""
    rng = np.random.Generator(np.random.PCG64(7))
    f32 = np.concatenate([rng.standard_normal(20000).astype(np.float32) * s for s in (1e-6, 1e-3, 0.05, 1.0, 300.0)])
    f32 = np.concatenate([f32, np.float32([0.0, -0.0, 6.1e-5, 5.96e-8, 65504.0, 1.00390625, 1.01171875])])
    f16 = f32.astype(np.float16)  # the cache's rounding, as the JAX searcher writes it
    want = np.asarray(jnp.asarray(f16, dtype=jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(f16).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_upload_is_the_jax_corpus_token_major(torch_cache):
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "allowrandominit": True})
    searcher.device = "cpu"
    rng = np.random.Generator(np.random.PCG64(8))
    emb = (rng.standard_normal((5, 6, 8)) * 0.3).astype(np.float16)
    mask = (rng.random((5, 6)) > 0.3).astype(np.int8)
    mask[2] = 0
    docs_t, bias_t, valid = searcher._upload(emb, mask)
    want = np.asarray(jnp.asarray(emb, dtype=jnp.bfloat16)).view(np.uint16).transpose(1, 0, 2)
    np.testing.assert_array_equal(docs_t.view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(bias_t.numpy(), np.where(mask.T > 0, 0.0, -1e9).astype(np.float32))
    np.testing.assert_array_equal(valid.numpy(), mask.any(axis=1))
    assert docs_t.is_contiguous() and bias_t.dtype == torch.float32 and valid.dtype == torch.bool


# ---------------------------------------------------------------- top-k order
def test_topk_ties_go_to_the_lower_ordinal_as_in_jax():
    rng = np.random.Generator(np.random.PCG64(9))
    scores = rng.integers(0, 5, size=(4, 40)).astype(np.float32)
    scores[1, ::3] = -np.inf
    scores[3] = 2.0
    for k in (1, 7, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
        got_v, got_i = topk_lower_ordinal_first(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------- searcher and service
def jax_tiny_checkpoint(jax_searcher, path):
    """The JAX searcher's own random-init variables, flattened and saved as
    the port's checkpoint."""
    _, variables = jax_searcher._encoder()
    return str(save_params(flatten_params(variables), path))


def assert_same_run(port_run, jax_run, what):
    assert list(port_run) == list(jax_run), what
    assert_within([port_run[d] for d in jax_run], list(jax_run.values()), SEARCH_TOL, what)


def test_searcher_matches_jax_on_dummy(tmpdir_as_cache, torch_cache):
    jax_searcher = JaxSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, "chunk": 2})
    jax_searcher.index.create_index()
    ckpt = jax_tiny_checkpoint(jax_searcher, torch_cache / "colbert.npz")
    runs = {}
    for chunk in (1, 2, 3):
        searcher = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": ckpt, "chunk": chunk})
        searcher.device = "cpu"
        runs[chunk] = searcher.query(QUERIES[0])
        assert len(runs[chunk]) == 3
    for chunk in (2, 3):
        assert runs[chunk] == runs[1]  # chunk changes no result
    assert_same_run(runs[1], jax_searcher.query(QUERIES[0]), "colbert searcher query vs JAX")

    # the f16 doc-embedding caches and their masks
    port_emb, jax_emb = np.load(searcher._doc_cache_file()), np.load(jax_searcher._doc_cache_file())
    assert port_emb.dtype == jax_emb.dtype == np.float16 and port_emb.shape == jax_emb.shape == (3, 32, 8)
    assert_within(port_emb, jax_emb, CACHE_TOL, "f16 doc-embedding cache vs JAX")
    np.testing.assert_array_equal(np.load(searcher._mask_file()), np.load(jax_searcher._mask_file()))
    assert searcher._doc_cache_file().parent.name == "colbert"
    assert np.asarray(searcher._tokenize(QUERIES, 8)).tolist() == np.asarray(jax_searcher._tokenize(QUERIES, 8)).tolist()


def test_searcher_query_from_file_matches_jax(tmpdir_as_cache, torch_cache):
    topics = torch_cache / "topics.tsv"
    topics.write_text("".join(f"q{i}\t{text}\n" for i, text in enumerate(QUERIES)), encoding="utf-8")
    config = {**SEARCHER, "batch": 3, "hits": 2}  # two query batches; fewer hits than docs
    jax_searcher = JaxSearcher.create("colbert", {**config, "allowrandominit": True})
    ckpt = jax_tiny_checkpoint(jax_searcher, torch_cache / "colbert.npz")
    searcher = TorchSearcher.create("colbert", {**config, "checkpointfile": ckpt})
    searcher.device = "cpu"
    out = searcher.query_from_file(topics, torch_cache / "run")
    jax_out = jax_searcher.query_from_file(topics, tmpdir_as_cache / "run")
    name = "searcher_colbert_dim-8"
    assert sorted(p.name for p in out.iterdir()) == ["done", name]
    port_run, jax_run = load_trec_run(out / name), jax_load_trec_run(jax_out / name)
    assert list(port_run) == list(jax_run) == [f"q{i}" for i in range(len(QUERIES))]
    for qid in jax_run:
        assert len(port_run[qid]) == 2
        assert_same_run(port_run[qid], jax_run[qid], f"query_from_file {qid}")
    # a second call is a done-file hit
    (out / name).unlink()
    searcher.query_from_file(topics, torch_cache / "run")
    assert not (out / name).exists()


def test_colbert_retrieval_service_matches_jax(tmpdir_as_cache, torch_cache):
    config = {key: value for key, value in SEARCHER.items() if key != "index"}
    jax_svc = JaxColbertService.from_config(collection="dummy", max_k=3, allowrandominit=True, **config)
    ckpt = jax_tiny_checkpoint(jax_svc.searcher, torch_cache / "colbert.npz")
    port_svc = ColbertRetrievalService.from_config(collection="dummy", max_k=3, device="cpu",
                                                   checkpointfile=ckpt, **config)
    queries = QUERIES + ["zzzz qqqq"]  # 5 queries: two batches of 4
    port_results, jax_results = port_svc.search(queries, k=3), jax_svc.search(queries, k=3)
    assert len(port_results) == len(jax_results) == 5
    for port_hits, jax_hits in zip(port_results, jax_results):
        assert len(port_hits) == 3
        assert_same_run(dict(port_hits), dict(jax_hits), "ColbertRetrievalService vs JAX")
    assert port_svc.search(queries[:1], k=2) == [port_results[0][:2]]
    c1, c2 = port_svc.search_async(queries[:1], k=3), port_svc.search_async(queries[1:2], k=3)
    assert c1() + c2() == port_results[:2]
    assert port_svc.get_document("D003") == jax_svc.get_document("D003")
    assert port_svc.searcher.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_svc.refresh()


def test_colbert_service_defaults_to_cuda_and_raises_without_a_card(torch_cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "allowrandominit": True})
    with pytest.raises(RuntimeError, match="cuda"):
        ColbertRetrievalService(searcher)
    with pytest.raises(RuntimeError, match="cuda"):
        searcher.query(QUERIES[0])  # the searcher alone never moves to the CPU either


def test_checkpoint_without_linear_raises(torch_cache):
    jax_model, variables, *_ = colbert_pair(TINY, TINY_TORCH, 8, 16, 8, 23, 1024)
    flat = {k: v for k, v in flatten_params(variables).items() if not k.startswith("params/linear/")}
    ckpt = save_params(flat, torch_cache / "bert_only.npz")
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": str(ckpt)})
    searcher.device = "cpu"
    with pytest.raises(ValueError, match="no 'linear' submodule"):
        searcher._encoder()


@pytest.mark.parametrize("options,match", [
    ({"quantize": "int8", "shards": 2}, "not ported"), ({"quantize": "int4", "prefilter": 2}, "exact engine only"),
    ({"prefilter": 2}, "not ported"), ({"shards": 2}, "not ported"),
    ({"quantize": "fp4"}, "must be 'none'"), ({"prefilter": 2, "shards": 2}, "single-device"),
    ({"dim": 0}, "must be positive"),
])
def test_unported_and_invalid_options_raise(options, match):
    with pytest.raises(ConfigError, match=match):
        TorchSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, **options})


def test_corpus_above_hbmbudget_raises(torch_cache):
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, "hbmbudget": 1e-4})
    searcher.device = "cpu"
    with pytest.raises(ConfigError, match="host streaming is not ported"):
        searcher.query(QUERIES[0])


# ---------------------------------------------------------------- helpers copied from the JAX package
def test_berttokenizer_ids_and_fingerprint_match_jax(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    for config in ({}, {"vocabfile": str(path)}):
        jax_tok = JaxTokenizer.create("berttokenizer", dict(OFFLINE_TOKENIZER, **config))
        port_tok = TorchTokenizer.create("berttokenizer", dict(OFFLINE_TOKENIZER, **config))
        for name in ("pad_id", "cls_id", "sep_id", "vocab_size", "fingerprint"):
            assert getattr(port_tok, name) == getattr(jax_tok, name), (config, name)
    assert port_tok.fingerprint.startswith("wordpiece:")


def test_trec_run_io_matches_jax(tmp_path):
    run = {"q10": {"d1": 1.5, "d2": 2.5, "d3": 2.5}, "q2": {"d9": -1.0}}
    assert write_trec_run(run, tmp_path / "port.run") == jax_write_trec_run(run, tmp_path / "jax.run") == 4
    assert (tmp_path / "port.run").read_text() == (tmp_path / "jax.run").read_text()
    assert load_trec_run(tmp_path / "port.run") == jax_load_trec_run(tmp_path / "jax.run")
    assert list(load_trec_run(tmp_path / "port.run")["q10"]) == ["d2", "d3", "d1"]


def test_cached_file_and_done_file_behave_as_in_jax(tmp_path):
    for module, sub in ((caching, "port"), (jax_caching, "jax")):
        target = tmp_path / sub / "a.bin"
        with module.cached_file(target, "wb") as f:
            f.write(b"first")
        with pytest.raises(module.TargetFileExists):
            with module.cached_file(target, "wb") as f:
                f.write(b"second")
        with pytest.raises(RuntimeError):
            with module.cached_file(tmp_path / sub / "b.bin", "wb") as f:
                raise RuntimeError("writer failed")
        assert sorted(p.name for p in target.parent.iterdir()) == ["a.bin"] and target.read_bytes() == b"first"
        calls = []
        for _ in range(2):
            with module.done_file(tmp_path / sub / "work") as already:
                calls.append(already)
        assert calls == [False, True]
