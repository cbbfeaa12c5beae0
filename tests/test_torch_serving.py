"""Slice 1 as a whole: the PyTorch port's RetrievalService and RerankingService
against the JAX package's, on the CPU.

- BM25 retrieval on the dummy collection and on the 50k-doc golden corpus of
  tests/test_e2e_golden.py at k=1000: identical docids per query, scores within
  rtol 1e-6 (f32 on both sides; XLA's FMA contraction moves single scores by an
  ulp), and the run's MAP / nDCG@20 within the golden's 2e-3 of PARITY.md's pins.
- Retrieve-then-rerank with KNRM at its published width (random300, maxqlen 4,
  maxdoclen 800, topn 100, frozen kernels and embeddings) and weights carried
  from a JAX ``KNRMModel.init``: the same docids in the same order, scores
  within 2e-4 (the JAX suite's tolerance for KNRM pooling).
- Retrieve-then-rerank with BERTMaxP at the tiny config over bertpassage
  features, weights saved by the JAX trainer: the same docids in the same
  order, scores within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu.evaluation import eval_runs  # noqa: E402
from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu.serving import RerankingService as JaxRerankingService  # noqa: E402
from capreolus_tpu.serving import RetrievalService as JaxRetrievalService  # noqa: E402
from capreolus_tpu_torch.convert import save_params  # noqa: E402
from capreolus_tpu_torch.core import constants as torch_constants  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.serving import RerankingService, RetrievalService  # noqa: E402
# sibling test modules are imported under the names pytest gives them (tests/
# is on sys.path): a second copy of a module that registers modules at import
# (test_e2e_golden's collection reads its own module state) would replace them
from test_e2e_golden import GOLDEN, TOL as GOLDEN_TOL, _build_corpus  # noqa: E402
from test_torch_index import torch_cache, write_trec_corpus  # noqa: E402,F401
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_knrm import flatten_params  # noqa: E402

SCORE_RTOL = 1e-6
RERANK_TOL = 2e-4
BERT_TOL = 1e-4


def assert_same_hits(port_results, jax_results, rtol):
    assert len(port_results) == len(jax_results)
    for port_hits, jax_hits in zip(port_results, jax_results):
        assert [d for d, _ in port_hits] == [d for d, _ in jax_hits]
        np.testing.assert_allclose([s for _, s in port_hits], [s for _, s in jax_hits], rtol=rtol, atol=rtol)


def test_retrieval_service_matches_jax_on_dummy(tmpdir_as_cache, torch_cache):
    queries = ["galaxies collide", "whales in the ocean", "zzzzqqqq"]
    jax_svc = JaxRetrievalService.from_config(collection="dummy")
    port_svc = RetrievalService.from_config(collection="dummy", device="cpu")
    port_results = port_svc.search(queries, k=2)
    assert port_results[0][0][0] == "D003" and port_results[1][0][0] == "D002" and port_results[2] == []
    assert_same_hits(port_results, jax_svc.search(queries, k=2), SCORE_RTOL)
    assert port_svc.get_document("D003") == jax_svc.get_document("D003")
    # dispatch/collect split: two dispatches in flight before either collects
    c1, c2 = port_svc.search_async(queries[:1], k=3), port_svc.search_async(queries[1:2], k=3)
    assert c1() + c2() == port_svc.search(queries[:2], k=3)


def test_services_default_to_cuda_and_raise_without_a_card(torch_cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    index = TorchIndex.create("tpu", {"collection": {"name": "dummy"}})
    with pytest.raises(RuntimeError, match="cuda"):
        RetrievalService(index)
    with pytest.raises(RuntimeError, match="cuda"):
        RetrievalService(index, device="cuda")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The JAX suite's 50k-doc golden corpus, served by both packages."""
    base = tmp_path_factory.mktemp("torch_golden")
    docs, topics, qrels = _build_corpus()
    corpus = base / "corpus"
    corpus.mkdir()
    per_file = len(docs) // 4
    for f in range(4):
        with open(corpus / f"part{f}.trec", "wt", encoding="utf-8") as fh:
            for docid, text in docs[f * per_file:(f + 1) * per_file]:
                fh.write(f"<DOC>\n<DOCNO>{docid}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")
    saved_jax, saved_torch = jax_constants["CACHE_BASE_PATH"], torch_constants["CACHE_BASE_PATH"]
    jax_constants["CACHE_BASE_PATH"] = base / "jax_cache"
    torch_constants["CACHE_BASE_PATH"] = base / "torch_cache"
    try:
        params = {"k1": 0.9, "b": 0.4}
        qids = sorted(topics)
        queries = [topics[q] for q in qids]
        jax_svc = JaxRetrievalService.from_config(collection="dummy", collection_path=str(corpus), params=params)
        port_svc = RetrievalService.from_config(collection="dummy", collection_path=str(corpus), params=params,
                                                device="cpu")
        yield {"qids": qids, "qrels": qrels, "jax": jax_svc.search(queries, k=1000),
               "port": port_svc.search(queries, k=1000)}
    finally:
        jax_constants["CACHE_BASE_PATH"] = saved_jax
        torch_constants["CACHE_BASE_PATH"] = saved_torch


def test_golden_bm25_run_identical_to_jax_service(golden):
    assert all(hits for hits in golden["port"]) and max(len(hits) for hits in golden["port"]) == 1000
    assert_same_hits(golden["port"], golden["jax"], SCORE_RTOL)


@pytest.mark.parametrize("metric", ["map", "ndcg_cut_20"])
def test_golden_bm25_metrics_match_pins(golden, metric):
    run = {qid: dict(hits) for qid, hits in zip(golden["qids"], golden["port"])}
    jax_run = {qid: dict(hits) for qid, hits in zip(golden["qids"], golden["jax"])}
    score = eval_runs(run, golden["qrels"], [metric])[metric]
    assert score == pytest.approx(eval_runs(jax_run, golden["qrels"], [metric])[metric], abs=1e-9)
    assert score == pytest.approx(GOLDEN["BM25"][metric], abs=GOLDEN_TOL)


def _knrm_config(collection):
    return {"gradkernels": False, "finetune": False,
            "extractor": {"embeddings": "random300", "maxqlen": 4, "maxdoclen": 800,
                          "index": {"collection": collection}}}


def test_reranking_service_matches_jax(tmpdir_as_cache, torch_cache):
    corpus = tmpdir_as_cache / "corpus"
    write_trec_corpus(corpus, num_docs=400, seed=21, min_len=100, max_len=1100)
    coll = {"name": "dummy", "path": str(corpus)}
    queries = ["galaxy telescope w3", "whale ocean gravity", "running hopeful w17 w42", "the orbit launch"]

    jax_reranker = JaxReranker.create("KNRM", _knrm_config(coll))
    jax_index = capreolus_tpu.index.Index.create("tpu", {"collection": coll})
    ckpt = tmpdir_as_cache / "knrm" / "weights"
    jax_svc = JaxRerankingService(jax_index, jax_reranker, ckpt, topn=100)
    # weights from a JAX init (seeded), saved as the JAX trainer saves them:
    # frozen leaves (embedding, mus, sigmas) stripped
    example = {"query": np.zeros((1, 4), np.int64), "posdoc": np.zeros((1, 800), np.int64),
               "query_idf": np.zeros((1, 4), np.float32)}
    params = jax_reranker.init_params(jax.random.PRNGKey(123), example)
    jax_reranker.trainer.save_checkpoint(ckpt, params, {}, jax_reranker)
    port_ckpt = save_params(flatten_params(jax_reranker.trainer._strip_frozen(jax_reranker, params)),
                            tmpdir_as_cache / "knrm.npz")

    port_reranker = TorchReranker.create("KNRM", _knrm_config(coll))
    port_index = TorchIndex.create("tpu", {"collection": coll})
    port_svc = RerankingService(port_index, port_reranker, port_ckpt, topn=100, device="cpu")
    np.testing.assert_array_equal(port_reranker.extractor.embeddings, jax_reranker.extractor.embeddings)

    port_results = port_svc.search(queries, k=100)
    jax_results = jax_svc.search(queries, k=100)
    assert all(len(hits) > 10 for hits in port_results)
    assert_same_hits(port_results, jax_results, RERANK_TOL)
    # k below topn: the same reranked head
    assert port_svc.search(queries[:1], k=5) == [port_results[0][:5]]


def test_bert_reranking_service_matches_jax(tmpdir_as_cache, torch_cache):
    coll = {"name": "dummy"}
    config = {"pretrained": "tiny", "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER,
                                                      index={"collection": coll})}
    queries = ["distant galaxies telescope", "telescope observed whales", "galaxies in orbit"]

    jax_reranker = JaxReranker.create("BERTMaxP", config)
    jax_index = capreolus_tpu.index.Index.create("tpu", {"collection": coll})
    ckpt = tmpdir_as_cache / "bert" / "weights"
    jax_svc = JaxRerankingService(jax_index, jax_reranker, ckpt, topn=3)
    shape = (1, EXTRACTOR_TINY["numpassages"], EXTRACTOR_TINY["maxseqlen"])
    example = {key: np.zeros(shape, np.int64) for key in ("pos_bert_input", "pos_mask", "pos_seg")}
    params = jax_reranker.init_params(jax.random.PRNGKey(123), example)
    jax_reranker.trainer.save_checkpoint(ckpt, params, {}, jax_reranker)
    port_ckpt = save_params(flatten_params(jax_reranker.trainer._strip_frozen(jax_reranker, params)),
                            tmpdir_as_cache / "bert.npz")

    port_reranker = TorchReranker.create("BERTMaxP", config)
    port_index = TorchIndex.create("tpu", {"collection": coll})
    port_svc = RerankingService(port_index, port_reranker, port_ckpt, topn=3, device="cpu")
    port_results = port_svc.search(queries, k=3)
    jax_results = jax_svc.search(queries, k=3)
    assert all(len(hits) >= 2 for hits in port_results)
    assert_same_hits(port_results, jax_results, BERT_TOL)
    assert_within([s for hits in port_results for _, s in hits], [s for hits in jax_results for _, s in hits],
                  BERT_TOL, "BERTMaxP tiny RerankingService scores")
    stages = port_svc.last_stage_ms
    assert set(stages) == {"first_stage", "rerank", "features"} and 0 < stages["features"] <= stages["rerank"]


def _parameters(fn):
    import inspect

    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("name", ["RetrievalService.__init__", "RetrievalService.from_config",
                                  "RerankingService.__init__"])
def test_service_signatures_take_the_jax_parameters_in_the_jax_order(name):
    """The JAX parameters come first, in the JAX order, with the JAX defaults,
    so a positional caller of the reference binds the same meanings; ``device``
    follows, keyword-only (``from_config`` passes it on by keyword)."""
    cls, method = name.split(".")
    jax_params = [p for p in _parameters(getattr(getattr(capreolus_tpu.serving, cls), method))
                  if p.kind is not p.VAR_KEYWORD]
    port_params = _parameters(getattr(getattr(capreolus_tpu_torch.serving, cls), method))
    assert [(p.name, p.kind, p.default) for p in port_params[:len(jax_params)]] == \
        [(p.name, p.kind, p.default) for p in jax_params]
    device = next(p for p in port_params if p.name == "device")
    assert device.default is None and port_params.index(device) == len(jax_params)
    if method == "__init__":
        assert device.kind is device.KEYWORD_ONLY


def test_retrieval_service_binds_positional_arguments_as_jax(torch_cache):
    index = TorchIndex.create("tpu", {"collection": {"name": "dummy"}})
    args = (index, "bm25", {"k1": 1.2, "b": 0.75}, 32, 500.0, False, 1)
    svc = RetrievalService(*args, device="cpu")
    assert (svc.model, svc.params, svc.batch_size, svc._hbm_budget_mb, svc.pruning, svc.shards) == \
        ("bm25", {"k1": 1.2, "b": 0.75}, 32, 500.0, False, 1)
    # the budget changes nothing on the exact resident path
    queries = ["galaxies collide", "whales in the ocean"]
    assert svc.search(queries, k=3) == RetrievalService(index, params={"k1": 1.2, "b": 0.75},
                                                        device="cpu").search(queries, k=3)
    with pytest.raises(TypeError):  # device is keyword-only: an eighth positional argument is refused
        RetrievalService(*args, "cpu")


@pytest.mark.parametrize("how", ["constructor", "from_config"])
def test_sharded_serving_raises_config_error(torch_cache, how):
    from capreolus_tpu_torch.core import ConfigError

    with pytest.raises(ConfigError, match="item 6, 'Multi-device'"):
        if how == "constructor":
            RetrievalService(TorchIndex.create("tpu", {"collection": {"name": "dummy"}}), shards=2, device="cpu")
        else:
            RetrievalService.from_config(collection="dummy", shards=2, device="cpu")


def test_reranking_service_refuses_an_extractor_state_path(torch_cache, tmp_path):
    """The fifth positional parameter, as in JAX, is the extractor state the
    service restores (``tests/test_torch_rerank.py`` serves a trained one): a
    path that holds none is refused before any weights load."""
    index = TorchIndex.create("tpu", {"collection": {"name": "dummy"}})
    reranker = TorchReranker.create("KNRM", _knrm_config({"name": "dummy"}))
    with pytest.raises(FileNotFoundError, match="extractor_state"):
        RerankingService(index, reranker, tmp_path / "knrm.npz", 10, str(tmp_path / "extractor_state"),
                         device="cpu")
    with pytest.raises(TypeError):
        RerankingService(index, reranker, tmp_path / "knrm.npz", 10, None, "cpu")
