"""The trainable ColBERT reranker of the PyTorch port (``reranker.name=colbert``
over the ``berttext`` extractor) against the JAX package on the CPU, and its
``dev.best`` served by either package's ``colbert`` searcher.

Tolerances:
- berttext features: equal.
- reranker scores from the JAX init: 1e-5 (the tiny f32 encoder's sums in
  other orders, as ``tests/test_torch_colbert.py``'s embeddings).
- training from a carried init: ``tests/test_torch_trainer.py``'s
  ``check_training_matches_jax`` (gradients 1e-5, Adam steps 1e-4 of the rate).
- a dev.best in the other package's searcher: the same docids in the same
  order, scores within 1e-2 (``tests/test_torch_colbert.py``'s SEARCH_TOL:
  bf16 MaxSim sums).
- JAX's quality gate (``tests/test_colbert.py::test_colbert_training_produces_useful_retriever``)
  on the port's trained checkpoint: recall@1000 1.0, MRR at least 0.75 and not
  below the untrained encoder's.
"""

import json

import jax
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.benchmark import Benchmark as JaxBenchmark  # noqa: E402
from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu_torch.benchmark import Benchmark as TorchBenchmark  # noqa: E402
from capreolus_tpu_torch.evaluation.metrics import eval_run  # noqa: E402
from capreolus_tpu_torch.ops import maxsim as ms  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.reranker.colbert import ColBERTModel  # noqa: E402
from capreolus_tpu_torch.sampler import Sampler as TorchSampler  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import (check_training_matches_jax, corpus, draw, jax_flat, make_rerankers,  # noqa: E402,F401
                                samplers)

SCORE_TOL = 1e-5
SEARCH_TOL = 1e-2
COLBERT = {"pretrained": "tiny", "allowrandominit": True, "dim": 8, "hidden_dropout_prob": 0.0,
           "extractor": {"maxqlen": 8, "maxdoclen": 32, "tokenizer": OFFLINE_TOKENIZER}}
SEARCHER = {"dim": 8, "maxdoclen": 32, "maxqlen": 8, "batch": 4, "tokenizer": OFFLINE_TOKENIZER,
            "index": {"collection": {"name": "dummy"}}}
DUMMY_RUN = {"301": {"D001": 2.0, "D002": 1.5, "D003": 1.0}, "302": {"D002": 2.0, "D001": 1.5, "D003": 1.0}}


def colbert_pair(corpus, **options):
    cfg = json.loads(json.dumps(COLBERT))
    cfg.update(options)
    return make_rerankers(corpus, "colbert", cfg)


@pytest.mark.parametrize("specialtokens", [True, False])
def test_berttext_features_equal_jax(corpus, specialtokens):
    cfg = {"maxqlen": 6, "maxdoclen": 20, "specialtokens": specialtokens, "tokenizer": OFFLINE_TOKENIZER,
           "index": {"collection": corpus["collection"]}}
    from capreolus_tpu.extractor import Extractor as JaxExtractor
    from capreolus_tpu_torch.extractor import Extractor as TorchExtractor

    jax_ext, port_ext = JaxExtractor.create("berttext", dict(cfg)), TorchExtractor.create("berttext", dict(cfg))
    for ext in (jax_ext, port_ext):
        ext.preprocess(list(corpus["run"]), corpus["docids"], corpus["topics"])
    assert port_ext.get_state() == jax_ext.get_state()
    qid = "401"
    docs = list(corpus["run"][qid])
    for pos, neg in zip(docs[:4], docs[1:5]):
        for negid in (neg, None):
            want = jax_ext.id2vec(qid, pos, negid, label=[1, 0], training=True)
            got = port_ext.id2vec(qid, pos, negid, label=[1, 0], training=True)
            assert sorted(got) == sorted(want)
            for key in ("query", "posdoc", "negdoc", "query_idf", "label"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
                assert got[key].dtype == want[key].dtype, key
            assert (got["qid"], got["posdocid"], got["negdocid"]) == (want["qid"], want["posdocid"], want["negdocid"])


def test_colbert_reranker_scores_match_jax(corpus):
    """``test`` (the prediction forward) and ``score`` (a training forward,
    dropout 0) from the JAX init; the extractor defaults to ``specialtokens``."""
    jax_rr, port_rr = colbert_pair(corpus)
    assert port_rr.extractor.config["specialtokens"] and jax_rr.extractor.config["specialtokens"]
    samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 6)
    batch = collate(samples, ARRAY_KEYS)
    params = jax_rr.init_params(jax.random.PRNGKey(3), jax_collate(samples, ARRAY_KEYS))
    model = port_rr.build_model()
    model.load_state_dict(port_rr.state_dict_from_params(jax_flat(params)))
    assert isinstance(model, ColBERTModel)
    want = np.asarray(jax_rr.test(params, batch))
    with torch.no_grad():
        got = port_rr.test(batch, torch.device("cpu")).numpy()
        pos, neg = port_rr.score(batch, torch.device("cpu"), dropout_seed=4)
    assert_within(got, want, SCORE_TOL, "ColBERT reranker test scores")
    jpos, jneg = jax_rr.score(params, batch, rngs={"dropout": jax.random.PRNGKey(0)})
    assert_within(pos.numpy(), np.asarray(jpos), SCORE_TOL, "ColBERT training forward, positives")
    assert_within(neg.numpy(), np.asarray(jneg), SCORE_TOL, "ColBERT training forward, negatives")


def test_colbert_training_matches_jax(corpus):
    """The encoder's pooler is not read by MaxSim: JAX's gradient of it is 0
    and the port computes none."""
    jax_rr, port_rr = colbert_pair(corpus, trainer={"batch": 4})
    check_training_matches_jax(corpus, jax_rr, port_rr, unused=("params/bert/pooler/kernel",
                                                                "params/bert/pooler/bias"))


def test_colbert_dropout_seeds_the_query_and_doc_encoders():
    """A training forward draws masks from its seed (the same seed, the same
    scores) with the query and doc encoders on streams of their own; no seed
    is the deterministic prediction forward."""
    from capreolus_tpu_torch.reranker.bert import get_bert_config

    model = ColBERTModel(get_bert_config("tiny"), dim=8)
    rng = np.random.Generator(np.random.PCG64(2))
    q = torch.from_numpy(rng.integers(3, 1000, size=(3, 8)))
    d = torch.from_numpy(rng.integers(3, 1000, size=(3, 24)))
    with torch.no_grad():
        a, b = model(q, d, dropout_seed=5), model(q, d, dropout_seed=5)
        assert torch.equal(a, b) and not torch.equal(a, model(q, d, dropout_seed=6))
        assert torch.equal(model(q, d), model(q, d))
        qa, _ = model.encode_query(q, 1)
        da, _ = model.encode_doc(q, 1)
        qb, _ = model.encode_query(q)
        assert not torch.equal(qa, qb)
        assert da.shape == qa.shape


def _train_port(tmp_path):
    """The port's ColBERT trained on the dummy benchmark with JAX's gate config."""
    benchmark = TorchBenchmark.create("dummy")
    reranker = TorchReranker.create("colbert", {
        "pretrained": "tiny", "allowrandominit": True, "dim": 8,
        "extractor": {"maxqlen": 8, "maxdoclen": 32, "index": {"collection": {"name": "dummy"}}},
        "trainer": {"niters": 6, "itersize": 16, "batch": 2, "validatefreq": 6},
    })
    reranker.extractor.preprocess(list(DUMMY_RUN), {d for docs in DUMMY_RUN.values() for d in docs},
                                  benchmark.topics[benchmark.query_type])
    sampler = TorchSampler.create("triplet")
    sampler.prepare(DUMMY_RUN, benchmark.qrels, reranker.extractor)
    dev = TorchSampler.create("pred")
    dev.prepare(DUMMY_RUN, benchmark.qrels, reranker.extractor)
    reranker.trainer.device = "cpu"
    out = tmp_path / "t"
    reranker.trainer.train(reranker, sampler, out, dev, out / "d", benchmark.qrels, metric="map")
    return benchmark, reranker, out / "dev.best.params"


def test_colbert_training_produces_useful_retriever(tmpdir_as_cache, torch_cache, tmp_path):
    """JAX's retrieval-quality gate on the port: trained on the dummy fixtures,
    the ``colbert`` searcher over the port's dev.best reaches full recall,
    places the relevant docs decisively above random, and is no worse than the
    untrained encoder; no K3 launch (its CUDA wrapper) happens in training."""
    launches = ms.maxsim.launches
    benchmark, _, ckpt = _train_port(tmp_path)
    assert ms.maxsim.launches == launches
    assert ckpt.exists()
    base = {"dim": 8, "maxdoclen": 32, "maxqlen": 8, "batch": 4, "index": {"collection": {"name": "dummy"}}}
    topics = benchmark.topics[benchmark.query_type]
    wanted = ["recip_rank", "recall_1000"]

    def run_metrics(config):
        searcher = TorchSearcher.create("colbert", config)
        searcher.device = "cpu"
        searcher.index.create_index()
        run = {qid: searcher.query(topics[qid]) for qid in ("301", "302")}
        return eval_run(run, benchmark.qrels, wanted, relevance_level=benchmark.relevance_level)

    metrics = run_metrics({**base, "checkpointfile": str(ckpt)})
    print(f"trained ColBERT: {metrics}")
    assert metrics["recall_1000"] == 1.0
    assert metrics["recip_rank"] >= 0.75, metrics
    untrained = run_metrics({**base, "allowrandominit": True})
    assert metrics["recip_rank"] >= untrained["recip_rank"] - 1e-9


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dev_best_serves_in_both_searchers(tmpdir_as_cache, torch_cache, tmp_path, writer):
    """A ColBERT dev.best written by either package's trainer is the
    ``checkpointfile`` of both packages' ``colbert`` searchers, which return
    the same docids in the same order with scores within SEARCH_TOL. The port
    also takes the checkpoint's stem."""
    cfg = {"pretrained": "tiny", "allowrandominit": True, "dim": 8,
           "extractor": {"maxqlen": 8, "maxdoclen": 32, "tokenizer": OFFLINE_TOKENIZER,
                         "index": {"collection": {"name": "dummy"}}}}
    if writer == "port":
        port_rr = TorchReranker.create("colbert", json.loads(json.dumps(cfg)))
        port_rr.trainer.save_checkpoint(tmp_path / "dev.best", port_rr.init_params(7), None, port_rr)
    else:
        jax_rr = JaxReranker.create("colbert", json.loads(json.dumps(cfg)))
        batch = {"query": np.ones((1, 8), np.int64), "posdoc": np.ones((1, 32), np.int64)}
        params = jax_rr.init_params(jax.random.PRNGKey(7), batch)
        jax_rr.trainer.save_checkpoint(tmp_path / "dev.best", params, {}, jax_rr)
    ckpt = tmp_path / "dev.best.params"
    jax_searcher = JaxSearcher.create("colbert", {**SEARCHER, "checkpointfile": str(ckpt)})
    jax_searcher.index.create_index()
    benchmark = JaxBenchmark.create("dummy")
    for path in (ckpt, tmp_path / "dev.best"):
        searcher = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": str(path)})
        searcher.device = "cpu"
        for qid, query in benchmark.topics[benchmark.query_type].items():
            got, want = searcher.query(query), jax_searcher.query(query)
            assert list(got) == list(want), qid
            assert_within([got[d] for d in want], list(want.values()), SEARCH_TOL, f"{writer} dev.best, {qid}")


def test_searcher_refuses_a_checkpoint_without_colbert_weights(tmpdir_as_cache, torch_cache, tmp_path):
    from capreolus_tpu_torch.utils import flax_msgpack

    ckpt = tmp_path / "dev.best.params"
    ckpt.write_bytes(flax_msgpack.to_bytes({"params": {"classifier": {"kernel": np.zeros((2, 1), np.float32)}}}))
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": str(ckpt)})
    searcher.device = "cpu"
    with pytest.raises(ValueError, match="no 'bert' submodule"):
        searcher._encoder()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k3_refuses_tensors_that_require_grad(device):
    """K3 has no backward: its wrapper raises on a query that requires grad,
    whatever the device, before it looks at anything else."""
    q = torch.zeros((1, 2, 8), device=device, requires_grad=True)
    docs = torch.zeros((4, 3, 8), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="requires grad"):
        ms.maxsim(q, docs, torch.zeros((4, 3), device=device), torch.ones(3, dtype=torch.bool, device=device))
