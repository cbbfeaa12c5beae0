"""One TF32 policy on the card: with ``torch.backends.cuda.matmul.allow_tf32``
set True by the caller (as ``torch.set_float32_matmul_precision("high")``
sets it), a BERT reranker's served scores, a training step's loss and
gradients and the dense searcher's query embeddings equal the same runs with
the flag False, because every f32 path runs under
``reranker.common.matmul_f32``; the caller's flag is left as it was. Needs
an NVIDIA GPU: each test skips itself without one. Imports neither JAX nor
the JAX package (the card's machine has neither).

Tolerance: 1e-6 of each tensor's largest entry. Both runs compute IEEE f32
(a TF32 product rounds its inputs to 10 mantissa bits: errors near 1e-3 of
the scale); only the order of atomic sums in an embedding table's gradient
may differ between two runs.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu_torch

capreolus_tpu_torch.load_all_modules()

TOL = 1e-6


@pytest.fixture
def card(tmp_path, monkeypatch):
    from capreolus_tpu_torch.core import constants

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the TF32 flag acts on the card's matmuls only")
    monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / "cache")
    saved = torch.backends.cuda.matmul.allow_tf32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def both_ways(fn):
    """fn() with the TF32 flag True, then False; checks the flag is left as set."""
    out = {}
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = flag
        out[flag] = fn()
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    return out[True], out[False]


def assert_close_to_scale(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1e-30, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def bert_reranker(tmp_path, name="bert-base-uncased"):
    from chip_smoke import seeded_bert_params

    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.reranker.bert import get_bert_config

    ckpt = save_params(seeded_bert_params(get_bert_config(name), seed=4, std=0.05), tmp_path / "bert.npz")
    reranker = Reranker.create("BERTMaxP", {"pretrained": name, "allowrandominit": True, "hidden_dropout_prob": 0.0,
                                            "trainer": {"batch": 2},
                                            "extractor": {"index": {"collection": {"name": "dummy"}}}})
    return reranker, str(ckpt)


@pytest.mark.cuda
def test_bert_reranking_service_ignores_the_tf32_flag(card, tmp_path):
    from capreolus_tpu_torch.serving import RerankingService

    reranker, ckpt = bert_reranker(tmp_path)
    svc = RerankingService(reranker.extractor.index, reranker, ckpt, topn=3, device="cuda")
    on, off = both_ways(lambda: svc.search(["galaxies collide", "whales in the ocean"], k=3))
    for a, b in zip(on, off):
        assert [d for d, _ in a] == [d for d, _ in b]
        assert_close_to_scale([s for _, s in a], [s for _, s in b], "served BERT-base scores")


@pytest.mark.cuda
def test_training_step_ignores_the_tf32_flag(card, tmp_path):
    import copy

    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    reranker, _ = bert_reranker(tmp_path, "tiny")
    extractor = reranker.extractor
    extractor.preprocess(["q"], ["D001", "D002", "D003"], {"q": "galaxies collide"})
    samples = [extractor.id2vec("q", d, negid=n, label=[1, 0]) for d, n in (("D001", "D002"), ("D003", "D002"))]
    batches = {k: np.asarray(v)[None] for k, v in collate(samples, ARRAY_KEYS).items()}
    init = reranker.init_params(0)
    trainer = reranker.trainer
    trainer.device = "cuda"

    def step():
        model = copy.deepcopy(init).to(card)
        reranker.model = model
        optimizer = trainer.make_optimizer(reranker, model)
        loss = float(trainer.train_step(reranker, model, optimizer, batches, 0, trainer.step_seed(0, 0)))
        return loss, {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters() if p.grad is not None}

    (loss_on, grads_on), (loss_off, grads_off) = both_ways(step)
    assert abs(loss_on - loss_off) <= TOL * abs(loss_off)
    assert grads_off and set(grads_on) == set(grads_off)
    for name in grads_off:
        assert_close_to_scale(grads_on[name], grads_off[name], f"gradient of {name}")


@pytest.mark.cuda
def test_dense_searcher_serves_with_the_tf32_flag_set(card):
    """The dense searcher refused the flag before; it now scopes it off."""
    from capreolus_tpu_torch.searcher import Searcher

    searcher = Searcher.create("dense", {"pretrained": "tiny", "maxdoclen": 32, "maxqlen": 8,
                                         "index": {"collection": {"name": "dummy"}}})
    searcher.device = "cuda"

    def run():
        topk, docs, _ = searcher.build_topk(3)
        q = searcher.embed_queries(["galaxies collide", "whales"])
        return q.cpu().numpy(), topk(q, docs)[1].cpu().numpy()

    (q_on, hits_on), (q_off, hits_off) = both_ways(run)
    assert_close_to_scale(q_on, q_off, "query embeddings")
    np.testing.assert_array_equal(hits_on, hits_off)
