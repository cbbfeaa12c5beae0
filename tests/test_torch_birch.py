"""Birch (``birch``) in the port against the JAX package on the CPU: ``test``
scores with the weighted sum and the hidden combiner, top-k below and above
the passage count; int8 scores with JAX's stats; the training forward's loss,
gradients and Adam steps from the JAX init (dropout 0), with the encoder
frozen and fine-tuned; which weights train with and without a loaded NSP head;
a frozen encoder kept out of the optimizer and refilled when a ``dev.best``
loads, in the trainer and in ``RerankingService``; and a ``dev.best`` that
lacks a trainable parameter refused by ``RerankingService``, for every BERT
reranker. Tolerances are those of ``tests/torch_bert_rerankers_util.py``."""

import jax
import numpy as np
import pytest
import torch

from capreolus_tpu_torch.convert import flax_flat_params, load_params, save_params
from capreolus_tpu_torch.index import Index as TorchIndex
from capreolus_tpu_torch.reranker.bert_rerankers import BirchModel
from capreolus_tpu_torch.serving import RerankingService
from test_torch_checkpoint import write_nsp_checkpoint
from test_torch_index import torch_cache  # noqa: F401
from test_torch_trainer import _train, check_training_matches_jax, corpus, jax_flat, make_rerankers  # noqa: F401
from torch_bert_rerankers_util import (TRAIN_EXTRACTOR, bert_batch, check_int8_scores_match_jax,
                                       check_scores_match_jax, reranker_pair)

torch.set_num_threads(2)

BIRCH_CASES = [{"topk": 2, "hidden": 0}, {"topk": 2, "hidden": 8}, {"topk": 5, "hidden": 0}, {"topk": 5, "hidden": 8}]


def case_id(options):
    return "-".join(f"{k}{v}" for k, v in options.items())


@pytest.mark.parametrize("options", BIRCH_CASES, ids=case_id)
def test_birch_scores_match_jax(options):
    """3 passages a document: top-k of 2 takes two of them, of 5 takes all 3."""
    _, port_rr = check_scores_match_jax("birch", options, f"Birch {case_id(options)}")
    model = port_rr.model
    assert isinstance(model, BirchModel) and model.k == min(options["topk"], 3)
    if not options["hidden"]:
        np.testing.assert_allclose(model.topk_weights.detach().numpy(), 1.0 / model.k, rtol=1e-6)


def test_birch_int8_scores_match_jax():
    check_int8_scores_match_jax("birch", {"topk": 3}, "Birch int8, top 3 of 4")


def test_birch_extractor_keeps_every_passage_and_bert_large_tokenizer():
    from capreolus_tpu_torch.reranker import Reranker as TorchReranker

    port_rr = TorchReranker.create("birch", {"pretrained": "tiny", "extractor": {"index": {"collection": {"name": "dummy"}}}})
    assert port_rr.extractor.module_name == "birchbertpassage"
    assert port_rr.extractor.tokenizer.config["pretrained"] == "bert-large-uncased"
    assert port_rr.extractor.single_training_passage is False


@pytest.mark.parametrize("options", [{"finetune": True, "hidden": 0}, {"finetune": False, "hidden": 8},
                                     {"finetune": True, "hidden": 8, "topk": 2}], ids=case_id)
def test_birch_training_matches_jax(corpus, options):
    jax_rr, port_rr = make_rerankers(corpus, "birch", dict(
        options, pretrained="tiny", hidden_dropout_prob=0.0, extractor=TRAIN_EXTRACTOR,
        trainer={"batch": 2, "lr": 1e-3, "bertlr": 1e-3, "itersize": 8}))
    check_training_matches_jax(corpus, jax_rr, port_rr)


def _trainable_keys(rr, flat):
    return {k for k in flat if rr.trainable(tuple(k.split("/")), flat[k])}


@pytest.mark.parametrize("loaded", [False, True], ids=["random-head", "nsp-head"])
@pytest.mark.parametrize("finetune", [False, True])
def test_birch_trainable_sets_equal_jax(corpus, tmp_path, loaded, finetune):
    pretrained = "tiny"
    if loaded:
        write_nsp_checkpoint(tmp_path / "ckpt", safe=True, seed=6)
        pretrained = str(tmp_path / "ckpt")
    jax_rr, port_rr = make_rerankers(corpus, "birch", {"pretrained": pretrained, "finetune": finetune,
                                                       "extractor": TRAIN_EXTRACTOR})
    batch = bert_batch(2, 3, 64, qlen=5, seed=5, vocab=1024)
    want = jax_flat(jax_rr.init_params(jax.random.PRNGKey(0), batch))
    got = flax_flat_params(port_rr.init_params(0))
    assert set(got) == set(want)
    assert _trainable_keys(port_rr, got) == _trainable_keys(jax_rr, want)
    assert getattr(port_rr, "_nsp_head_loaded", False) == getattr(jax_rr, "_nsp_head_loaded", False) == loaded
    if loaded:  # the pretrained encoder and NSP head, equal to JAX's init_params
        for key in want:
            if key.startswith(("params/bert/", "params/relevance/")):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_birch_frozen_encoder_stays_out_of_the_optimizer_and_refills(corpus, tmp_path):
    """With a loaded checkpoint and finetune=False, only ``topk_weights``
    trains: dev.best holds the encoder and the NSP head empty, and a fresh
    trainer's ``load_best_model`` refills both from the checkpoint."""
    write_nsp_checkpoint(tmp_path / "ckpt", safe=False, seed=7)
    options = {"pretrained": str(tmp_path / "ckpt"), "extractor": TRAIN_EXTRACTOR,
               "trainer": {"niters": 1, "itersize": 4, "batch": 2, "lr": 0.05}}
    _, port_rr = make_rerankers(corpus, "birch", options)
    pretrained = flax_flat_params(port_rr.init_params(0))
    _train(port_rr, corpus, tmp_path / "run")
    optimizer = port_rr.trainer._optimizer
    assert [p.shape for g in optimizer.param_groups for p in g["params"]] == [(3,)]
    saved = load_params(tmp_path / "run" / "train" / "dev.best")
    assert {k for k, v in saved.items() if v.size} == {"params/topk_weights"}
    trained = flax_flat_params(port_rr.trainer._model)
    assert not np.array_equal(trained["params/topk_weights"], pretrained["params/topk_weights"])

    _, fresh = make_rerankers(corpus, "birch", options)
    fresh.trainer.device = "cpu"
    got = flax_flat_params(fresh.trainer.load_best_model(fresh, tmp_path / "run" / "train"))
    for key, value in got.items():
        np.testing.assert_array_equal(value, trained[key], err_msg=key)
        if key != "params/topk_weights":
            np.testing.assert_array_equal(value, pretrained[key], err_msg=key)


def _serve(reranker, ckpt):
    return RerankingService(TorchIndex.create("tpu", {"collection": {"name": "dummy"}}), reranker, ckpt, topn=3,
                            device="cpu")


@pytest.mark.parametrize("name,dropped", [("BERTMaxP", "params/classifier/kernel"),
                                          ("parade", "params/classifier/kernel"),
                                          ("CEDRKNRM", "params/combine/kernel"),
                                          ("birch", "params/relevance/kernel")])
def test_serving_refuses_a_checkpoint_lacking_a_trainable_parameter(torch_cache, tmp_path, name, dropped):
    """A ``dev.best`` without one trainable parameter is refused, never served
    with the model's own random init of it (Birch at ``tiny`` has no NSP head,
    so its ``relevance`` layer trains)."""
    _, port_rr = reranker_pair(name, {})
    flat = flax_flat_params(port_rr.init_params(0))
    assert dropped in flat
    ckpt = save_params({k: v for k, v in flat.items() if k != dropped}, tmp_path / "dev.best.npz")
    with pytest.raises(KeyError, match=dropped):
        _serve(reranker_pair(name, {})[1], ckpt)


def test_serving_refills_birchs_frozen_encoder_and_nsp_head(torch_cache, tmp_path):
    """A frozen Birch's ``dev.best`` holds ``topk_weights`` alone: the served
    model takes them, and its encoder and NSP head are the checkpoint's."""
    write_nsp_checkpoint(tmp_path / "ckpt", safe=True, seed=8)
    options = {"pretrained": str(tmp_path / "ckpt")}
    pretrained = flax_flat_params(reranker_pair("birch", options)[1].build_model())
    topk = np.asarray([0.5, 0.3, 0.2], np.float32)
    svc = _serve(reranker_pair("birch", options)[1], save_params({"params/topk_weights": topk},
                                                                 tmp_path / "dev.best.npz"))
    got = flax_flat_params(svc.reranker.model)
    assert set(got) == set(pretrained)
    for key, value in got.items():
        np.testing.assert_array_equal(value, topk if key == "params/topk_weights" else pretrained[key], err_msg=key)
    assert all(len(hits) == 3 for hits in svc.search(["distant galaxies telescope"], k=3))


def test_birch_reads_its_checkpoint_once(torch_cache, tmp_path, monkeypatch):
    """The encoder and the NSP head come from one read of the checkpoint,
    however many models the reranker builds and initialises."""
    from capreolus_tpu_torch.reranker.bert import checkpoint

    write_nsp_checkpoint(tmp_path / "ckpt", safe=False, seed=9)
    reads, read = [], checkpoint.read_state_dict
    monkeypatch.setattr(checkpoint, "read_state_dict", lambda directory: reads.append(directory) or read(directory))
    _, port_rr = reranker_pair("birch", {"pretrained": str(tmp_path / "ckpt")})
    port_rr.build_model()
    port_rr.init_params(0)
    port_rr.build_train_model()
    assert len(reads) == 1 and port_rr._nsp_head_loaded
