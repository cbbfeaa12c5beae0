"""The port's rerank task on the CPU (``capreolus_tpu_torch/task/rerank.py``):
``train`` / ``traineval`` / ``predict`` / ``evaluate`` on the dummy benchmark,
results paths equal to the JAX task's for the same config, the CLI with
``--device=cpu``, and ``RerankingService`` restoring a ``dev.best`` and its
``extractor_state.pkl`` as written by either trainer."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.task import Task as JaxTask  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.serving import RerankingService  # noqa: E402
from capreolus_tpu_torch.task import Task  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
SERVING_TOL = 1e-5  # a dev.best served against the trainer's own prediction, same device and weights

KNRM = {"name": "KNRM", "extractor": {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 16},
        "trainer": {"niters": 2, "itersize": 8, "batch": 4, "validatefreq": 1}}
BERT = {"name": "BERTMaxP", "pretrained": "tiny",
        "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER),
        "trainer": {"niters": 2, "itersize": 8, "batch": 4, "lr": 1e-3, "bertlr": 1e-3}}


def rerank_config(reranker):
    return {"benchmark": {"name": "dummy"}, "reranker": json.loads(json.dumps(reranker)),
            "threshold": 10, "testthreshold": 10}


@pytest.fixture
def knrm_task(torch_cache):
    task = Task.create("rerank", rerank_config(KNRM))
    task.device = "cpu"
    return task


def test_rerank_traineval(knrm_task):
    preds = knrm_task.train()
    assert set(preds) == {"dev", "test"}
    assert "301" in preds["test"] and "302" in preds["test"]
    results_path = knrm_task.get_results_path()
    for name in ("dev.best.params", "dev.best.done", "info/loss.txt", "pred/test/best", "pred/dev/best",
                 "extractor_state.pkl"):
        assert (results_path / name).exists(), name
    results = knrm_task.evaluate()
    assert results["cv_metrics"] is not None
    assert 0.0 <= results["cv_metrics"]["map"] <= 1.0
    assert results["interpolated_results"]["score"]["map"] >= 0.0
    assert results["fold_test_metrics"]["map"] == results["cv_metrics"]["map"]


def test_rerank_predict_after_train_equals_the_trainers_test_run(knrm_task):
    """``predict`` in a fresh task loads dev.best into a model built from seed 0
    and writes the same test run the training task wrote."""
    trained = knrm_task.train()
    fresh = Task.create("rerank", rerank_config(KNRM))
    fresh.device = "cpu"
    preds = fresh.predict()
    for qid, docs in trained["test"].items():
        for docid, score in docs.items():
            assert preds["test"][qid][docid] == pytest.approx(score, abs=1e-6)


def test_bert_rerank_traineval_with_remat_and_int8(torch_cache):
    """Tiny BERT-MaxP through the task with remat, then the same config with
    quantize=int8: training stays f32, predictions calibrate and run int8."""
    for extra in ({"remat": True}, {"quantize": "int8"}):
        task = Task.create("rerank", rerank_config(dict(BERT, **extra)))
        task.device = "cpu"
        preds = task.train()
        scores = np.array([s for docs in preds["test"].values() for s in docs.values()])
        assert np.isfinite(scores).all() and len(scores) > 0
        if "quantize" in extra:
            model = task.reranker.model
            assert model.bert.layer_0.gelu_amax.abs().max() > 0  # calibrated at prediction
            assert task.reranker._train_model is not model


def test_evaluate_without_train_raises(knrm_task):
    knrm_task._place()
    knrm_task.rank.search()
    with pytest.raises(ValueError, match="run the train command first"):
        knrm_task.evaluate()


def test_bircheval_raises_config_error(knrm_task):
    with pytest.raises(ConfigError, match="item 6"):
        knrm_task.bircheval()


def test_rerank_task_asks_for_the_card_by_default(torch_cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = Task.create("rerank", rerank_config(KNRM))
    with pytest.raises(RuntimeError, match="cuda"):
        task.train()


@pytest.mark.parametrize("reranker", [
    KNRM,
    dict(KNRM, gradkernels=False, finetune=True, trainer=dict(KNRM["trainer"], lr=0.01, seed=3, warmupiters=1)),
    dict(BERT, trainer=dict(BERT["trainer"], gradacc=2, decaytype="linear", decay=0.1), hidden_dropout_prob=0.2),
    dict(BERT, remat=True, aggregation="avg"),
], ids=["knrm", "knrm-options", "bert-trainer-options", "bert-remat"])
def test_results_paths_equal_jax(tmpdir_as_cache, torch_cache, reranker):
    from capreolus_tpu.core import constants as jax_constants
    from capreolus_tpu_torch.core import constants as port_constants

    jax_task = JaxTask.create("rerank", rerank_config(reranker))
    port_task = Task.create("rerank", rerank_config(reranker))
    jax_rel = jax_task.get_results_path().relative_to(jax_constants["RESULTS_BASE_PATH"])
    port_rel = port_task.get_results_path().relative_to(port_constants["RESULTS_BASE_PATH"])
    assert str(port_rel) == str(jax_rel)
    assert port_task.reranker.trainer.get_module_path() == jax_task.reranker.trainer.get_module_path()


@pytest.mark.parametrize("name", ["jax", "pytorch", "tensorflow"])
def test_trainer_names_of_the_reference_configs_resolve(torch_cache, name):
    from capreolus_tpu_torch.trainer import Trainer
    from capreolus_tpu_torch.trainer.torch_trainer import TorchTrainer

    trainer = Trainer.create(name)
    assert isinstance(trainer, TorchTrainer)
    from capreolus_tpu.trainer import Trainer as JaxTrainer

    assert sorted(trainer.config) == sorted(JaxTrainer.create(name).config)


def test_cli_traineval_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CAPREOLUS_CACHE": str(tmp_path / "cache"),
           "CAPREOLUS_RESULTS": str(tmp_path / "results")}
    cmd = [sys.executable, "-m", "capreolus_tpu_torch", "rerank.traineval", "with", "benchmark.name=dummy",
           "reranker.name=KNRM", "reranker.extractor.embeddings=random8", "reranker.extractor.maxqlen=4",
           "reranker.extractor.maxdoclen=16", "reranker.trainer.niters=2", "reranker.trainer.itersize=8",
           "reranker.trainer.batch=4", "threshold=10", "testthreshold=10", "--device=cpu"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rerank: fold=s1 test metrics" in proc.stderr
    assert list((tmp_path / "results").rglob("dev.best.params"))
    assert list((tmp_path / "results").rglob("pred/test/best"))


# ---------------------------------------------------------------- serving a dev.best
def _serve(dev_best_dir, reranker_cfg, device="cpu"):
    index = TorchIndex.create("tpu", {"collection": {"name": "dummy"}})
    cfg = json.loads(json.dumps(reranker_cfg))
    name = cfg.pop("name")
    cfg.pop("trainer", None)
    reranker = TorchReranker.create(name, cfg)
    return RerankingService(index, reranker, dev_best_dir / "dev.best", 10,
                            str(dev_best_dir / "extractor_state.pkl"), device=device)


@pytest.mark.parametrize("reranker", [dict(KNRM, finetune=True), BERT], ids=["knrm-finetune", "bert"])
def test_reranking_service_serves_the_trainers_dev_best(torch_cache, reranker):
    """RerankingService(checkpoint_path=dev.best, extractor_state_path=...)
    scores query 301's candidates as the trainer's own test prediction does."""
    task = Task.create("rerank", rerank_config(reranker))
    task.device = "cpu"
    preds = task.train()
    svc = _serve(task.get_results_path(), reranker)
    docids = sorted(preds["test"]["301"])
    batch = svc.rerank_batch("301", task.benchmark.topics["title"]["301"], docids)
    with torch.no_grad():
        got = svc.reranker.test(batch, svc.device).numpy()
    want = np.array([preds["test"]["301"][d] for d in docids])
    assert_within(got, want, SERVING_TOL, "served dev.best vs the trainer's test run")


def test_reranking_service_restores_a_jax_dev_best(tmpdir_as_cache, torch_cache):
    """A dev.best and extractor_state.pkl written by the JAX rerank task serve
    in the port with the JAX task's test scores (within 2e-4)."""
    jax_task = JaxTask.create("rerank", rerank_config(dict(KNRM, finetune=True)))
    jax_preds = jax_task.train()
    svc = _serve(jax_task.get_results_path(), dict(KNRM, finetune=True))
    docids = sorted(jax_preds["test"]["301"])
    batch = svc.rerank_batch("301", jax_task.benchmark.topics["title"]["301"], docids)
    with torch.no_grad():
        got = svc.reranker.test(batch, svc.device).numpy()
    want = np.array([jax_preds["test"]["301"][d] for d in docids])
    assert_within(got, want, 2e-4, "JAX dev.best served by the port")
