"""The port's tasks for the other BERT rerankers on the CPU: ``rererank``
(rank, then rerank1, then rerank2 over rerank1's top ``topn``),
``rerank.traineval`` for PARADE, CEDR-KNRM and Birch with ``rerank.bircheval``,
and the published PARADE and CEDR-KNRM configs read as the JAX package reads
them. Metrics are computed by the JAX package's ``eval_runs`` on the run files
the port wrote, and must equal the port's exactly."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.benchmark import Benchmark as JaxBenchmark  # noqa: E402
from capreolus_tpu.core.config import config_list_to_dict as jax_config_list_to_dict  # noqa: E402
from capreolus_tpu.evaluation import DEFAULT_METRICS as JAX_DEFAULT_METRICS  # noqa: E402
from capreolus_tpu.evaluation import eval_runs as jax_eval_runs  # noqa: E402
from capreolus_tpu.task import Task as JaxTask  # noqa: E402
from capreolus_tpu_torch.core.config import config_list_to_dict  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher  # noqa: E402
from capreolus_tpu_torch.task import Task  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
TRAINER = {"niters": 1, "itersize": 8, "batch": 2, "lr": 1e-3, "bertlr": 1e-3}
KNRM = {"name": "KNRM", "extractor": {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 16},
        "trainer": {"niters": 1, "itersize": 8, "batch": 4}}
TINY_BERT = {"name": "BERTMaxP", "pretrained": "tiny", "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER),
             "trainer": TRAINER}


def rererank_config(topn=3):
    return {"benchmark": {"name": "dummy"}, "topn": topn,
            "rerank1": {"reranker": json.loads(json.dumps(KNRM)), "threshold": 10, "testthreshold": 10},
            "rerank2": {"reranker": json.loads(json.dumps(TINY_BERT)), "threshold": 10, "testthreshold": 10}}


def test_rererank_traineval_reranks_stage_twos_top_n(torch_cache):
    task = Task.create("rererank", rererank_config())
    task.device = "cpu"
    stage3 = task.train()
    stage2 = task.rerank1.rerank_run(
        Searcher.load_trec_run(task.rank.evaluate()["path"]["s1"]), task.rerank1.get_results_path(),
        include_train=True)
    for split in ("dev", "test"):
        for qid, docs in stage3[split].items():
            want = sorted(stage2[split][qid].items(), key=lambda kv: kv[1], reverse=True)[:3]
            assert set(docs) == {d for d, _ in want}, (split, qid)
    metrics = task.evaluate()
    benchmark = JaxBenchmark.create("dummy")
    fold = benchmark.folds["s1"]["predict"]["test"]
    run = Searcher.load_trec_run(task.get_results_path() / "pred" / "test" / "best")
    want = jax_eval_runs(run, {q: benchmark.qrels.get(q, {}) for q in fold}, JAX_DEFAULT_METRICS,
                         benchmark.relevance_level)
    assert metrics == want
    jax_task = JaxTask.create("rererank", rererank_config())
    from capreolus_tpu.core import constants as jax_constants
    from capreolus_tpu_torch.core import constants

    assert (task.get_results_path().relative_to(constants["RESULTS_BASE_PATH"])
            == jax_task.get_results_path().relative_to(jax_constants["RESULTS_BASE_PATH"]))


def test_rererank_asks_for_the_card_by_default(torch_cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Task.create("rererank", rererank_config()).train()


@pytest.mark.parametrize("reranker", [
    {"name": "parade", "extractor": {"numpassages": 3}},
    {"name": "CEDRKNRM", "simmat_layers": "0..2,1", "extractor": {"numpassages": 2}},
    {"name": "birch", "finetune": True, "extractor": {"numpassages": 3, "sentences": True}},
], ids=["parade", "CEDRKNRM", "birch-sentences"])
def test_rerank_traineval_then_bircheval(torch_cache, reranker):
    """Each trains and predicts through the task; ``bircheval`` gives the JAX
    ``eval_runs`` of the fold's test run against every qrel of the benchmark."""
    cfg = dict(reranker, pretrained="tiny", trainer=TRAINER,
               extractor=dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, **reranker["extractor"]))
    task = Task.create("rerank", {"benchmark": {"name": "dummy"}, "reranker": cfg, "threshold": 10,
                                  "testthreshold": 10})
    task.device = "cpu"
    preds = task.train()
    assert preds["test"] and all(len(docs) for docs in preds["test"].values())
    result = task.evaluate()
    assert 0.0 <= result["fold_test_metrics"]["map"] <= 1.0
    metrics = task.bircheval()
    benchmark = JaxBenchmark.create("dummy")
    run = Searcher.load_trec_run(task.get_results_path() / "pred" / "test" / "best")
    assert metrics == jax_eval_runs(run, benchmark.qrels, JAX_DEFAULT_METRICS, benchmark.relevance_level)


@pytest.mark.parametrize("name", ["config_parade.txt", "config_paradept.txt", "config_parade_small.txt",
                                  "config_cedrknrm_pt.txt", "config_cedrknrm_tf.txt"])
def test_published_configs_read_as_jax(torch_cache, name):
    """The port's task takes each published config with the JAX task's config
    (every key and value), and the CLI's ``print_config`` prints it."""
    path = ROOT / "docs" / "reproduction" / "configs" / name
    lines = [ln.strip() for ln in path.read_text().splitlines() if ln.strip() and not ln.startswith("#")]
    port = Task.create("rerank", config_list_to_dict(lines))
    jax = JaxTask.create("rerank", jax_config_list_to_dict(lines))
    assert json.loads(json.dumps(port.config, default=str)) == json.loads(json.dumps(jax.config, default=str))
    assert port.reranker.module_name in ("parade", "ptparade", "CEDRKNRM", "TFCEDRKNRM")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "capreolus_tpu_torch", "rerank.print_config", "with",
                           f"file={path}"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout[proc.stdout.index("{"):]) == json.loads(json.dumps(port.config, default=str))
