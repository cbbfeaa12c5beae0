"""Three-stage pipeline (the JAX package's ``task/rererank.py``): rank, then
rerank1 over the first stage's best run, then rerank2 over rerank1's top
``topn`` of every train, dev and test query.

Like ``rerank``, the task runs on ``self.device`` (an attribute, never in the
results path; ``None`` means "cuda"), which it hands to the rank task's
searchers and to both rerankers' trainers.
"""

from __future__ import annotations

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.evaluation import DEFAULT_METRICS, eval_runs
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.task import Task
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Task.register
class ReRerankTask(Task):
    module_name = "rererank"
    config_spec = [
        ConfigOption("fold", "s1", "fold to run"),
        ConfigOption("optimize", "map", "metric to maximize on the dev set"),
        ConfigOption("topn", 100, "number of stage-two results to rerank in stage three"),
    ]
    config_keys_not_in_path = ["optimize"]
    dependencies = [
        Dependency(key="benchmark", module="benchmark", name="dummy", provide_this=True,
                   provide_children=["collection"]),
        Dependency(key="rank", module="task", name="rank", provide_this=True),
        Dependency(key="rerank1", module="task", name="rerank"),
        Dependency(key="rerank2", module="task", name="rerank"),
    ]
    commands = ["train", "evaluate", "traineval"]
    default_command = "describe"
    device = None  # set by the CLI or the caller; None means "cuda"

    def _place(self):
        from capreolus_tpu_torch.serving import resolve_device

        resolve_device(self.device)
        self.rank.device = self.device
        for task in (self.rerank1, self.rerank2):
            task.device = self.device
            task.reranker.trainer.device = self.device

    def traineval(self):
        self.train()
        return self.evaluate()

    def train(self):
        fold = self.config["fold"]
        self._place()
        self.rank.search()
        rank_results = self.rank.evaluate()
        best_search_run = Searcher.load_trec_run(rank_results["path"][fold])

        second = self.rerank1.rerank_run(best_search_run, self.rerank1.get_results_path(), include_train=True)
        second_topn = {
            qid: dict(sorted(docids.items(), key=lambda kv: kv[1], reverse=True)[: self.config["topn"]])
            for split in ("train", "dev", "test")
            for qid, docids in second[split].items()
        }
        return self.rerank2.rerank_run(second_topn, self.get_results_path())

    def evaluate(self):
        fold = self.config["fold"]
        test_path = self.get_results_path() / "pred" / "test" / "best"
        if not test_path.exists():
            raise ValueError("could not find predictions; run the train command first")
        test_run = Searcher.load_trec_run(test_path)
        test_qrels = {qid: self.benchmark.qrels.get(qid, {}) for qid in self.benchmark.folds[fold]["predict"]["test"]}
        metrics = eval_runs(test_run, test_qrels, DEFAULT_METRICS, self.benchmark.relevance_level)
        logger.info("rererank: fold=%s test metrics: %s", fold,
                    " ".join(f"{m}={v:0.3f}" for m, v in sorted(metrics.items())))
        return metrics
