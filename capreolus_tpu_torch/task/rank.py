"""First-stage ranking task (the JAX package's ``task/rank.py``): ``search``
(index + query all topics), ``evaluate`` (cross-validated best-run selection),
``searcheval``, and the qrels-filter option.

The task runs its searcher on ``self.device``, an attribute (not a config
option, so it never enters the results path) that the CLI's ``--device`` or
the caller sets; ``None`` means "cuda", which raises without a card.
``search`` sets it on the searcher, and through fusion on both of its legs.
"""

from __future__ import annotations

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.evaluation import DEFAULT_METRICS, search_best_run
from capreolus_tpu_torch.task import Task
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.trec import load_trec_run, write_trec_run

logger = get_logger(__name__)


def place_searchers(searcher, device):
    """Set ``device`` on ``searcher`` and on every searcher it depends on (fusion's legs)."""
    searcher.device = device
    for dep in searcher.dependencies:
        child = getattr(searcher, dep.key, None)
        if getattr(child, "module_type", None) == "searcher":
            place_searchers(child, device)


@Task.register
class RankTask(Task):
    """Search a collection and evaluate the ranking with cross-validation."""

    module_name = "rank"
    config_spec = [
        ConfigOption("filter", False, "remove qrels-listed documents from the run"),
        ConfigOption("optimize", "map", "metric to maximize on the dev set"),
        ConfigOption("metrics", ["default"], "metrics to report", value_type="strlist"),
    ]
    config_keys_not_in_path = ["optimize", "metrics"]
    dependencies = [
        Dependency(key="benchmark", module="benchmark", name="dummy", provide_this=True,
                   provide_children=["collection"]),
        Dependency(key="searcher", module="searcher", name="BM25"),
    ]
    commands = ["run", "search", "evaluate", "searcheval"]
    default_command = "searcheval"
    device = None  # set by the CLI or the caller; None means "cuda"

    def search(self):
        from capreolus_tpu_torch.serving import resolve_device

        resolve_device(self.device)  # asks for the card even where the runs are already on disk
        topics_fn = self.benchmark.get_topics_file()
        output_dir = self.get_results_path() / "search"
        place_searchers(self.searcher, self.device)
        if hasattr(self.searcher, "index"):  # static-run searchers have no index
            self.searcher.index.create_index()
        search_results_dir = self.searcher.query_from_file(topics_fn, output_dir)

        if self.config["filter"]:
            self._filter_runs(search_results_dir)

        logger.info("searcher results written to %s", search_results_dir)
        return search_results_dir

    def _filter_runs(self, results_dir):
        """Remove documents that appear in the qrels from each run (residual-collection evaluation)."""
        import os

        qrels = self.benchmark.qrels
        for fn in os.listdir(results_dir):
            path = results_dir / fn
            # skip the done marker and nested sub-run directories (the fusion
            # searcher writes its legs to searcher1/ and searcher2/)
            if fn == "done" or path.is_dir():
                continue
            run = load_trec_run(path)
            filtered = {
                qid: {d: s for d, s in docs.items() if d not in qrels.get(qid, {})}
                for qid, docs in run.items()
            }
            path.unlink()
            write_trec_run(filtered, path)

    def evaluate(self):
        metrics = list(self.config["metrics"])
        if "default" in metrics:
            metrics = DEFAULT_METRICS

        best_results = search_best_run(
            self.get_results_path() / "search", self.benchmark, primary_metric=self.config["optimize"], metrics=metrics
        )
        for fold, path in best_results["path"].items():
            logger.info("rank: fold=%s best run: %s", fold, path)
        for metric, score in sorted(best_results["score"].items()):
            logger.info("rank: cross-validated results: %s=%.4f", metric, score)
        print(best_results["score"])
        return best_results

    def searcheval(self):
        self.search()
        return self.evaluate()

    run = searcheval
