"""Tutorial task (the JAX package's ``task/tutorial.py``): compare two searchers
with cross-validated best-run selection. The reference's tutorial uses
BM25RM3 against SDM on NFCorpus; dummy is the offline default here and the
searchers are configurable.

Like the rank task, it runs its searchers on ``self.device``, which the CLI's
``--device`` or the caller sets; ``None`` means "cuda".
"""

from __future__ import annotations

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.evaluation import DEFAULT_METRICS, search_best_run
from capreolus_tpu_torch.task import Task
from capreolus_tpu_torch.task.rank import place_searchers
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Task.register
class TutorialTask(Task):
    module_name = "tutorial"
    config_spec = [ConfigOption("optimize", "map", "metric to maximize on the validation set")]
    dependencies = [
        Dependency(key="benchmark", module="benchmark", name="dummy", provide_this=True,
                   provide_children=["collection"]),
        Dependency(key="searcher1", module="searcher", name="BM25RM3"),
        Dependency(key="searcher2", module="searcher", name="QLDirichlet"),
    ]
    commands = ["run"]
    default_command = "run"
    device = None  # set by the CLI or the caller; None means "cuda"

    def run(self):
        output_dir = self.get_results_path()
        place_searchers(self.searcher1, self.device)
        place_searchers(self.searcher2, self.device)
        self.searcher1.index.create_index()
        self.searcher2.index.create_index()
        results1 = self.searcher1.query_from_file(self.benchmark.get_topics_file(), output_dir / "searcher1")
        results2 = self.searcher2.query_from_file(self.benchmark.get_topics_file(), output_dir / "searcher2")

        best_results = search_best_run(
            [results1, results2], self.benchmark, primary_metric=self.config["optimize"], metrics=DEFAULT_METRICS
        )
        for fold, path in best_results["path"].items():
            logger.info("fold=%s best run: ...%s", fold, str(path)[-40:])
        logger.info("cross-validated results when optimizing for %r:", self.config["optimize"])
        for metric, score in sorted(best_results["score"].items()):
            logger.info("%15s: %0.4f", metric, score)
        return best_results
