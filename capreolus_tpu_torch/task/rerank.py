"""Rerank task (the JAX package's ``task/rerank.py``): train a neural reranker
on first-stage results with k-fold CV.

Per fold: first-stage search and cross-validated best run (the ``rank``
task), extractor preprocess, train with early stopping on dev, then predict
dev and test (thresholded candidate lists) from ``dev.best``; ``evaluate``
aggregates the folds and interpolates with the first-stage run.

The task trains and predicts on ``self.device``, an attribute (not a config
option, so it never enters the results path) that the CLI's ``--device`` or
the caller sets; ``None`` means "cuda", which raises without a card. It hands
the device to the rank task's searchers and to the reranker's trainer.
``bircheval`` raises ``ConfigError``: Birch is not ported (ROADMAP.md item 6).
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.evaluation import DEFAULT_METRICS, eval_runs, interpolated_eval
from capreolus_tpu_torch.sampler import PredSampler
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.task import Task
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Task.register
class RerankTask(Task):
    module_name = "rerank"
    config_spec = [
        ConfigOption("fold", "s1", "fold to run"),
        ConfigOption("optimize", "map", "metric to maximize on the dev set"),
        ConfigOption("metrics", ["default"], "metrics reported for evaluation", value_type="strlist"),
        ConfigOption("threshold", 100, "docids per query to evaluate during validation"),
        ConfigOption("testthreshold", 1000, "docids per query to evaluate on test data"),
    ]
    config_keys_not_in_path = ["optimize", "metrics"]
    dependencies = [
        Dependency(key="benchmark", module="benchmark", name="dummy", provide_this=True,
                   provide_children=["collection"]),
        Dependency(key="rank", module="task", name="rank"),
        Dependency(key="reranker", module="reranker", name="KNRM"),
        Dependency(key="sampler", module="sampler", name="triplet"),
    ]
    commands = ["train", "evaluate", "traineval", "predict", "bircheval"]
    default_command = "describe"
    device = None  # set by the CLI or the caller; None means "cuda"

    def _place(self):
        from capreolus_tpu_torch.serving import resolve_device

        resolve_device(self.device)
        self.rank.device = self.device
        self.reranker.trainer.device = self.device

    def traineval(self):
        self.train()
        return self.evaluate()

    run = traineval

    def _best_search_run(self):
        fold = self.config["fold"]
        self._place()
        self.rank.search()
        rank_results = self.rank.evaluate()
        return Searcher.load_trec_run(rank_results["path"][fold])

    def train(self):
        best_search_run = self._best_search_run()
        return self.rerank_run(best_search_run, self.get_results_path())

    def rerank_run(self, best_search_run, train_output_path, include_train=False):
        train_output_path = Path(train_output_path)
        fold = self.config["fold"]
        dev_output_path = train_output_path / "pred" / "dev"

        docids = {docid for querydocs in best_search_run.values() for docid in querydocs}
        self.reranker.extractor.preprocess(
            qids=list(best_search_run.keys()), docids=docids,
            topics=self.benchmark.topics[self.benchmark.query_type],
        )
        self.reranker.build_model()
        self.reranker.searcher_scores = best_search_run

        train_set = set(self.benchmark.folds[fold]["train_qids"])
        train_run = {qid: docs for qid, docs in best_search_run.items() if qid in train_set}
        dev_run = self._threshold_run(best_search_run, self.benchmark.folds[fold]["predict"]["dev"],
                                      self.config["threshold"])

        self.sampler.prepare(train_run, self.benchmark.qrels, self.reranker.extractor,
                             relevance_level=self.benchmark.relevance_level)
        dev_dataset = PredSampler.create("pred")
        dev_dataset.prepare(dev_run, self.benchmark.qrels, self.reranker.extractor,
                            relevance_level=self.benchmark.relevance_level)

        dev_qrels = {qid: self.benchmark.qrels[qid]
                     for qid in self.benchmark.non_nn_dev[fold] if qid in self.benchmark.qrels}
        self.reranker.trainer.train(
            self.reranker, self.sampler, train_output_path, dev_dataset, dev_output_path,
            dev_qrels, self.config["optimize"], self.benchmark.relevance_level,
        )
        # export the training-time extractor state next to the checkpoints: a
        # fresh serving process restores it (RerankingService
        # extractor_state_path) so vocabulary-sized trained params deserialize
        # against identical table shapes
        try:
            self.reranker.extractor.save_state(train_output_path / "extractor_state.pkl")
        except NotImplementedError:
            pass  # extractor keeps no vocab state; serving re-preprocesses

        self.reranker.trainer.load_best_model(self.reranker, train_output_path)
        dev_best_path = train_output_path / "pred" / "dev" / "best"
        dev_preds = self.reranker.trainer.predict(self.reranker, dev_dataset, dev_best_path)

        test_run = self._threshold_run(best_search_run, self.benchmark.folds[fold]["predict"]["test"],
                                       self.config["testthreshold"])
        test_dataset = PredSampler.create("pred")
        test_dataset.prepare(test_run, self.benchmark.qrels, self.reranker.extractor,
                             relevance_level=self.benchmark.relevance_level)
        test_best_path = train_output_path / "pred" / "test" / "best"
        test_preds = self.reranker.trainer.predict(self.reranker, test_dataset, test_best_path)

        preds = {"dev": dev_preds, "test": test_preds}
        if include_train:
            train_dataset = PredSampler.create("pred")
            train_dataset.prepare(train_run, self.benchmark.qrels, self.reranker.extractor,
                                  relevance_level=self.benchmark.relevance_level)
            preds["train"] = self.reranker.trainer.predict(
                self.reranker, train_dataset, train_output_path / "pred" / "train" / "best"
            )
        return preds

    @staticmethod
    def _threshold_run(best_search_run, qids, threshold):
        """Top-``threshold`` docs per query (run dicts preserve rank order)."""
        out = defaultdict(dict)
        qids = set(qids)
        for qid, docs in best_search_run.items():
            if qid in qids:
                for idx, (docid, score) in enumerate(docs.items()):
                    if idx >= threshold:
                        break
                    out[qid][docid] = score
        return dict(out)

    def predict(self):
        fold = self.config["fold"]
        best_search_run = self._best_search_run()
        docids = {docid for querydocs in best_search_run.values() for docid in querydocs}
        self.reranker.extractor.preprocess(
            qids=list(best_search_run.keys()), docids=docids,
            topics=self.benchmark.topics[self.benchmark.query_type],
        )
        train_output_path = self.get_results_path()
        self.reranker.build_model()

        test_run = self._threshold_run(best_search_run, self.benchmark.folds[fold]["predict"]["test"],
                                       self.config["testthreshold"])
        test_dataset = PredSampler.create("pred")
        test_dataset.prepare(test_run, self.benchmark.qrels, self.reranker.extractor,
                             relevance_level=self.benchmark.relevance_level)
        # the trainer builds the model from seed 0 as the template dev.best loads into
        self.reranker.trainer.load_best_model(self.reranker, train_output_path)

        test_preds = self.reranker.trainer.predict(
            self.reranker, test_dataset, train_output_path / "pred" / "test" / "best"
        )
        return {"test": test_preds}

    def evaluate(self):
        fold = self.config["fold"]
        metrics = list(self.config["metrics"])
        if metrics == ["default"]:
            metrics = DEFAULT_METRICS

        searcher_runs, reranker_runs = self.find_crossvalidated_results()
        if fold not in reranker_runs:
            raise ValueError("could not find predictions; run the train command first")

        dev_qrels = {qid: self.benchmark.qrels.get(qid, {}) for qid in self.benchmark.folds[fold]["predict"]["dev"]}
        fold_dev_metrics = eval_runs(reranker_runs[fold]["dev"], dev_qrels, metrics, self.benchmark.relevance_level)
        logger.info("rerank: fold=%s dev metrics: %s", fold,
                    " ".join(f"{m}={v:0.3f}" for m, v in sorted(fold_dev_metrics.items())))

        test_qrels = {qid: self.benchmark.qrels.get(qid, {}) for qid in self.benchmark.folds[fold]["predict"]["test"]}
        fold_test_metrics = eval_runs(reranker_runs[fold]["test"], test_qrels, metrics, self.benchmark.relevance_level)
        logger.info("rerank: fold=%s test metrics: %s", fold,
                    " ".join(f"{m}={v:0.3f}" for m, v in sorted(fold_test_metrics.items())))

        if len(reranker_runs) != len(self.benchmark.folds):
            logger.info("rerank: skipping cross-validated metrics (results for %d/%d folds)",
                        len(reranker_runs), len(self.benchmark.folds))
            return {
                "fold_test_metrics": fold_test_metrics,
                "fold_dev_metrics": fold_dev_metrics,
                "cv_metrics": None,
                "interpolated_results": None,
            }

        all_preds = {}
        for preds in reranker_runs.values():
            for qid, docscores in preds["test"].items():
                all_preds.setdefault(qid, {}).update(docscores)

        cv_metrics = eval_runs(all_preds, self.benchmark.qrels, metrics, self.benchmark.relevance_level)
        interpolated_results = interpolated_eval(
            searcher_runs, reranker_runs, self.benchmark, self.config["optimize"], metrics
        )
        for metric, score in sorted(cv_metrics.items()):
            logger.info("%25s: %0.4f", metric, score)
        for metric, score in sorted(interpolated_results["score"].items()):
            logger.info("%25s: %0.4f", metric + " [interp]", score)

        return {
            "fold_test_metrics": fold_test_metrics,
            "fold_dev_metrics": fold_dev_metrics,
            "cv_metrics": cv_metrics,
            "interpolated_results": interpolated_results,
        }

    def bircheval(self):
        """Evaluate Birch's test runs across folds: Birch is not ported."""
        raise ConfigError("rerank.bircheval evaluates Birch runs, and Birch is not ported to PyTorch yet "
                          "(ROADMAP.md item 6, 'the other BERT rerankers')")

    def find_crossvalidated_results(self):
        """Collect searcher + reranker runs for every fold by substituting the fold
        name into this fold's result paths (parity: task/rerank.py:246-266)."""
        searcher_runs = {}
        rank_results = self.rank.evaluate()
        for fold in self.benchmark.folds:
            run = Searcher.load_trec_run(rank_results["path"][fold])
            searcher_runs[fold] = {"dev": run, "test": run}

        reranker_runs = {}
        train_output_path = self.get_results_path()
        test_output_path = train_output_path / "pred" / "test" / "best"
        dev_output_path = train_output_path / "pred" / "dev" / "best"
        for fold in self.benchmark.folds:
            test_path = Path(test_output_path.as_posix().replace("fold-" + self.config["fold"], "fold-" + fold))
            if os.path.exists(test_path):
                reranker_runs.setdefault(fold, {})["test"] = Searcher.load_trec_run(test_path)
                dev_path = Path(dev_output_path.as_posix().replace("fold-" + self.config["fold"], "fold-" + fold))
                if os.path.exists(dev_path):
                    reranker_runs.setdefault(fold, {})["dev"] = Searcher.load_trec_run(dev_path)
        return searcher_runs, reranker_runs
