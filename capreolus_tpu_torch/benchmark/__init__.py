"""Benchmark modules: topics + qrels + cross-validation folds (the JAX
package's ``benchmark/__init__.py``).

``topics``/``qrels``/``folds`` properties loaded from standard files,
``relevance_level``, ``use_train_as_dev``, ``non_nn_dev`` (train+dev pools for
non-neural tuning), ``get_topics_file()`` TSV export via atomic cached_file,
and a ``validate`` step that checks the folds file's shape and warns on qid
misalignment. Ported so far: the ``dummy`` benchmark; the downloadable and
standard benchmarks wait until their data is in the repository.
"""

from __future__ import annotations

import json
from copy import deepcopy

from capreolus_tpu_torch.core import ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.trec import load_qrels, load_trec_topics, load_tsv_topics

logger = get_logger(__name__)


@register_module_type
class Benchmark(ModuleBase):
    """Base class for Benchmark modules."""

    module_type = "benchmark"
    qrel_file = None
    topic_file = None
    fold_file = None
    query_type = "title"
    relevance_level = 1
    use_train_as_dev = True
    topic_format = "trec"  # or "tsv"

    @property
    def qrels(self):
        if not hasattr(self, "_qrels"):
            self._qrels = load_qrels(self.qrel_file)
        return self._qrels

    @property
    def topics(self):
        if not hasattr(self, "_topics"):
            if self.topic_format == "tsv":
                self._topics = load_tsv_topics(self.topic_file, self.query_type)
            else:
                self._topics = load_trec_topics(self.topic_file)
        return self._topics

    @property
    def folds(self):
        if not hasattr(self, "_folds"):
            with open(self.fold_file, "rt") as f:
                self._folds = json.load(f, parse_int=str)
        return self._folds

    @property
    def non_nn_dev(self):
        """Per-fold qid pools for tuning non-neural methods: dev (+train when
        use_train_as_dev)."""
        dev_per_fold = {name: deepcopy(fold["predict"]["dev"]) for name, fold in self.folds.items()}
        if self.use_train_as_dev:
            for name, fold in self.folds.items():
                dev_per_fold[name].extend(fold["train_qids"])
        return dev_per_fold

    def get_topics_file(self, query_sets=None):
        """Write (once) and return the path of a qid\\tquery TSV for query_sets
        (any subset of {train, dev, test}; None means all)."""
        if query_sets:
            query_sets = set(query_sets)
            invalid = query_sets - {"train", "dev", "test"}
            if invalid:
                raise ValueError(f"invalid query_sets: {invalid}")
            valid_qids = set()
            for fold in self.folds.values():
                if "train" in query_sets:
                    valid_qids.update(fold["train_qids"])
                if "dev" in query_sets:
                    valid_qids.update(fold["predict"]["dev"])
                if "test" in query_sets:
                    valid_qids.update(fold["predict"]["test"])
            tag = "_".join(sorted(query_sets))
        else:
            tag = "all"
            valid_qids = None

        fn = self.get_cache_path() / f"topics-{tag}.tsv"
        try:
            with cached_file(fn) as outf:
                for qid, query in self.topics[self.query_type].items():
                    if valid_qids is None or qid in valid_qids:
                        print(f"{qid}\t{query}", file=outf)
        except TargetFileExists:
            pass
        return fn

    # ------------------------------------------------------------------ validation
    def validate(self):
        """Check folds shape and topics/qrels/folds qid alignment; dedup conflicting qrels."""
        if self.fold_file is not None:
            for name, fold in self.folds.items():
                assert set(fold.keys()) >= {"train_qids", "predict"}, f"malformed fold {name}"
                assert set(fold["predict"].keys()) >= {"dev", "test"}, f"malformed fold {name}"

        # load_qrels keeps the last entry per (qid, docid); here we just warn on
        # qid misalignment.
        if self.qrel_file is not None and self.topic_file is not None:
            topic_qids = set(self.topics[self.query_type])
            qrel_qids = set(self.qrels)
            missing = qrel_qids - topic_qids
            if missing:
                logger.warning("%d qrel qids missing from topics (e.g. %s)", len(missing), sorted(missing)[:3])
            if self.fold_file is not None:
                fold_qids = set()
                for fold in self.folds.values():
                    fold_qids.update(fold["train_qids"])
                    fold_qids.update(fold["predict"]["dev"])
                    fold_qids.update(fold["predict"]["test"])
                unknown = fold_qids - topic_qids
                if unknown:
                    logger.warning("%d fold qids missing from topics (e.g. %s)", len(unknown), sorted(unknown)[:3])

    def build(self):
        try:
            self.validate()
        except Exception as e:
            # data may require a download or a user-supplied path; surface the
            # actionable error on first use instead of at module creation
            logger.debug("deferring benchmark validation for %s: %s", self.module_name, e)


import_all_modules(__file__, __package__)
