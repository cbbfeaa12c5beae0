"""MS MARCO passage benchmark.

Capability parity with capreolus/benchmark/msmarco.py:20-25:
generates topics/qrels/folds from the official collectionandqueries download
(train/dev splits; use_train_as_dev=False), MRR@10 as the headline metric.
"""

from __future__ import annotations

import json

from capreolus_tpu_torch.benchmark import Benchmark
from capreolus_tpu_torch.benchmark.downloadable import FILE_CONFIG_OPTIONS
from capreolus_tpu_torch.core import Dependency
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Benchmark.register
class MSMarcoPassage(Benchmark):
    module_name = "msmarcopsg"
    dependencies = [Dependency(key="collection", module="collection", name="msmarcopsg")]
    config_spec = list(FILE_CONFIG_OPTIONS)
    query_type = "title"
    use_train_as_dev = False
    topic_format = "tsv"

    def _build_files(self):
        data_dir = self.get_cache_path() / "data"
        data_dir.mkdir(parents=True, exist_ok=True)
        topic_fn = data_dir / "topics.msmarcopsg.tsv"
        qrel_fn = data_dir / "qrels.msmarcopsg.txt"
        fold_fn = data_dir / "folds.msmarcopsg.json"
        if topic_fn.exists() and qrel_fn.exists() and fold_fn.exists():
            return topic_fn, qrel_fn, fold_fn

        raw = self.collection.get_raw_dir()
        split_qids = {}
        with open(topic_fn, "wt", encoding="utf-8") as topics_out, open(qrel_fn, "wt", encoding="utf-8") as qrels_out:
            for split, qfile, relfile in (
                ("train", "queries.train.tsv", "qrels.train.tsv"),
                ("dev", "queries.dev.small.tsv", "qrels.dev.small.tsv"),
            ):
                qids = []
                with open(raw / qfile, encoding="utf-8") as f:
                    for line in f:
                        if line.strip():
                            qid, text = line.rstrip("\n").split("\t", 1)
                            topics_out.write(f"{qid}\t{text}\n")
                            qids.append(qid)
                split_qids[split] = qids
                with open(raw / relfile, encoding="utf-8") as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) >= 4:
                            qrels_out.write(f"{parts[0]} 0 {parts[2]} {parts[3]}\n")
        folds = {"s1": {"train_qids": split_qids["train"],
                        "predict": {"dev": split_qids["dev"], "test": split_qids["dev"]}}}
        fold_fn.write_text(json.dumps(folds))
        return topic_fn, qrel_fn, fold_fn

    @property
    def topic_file(self):
        return self.config.get("topicfile") or self._build_files()[0]

    @property
    def qrel_file(self):
        return self.config.get("qrelfile") or self._build_files()[1]

    @property
    def fold_file(self):
        return self.config.get("foldfile") or self._build_files()[2]
