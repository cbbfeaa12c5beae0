"""NFCorpus benchmark (parity: capreolus/benchmark/nf.py:21-31).

Builds TREC-format topics/qrels/folds from the raw NFCorpus distribution, with the
reference's ``labelrange`` and ``fields`` options.
"""

from __future__ import annotations

import hashlib
import json
from collections import defaultdict

from capreolus_tpu_torch.benchmark import Benchmark
from capreolus_tpu_torch.benchmark.downloadable import FILE_CONFIG_OPTIONS
from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.trec import topic_to_trectxt

logger = get_logger(__name__)


@Benchmark.register
class NF(Benchmark):
    """NFCorpus: a full-text learning-to-rank dataset for medical IR (Boteva et al. 2016)."""

    module_name = "nf"
    dependencies = [Dependency(key="collection", module="collection", name="nf")]
    config_spec = [
        ConfigOption("labelrange", "0-2", "range of labels: 0-2 or 1-3"),
        ConfigOption("fields", "all_titles", "query fields: all_titles, nontopics, or vid_title"),
    ] + FILE_CONFIG_OPTIONS
    query_type = "title"

    def _raw_dir(self):
        # the nf collection download contains train/dev/test query and qrel files
        return self.collection.get_raw_dir()

    def _build_files(self):
        data_dir = self.get_cache_path() / "data"
        data_dir.mkdir(parents=True, exist_ok=True)
        topic_fn = data_dir / "topics.nf.txt"
        qrel_fn = data_dir / "qrels.nf.txt"
        fold_fn = data_dir / "folds.nf.json"
        if topic_fn.exists() and qrel_fn.exists() and fold_fn.exists():
            return topic_fn, qrel_fn, fold_fn

        raw = self._raw_dir()
        label_min = int(self.config["labelrange"].split("-")[0])
        field = self.config["fields"]
        field_files = {
            "all_titles": "{split}.titles.queries",
            "nontopics": "{split}.nontopic-titles.queries",
            "vid_title": "{split}.vid-titles.queries",
        }[field]

        topics = {}
        qrels = defaultdict(dict)
        split_qids = {}
        for split in ("train", "dev", "test"):
            qfile = raw / field_files.format(split=split)
            qids = []
            with open(qfile, encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    qid, text = line.rstrip("\n").split("\t", 1)
                    topics[qid] = text.strip()
                    qids.append(qid)
            split_qids[split] = qids
            rel_file = raw / f"{split}.3-2-1.qrel"
            with open(rel_file, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 4:
                        qid, _, docid, label = parts[:4]
                        # reference maps the 3-2-1 labels into the configured range
                        qrels[qid][docid] = max(0, int(label) - (1 if label_min == 0 else 0))

        with open(topic_fn, "wt", encoding="utf-8") as f:
            for qid, text in topics.items():
                f.write(topic_to_trectxt(qid, text))
        with open(qrel_fn, "wt", encoding="utf-8") as f:
            for qid in sorted(qrels):
                for docid, label in sorted(qrels[qid].items()):
                    f.write(f"{qid} 0 {docid} {label}\n")
        folds = {"s1": {"train_qids": split_qids["train"],
                        "predict": {"dev": split_qids["dev"], "test": split_qids["test"]}}}
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
