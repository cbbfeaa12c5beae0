"""Helpers for benchmarks whose topics/qrels/folds come from shipped data,
public downloads, or user-supplied files.

Resolution order per artifact (parity with the reference, which ships static
fold/topic/qrel files in capreolus/data — capreolus/benchmark/robust04.py:18-64):
(1) explicit ``topicfile``/``qrelfile``/``foldfile`` config paths; (2) the copy
shipped in capreolus_tpu_torch/data (the reference's own published data files); (3) a
one-time download into the benchmark cache (gated offline with actionable errors).

Folds are never silently invented for a published benchmark name: a missing fold
file raises unless ``folds=generated`` explicitly opts into a deterministic
seeded split (which is clearly logged as NOT the published split).
"""

from __future__ import annotations

import hashlib
import json

from capreolus_tpu_torch.benchmark import Benchmark
from capreolus_tpu_torch.core import ConfigError, ConfigOption, constants
from capreolus_tpu_torch.utils.common import download_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

FILE_CONFIG_OPTIONS = [
    ConfigOption("topicfile", None, "path to a local topics file (overrides shipped data/download)"),
    ConfigOption("qrelfile", None, "path to a local qrels file (overrides shipped data/download)"),
    ConfigOption("foldfile", None, "path to a local folds json (overrides shipped data/download)"),
    ConfigOption("folds", "published", "'published' (default) requires a real fold file; "
                 "'generated' opts into a deterministic seeded split that is NOT the published one"),
]


def shipped_data(filename):
    """Return the path of a data file shipped with the package, or None."""
    path = constants["PACKAGE_PATH"] / "data" / filename
    return path if path.exists() else None


class DownloadableBenchmark(Benchmark):
    """Benchmark whose files are downloaded or user-supplied."""

    topic_url = None
    qrel_url = None
    fold_url = None
    num_folds = 5

    config_spec = FILE_CONFIG_OPTIONS

    def _data_dir(self):
        path = self.get_cache_path() / "data"
        path.mkdir(parents=True, exist_ok=True)
        return path

    def _file(self, kind, url, config_key):
        configured = self.config.get(config_key)
        if configured:
            return configured
        if url is None:
            return None
        shipped = shipped_data(url.split("/")[-1])
        if shipped is not None:
            return shipped
        dest = self._data_dir() / f"{kind}.{url.split('/')[-1]}"
        return download_file(url, dest)

    @property
    def topic_file(self):
        return self._file("topics", self.topic_url, "topicfile")

    @property
    def qrel_file(self):
        return self._file("qrels", self.qrel_url, "qrelfile")

    @property
    def fold_file(self):
        configured = self.config.get("foldfile")
        if configured:
            return configured
        if self.config.get("folds", "published") == "generated":
            return self._generated_fold_file()
        if self.fold_url is not None:
            return self._file("folds", self.fold_url, "foldfile")
        raise ConfigError(
            f"benchmark {self.module_name} has no published fold file available; "
            f"supply benchmark.foldfile=<path> for the real split, or explicitly opt "
            f"into a seeded (non-published) split with benchmark.folds=generated"
        )

    def _generated_fold_file(self):
        """Deterministic seeded k-fold split over topic qids (md5-ordered)."""
        dest = self._data_dir() / f"generated_{self.num_folds}folds.json"
        if dest.exists():
            return dest
        qids = sorted(self.topics[self.query_type])
        ordered = sorted(qids, key=lambda q: hashlib.md5(f"fold{q}".encode()).hexdigest())
        k = self.num_folds
        folds = {}
        for i in range(k):
            test = ordered[i::k]
            dev = ordered[(i + 1) % k :: k]
            train = [q for q in ordered if q not in set(test) | set(dev)]
            folds[f"s{i + 1}"] = {"train_qids": train, "predict": {"dev": dev, "test": test}}
        logger.warning(
            "benchmark %s: using a generated %d-fold split (NOT the published split); "
            "set benchmark.foldfile to reproduce paper numbers exactly", self.module_name, k
        )
        dest.write_text(json.dumps(folds))
        return dest
