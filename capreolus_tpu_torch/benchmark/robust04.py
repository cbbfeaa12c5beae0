"""Robust04 benchmark variants.

Capability parity with capreolus/benchmark/robust04.py:18-64:
``robust04`` (CEDR folds), ``robust04.yang19`` (+.desc), and
``robust04.huston14.title``/``.desc``. The published topics and all four fold
splits are shipped in capreolus_tpu_torch/data (the same data files the reference
ships); qrels are downloaded once from TREC or supplied via qrelfile.
"""

from __future__ import annotations

from capreolus_tpu_torch.benchmark import Benchmark
from capreolus_tpu_torch.benchmark.downloadable import DownloadableBenchmark
from capreolus_tpu_torch.core import Dependency

_CAPREOLUS_RAW = "https://raw.githubusercontent.com/capreolus-ir/capreolus/master/capreolus/data"
# basename matches the shipped copy in capreolus_tpu_torch/data, so no download happens
ROBUST04_TOPICS = f"{_CAPREOLUS_RAW}/topics.robust04.301-450.601-700.txt"
ROBUST04_QRELS = "https://trec.nist.gov/data/robust/qrels.robust2004.txt"


class _Robust04Base(DownloadableBenchmark):
    dependencies = [Dependency(key="collection", module="collection", name="robust04")]
    topic_url = ROBUST04_TOPICS
    qrel_url = ROBUST04_QRELS
    query_type = "title"


@Benchmark.register
class Robust04(_Robust04Base):
    """Robust04 with CEDR's folds (parity: robust04.py:18)."""

    module_name = "robust04"
    fold_url = f"{_CAPREOLUS_RAW}/rob04_cedr_folds.json"


@Benchmark.register
class Robust04Yang19(_Robust04Base):
    """Robust04 with the 5 folds from Yang et al. (SIGIR 2019) (parity: robust04.py:33)."""

    module_name = "robust04.yang19"
    fold_url = f"{_CAPREOLUS_RAW}/rob04_yang19_folds.json"


@Benchmark.register
class Robust04Yang19Desc(Robust04Yang19):
    module_name = "robust04.yang19.desc"
    query_type = "desc"


@Benchmark.register
class Robust04Huston14Title(_Robust04Base):
    """Robust04 with Huston & Croft (2014) folds (parity: robust04.py:49)."""

    module_name = "robust04.huston14.title"
    fold_url = f"{_CAPREOLUS_RAW}/rob04_huston14_title_folds.json"


@Benchmark.register
class Robust04Huston14Desc(_Robust04Base):
    module_name = "robust04.huston14.desc"
    query_type = "desc"
    fold_url = f"{_CAPREOLUS_RAW}/rob04_huston14_desc_folds.json"
