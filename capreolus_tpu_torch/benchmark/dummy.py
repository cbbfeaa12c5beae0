"""Tiny test-fixture benchmark (the JAX package's ``benchmark/dummy.py``)."""

from capreolus_tpu_torch.benchmark import Benchmark
from capreolus_tpu_torch.core import ConfigOption, Dependency, constants


@Benchmark.register
class DummyBenchmark(Benchmark):
    """Two-query benchmark over the 3-document dummy collection."""

    module_name = "dummy"
    dependencies = [Dependency(key="collection", module="collection", name="dummy")]
    config_spec = [ConfigOption("fold", "s1", "fold to run")]
    query_type = "title"

    qrel_file = constants["PACKAGE_PATH"] / "data" / "qrels.dummy.txt"
    topic_file = constants["PACKAGE_PATH"] / "data" / "topics.dummy.txt"
    fold_file = constants["PACKAGE_PATH"] / "data" / "dummy_folds.json"
