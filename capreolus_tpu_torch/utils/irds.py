"""The ir_datasets bridge (the JAX package's ``utils/irds.py``): any
ir_datasets name becomes a registered Collection and Benchmark pair.

``get_irds("msmarco-passage/dev")`` registers the collection
``irds.msmarco-passage`` and the benchmark ``irds.msmarco-passage/dev`` (its
topics, qrels and one generated fold ``s1``) once per name; datasets that
share a parent share one collection, and so one index. The optional
``ir_datasets`` package is imported only when a bridge is called, so the
port imports without it.
"""

from __future__ import annotations

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def _require_irds():
    try:
        import ir_datasets

        return ir_datasets
    except ImportError as e:
        raise ImportError(
            "the ir_datasets bridge requires the ir_datasets package (pip install ir_datasets)"
        ) from e


def dataset_to_collection(dataset_name: str) -> str:
    """The parent docs dataset name (so datasets sharing a corpus share an index)."""
    parts = dataset_name.split("/")
    return parts[0] if parts else dataset_name


def get_irds(dataset_name: str):
    """Register and return (collection_name, benchmark_name) for an ir_datasets name."""
    irds = _require_irds()
    from capreolus_tpu_torch.benchmark import Benchmark
    from capreolus_tpu_torch.collection import Collection
    from capreolus_tpu_torch.core import Dependency, module_registry

    collection_name = f"irds.{dataset_to_collection(dataset_name)}"
    benchmark_name = f"irds.{dataset_name}"

    if collection_name not in module_registry.get_module_names("collection"):
        parent = dataset_to_collection(dataset_name)

        class IRDCollection(Collection):
            module_name = collection_name
            collection_type = "irds"
            _dataset_name = parent

            def get_doc_iterator(self):
                # every str field but doc_id, in the namedtuple's field order
                dataset = irds.load(self._dataset_name)
                for doc in dataset.docs_iter():
                    text = " ".join(
                        str(getattr(doc, field)) for field in doc._fields
                        if field != "doc_id" and isinstance(getattr(doc, field), str)
                    )
                    yield doc.doc_id, text

            def get_path(self):
                return None

        Collection.register(IRDCollection)

    if benchmark_name not in module_registry.get_module_names("benchmark"):

        class IRDBenchmark(Benchmark):
            module_name = benchmark_name
            dependencies = [Dependency(key="collection", module="collection", name=collection_name)]
            _dataset_name = dataset_name

            @property
            def topics(self):
                if not hasattr(self, "_topics"):
                    dataset = irds.load(self._dataset_name)
                    topics = {}
                    for query in dataset.queries_iter():
                        text = getattr(query, "text", None) or getattr(query, "title", "")
                        topics[query.query_id] = text
                    self._topics = {self.query_type: topics}
                return self._topics

            @property
            def qrels(self):
                if not hasattr(self, "_qrels"):
                    dataset = irds.load(self._dataset_name)
                    qrels = {}
                    for qrel in dataset.qrels_iter():
                        qrels.setdefault(qrel.query_id, {})[qrel.doc_id] = qrel.relevance
                    self._qrels = qrels
                return self._qrels

            @property
            def folds(self):
                if not hasattr(self, "_folds"):
                    qids = sorted(self.topics[self.query_type])
                    self._folds = {"s1": {"train_qids": qids, "predict": {"dev": qids, "test": qids}}}
                return self._folds

        Benchmark.register(IRDBenchmark)

    return collection_name, benchmark_name
