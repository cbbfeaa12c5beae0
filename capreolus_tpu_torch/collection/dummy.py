"""Tiny test-fixture collection (the JAX package's ``collection/dummy.py``)."""

from capreolus_tpu_torch.collection import Collection
from capreolus_tpu_torch.core import constants


@Collection.register
class DummyCollection(Collection):
    """A 3-document TREC-format collection used by tests."""

    module_name = "dummy"
    collection_type = "trec"

    @property
    def _path(self):
        return constants["PACKAGE_PATH"] / "data" / "dummy" / "data"

    def doc_count_hint(self):
        return 3
