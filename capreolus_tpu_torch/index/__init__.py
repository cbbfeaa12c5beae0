"""Index modules (the JAX package's ``index/__init__.py``): idempotent
``create_index`` via a done file, and ``get_doc``/``get_docs``/``get_df``/``get_idf``."""

from __future__ import annotations

from capreolus_tpu_torch.core import Dependency, ModuleBase, import_all_modules, register_module_type


@register_module_type
class Index(ModuleBase):
    """Base class for Index modules."""

    module_type = "index"
    dependencies = [Dependency(key="collection", module="collection", name="dummy")]

    def get_index_path(self):
        return self.get_cache_path() / "index"

    def exists(self):
        return (self.get_index_path() / "done").exists()

    def create_index(self):
        if self.exists():
            return
        self._create_index()
        (self.get_index_path() / "done").write_text("done")

    def _create_index(self):
        raise NotImplementedError

    def get_doc(self, docid):
        raise NotImplementedError

    def get_docs(self, docids):
        return [self.get_doc(docid) for docid in docids]

    def get_df(self, term):
        raise NotImplementedError

    def get_idf(self, term):
        raise NotImplementedError


import_all_modules(__file__, __package__)
