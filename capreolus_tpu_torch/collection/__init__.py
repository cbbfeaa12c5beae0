"""Collection modules: document corpora (the ``trec`` format of the JAX
package's ``collection/__init__.py``).

Path resolution: config ``path`` -> class ``_path`` attribute. Other on-disk
formats and downloadable corpora are not ported in this slice.
"""

from __future__ import annotations

import os
from pathlib import Path

from capreolus_tpu_torch.core import ConfigOption, ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.trec import iterate_trec_docs


@register_module_type
class Collection(ModuleBase):
    """Base class for Collection modules (``collection_type`` "trec")."""

    module_type = "collection"
    collection_type = "trec"
    _path = None

    config_spec = [ConfigOption("path", None, "path to corpus on disk (overrides the default)")]

    def get_path(self) -> Path:
        configured = self.config.get("path")
        if configured and os.path.exists(configured):
            return Path(configured)
        if self._path and os.path.exists(self._path):
            return Path(self._path)
        raise IOError(
            f"collection {self.module_name} does not exist at path={self.config.get('path')}; "
            f"set collection.path to the corpus location"
        )

    def _document_files(self, path: Path):
        if path.is_file():
            return [path]
        return sorted(p for p in path.rglob("*") if p.is_file() and not p.name.startswith("."))

    def get_doc_iterator(self):
        """Yield (docid, contents) for every document in the collection."""
        if self.collection_type != "trec":
            raise ValueError(f"collection_type {self.collection_type!r} is not ported yet; only 'trec' is")
        for fn in self._document_files(self.get_path()):
            yield from iterate_trec_docs(fn)


import_all_modules(__file__, __package__)
