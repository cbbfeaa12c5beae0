"""Collection modules: document corpora (the JAX package's
``collection/__init__.py``). A Collection yields parsed ``(docid, contents)``
pairs to the index builder.

Path resolution: config ``path`` -> class ``_path`` attribute ->
``download_if_missing()``.
"""

from __future__ import annotations

import os
from pathlib import Path

from capreolus_tpu_torch.core import ConfigOption, ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.trec import iterate_jsonl_docs, iterate_trec_docs, iterate_trecweb_docs


@register_module_type
class Collection(ModuleBase):
    """Base class for Collection modules.

    Subclasses set ``collection_type`` ("trec", "trecweb", "jsonl", or "tsv")
    describing the on-disk format, and either a ``_path`` or a
    ``download_if_missing`` method.
    """

    module_type = "collection"
    collection_type = "trec"
    is_large_collection = False
    _path = None

    config_spec = [ConfigOption("path", None, "path to corpus on disk (overrides the default)")]

    def get_path(self) -> Path:
        configured = self.config.get("path")
        if configured and os.path.exists(configured):
            return Path(configured)
        if self._path and os.path.exists(self._path):
            return Path(self._path)
        return Path(self.download_if_missing())

    def download_if_missing(self):
        raise IOError(
            f"collection {self.module_name} does not exist at path={self.config.get('path')} "
            f"and cannot be downloaded automatically; set collection.path to the corpus location"
        )

    def _document_files(self, path: Path):
        if path.is_file():
            return [path]
        return sorted(p for p in path.rglob("*") if p.is_file() and not p.name.startswith("."))

    def get_doc_iterator(self):
        """Yield (docid, contents) for every document in the collection."""
        path = self.get_path()
        for fn in self._document_files(path):
            if self.collection_type == "trec":
                yield from iterate_trec_docs(fn)
            elif self.collection_type == "trecweb":
                yield from iterate_trecweb_docs(fn)
            elif self.collection_type == "jsonl":
                yield from iterate_jsonl_docs(fn)
            elif self.collection_type == "tsv":
                with open(fn, encoding="utf-8", errors="replace") as f:
                    for line in f:
                        if line.strip():
                            docid, text = line.rstrip("\n").split("\t", 1)
                            yield docid, text
            else:
                raise ValueError(f"unknown collection_type {self.collection_type}")

    def doc_count_hint(self):
        """Optional: number of docs if cheaply known (for progress displays)."""
        return None


import_all_modules(__file__, __package__)
