"""Searcher modules: first-stage ranking (the JAX package's
``searcher/__init__.py``).

The ``Searcher`` base gives run-file IO, ``query_from_file`` and the
interactive ``query``. Ported so far: the exact sparse scoring engine
(``scoring.py``) with the BM25 family (``tpu.py``), the feedback searchers
(``feedback.py``), fusion (``fusion.py``), ``msmarcopsgbm25`` and the static-run
base (``special.py``), and the late-interaction searcher ``colbert``
(``late_interaction.py``). Creating a JAX searcher that is not ported yet
raises ``ConfigError`` naming the ROADMAP.md item that queues it.
"""

from __future__ import annotations

import os

from capreolus_tpu_torch.core import ConfigError, ModuleBase, import_all_modules, module_registry, register_module_type
from capreolus_tpu_torch.utils.trec import load_trec_run, write_trec_run


def _hbm_budget_mb(config):
    """hbmbudget in MB; only a missing or None key falls back to the default,
    so an explicit 0 is honoured."""
    v = config.get("hbmbudget", 12000.0)
    return 12000.0 if v is None else float(v)


_DENSE = "item 6, 'Dense and learned-sparse retrieval'"
_DOWNLOADS = "item 3b (searchers that read downloaded runs)"
# the JAX package's searchers that the port lacks, and the ROADMAP.md item that queues each
UNPORTED_SEARCHERS = {
    "dense": _DENSE,
    "impact": _DENSE,
    "msmarcopsg": _DOWNLOADS,
    "static_tct_colbert": _DOWNLOADS,
    "msptop200": _DOWNLOADS,
    **{name: _DOWNLOADS for name in (
        "bm25staticrob04yang19", "bm25staticrob04yang19desc", "bm25staticrob04huston14title",
        "bm25staticrob04huston14desc", "bm25staticgov2", "bm25staticgov2desc", "bm25staticgenomics",
        "bm25staticcds", "qdelstaticcovidabstract", "rm3staticcore18title", "rm3staticcore18desc")},
}


@register_module_type
class Searcher(ModuleBase):
    """Base class for Searcher modules."""

    module_type = "searcher"

    @classmethod
    def create(cls, name=None, config=None, provide=None):
        wanted = name or (config or {}).get("name")
        if wanted in UNPORTED_SEARCHERS and wanted not in module_registry.get_module_names("searcher"):
            raise ConfigError(f"searcher {wanted!r} is not ported to PyTorch yet "
                              f"(ROADMAP.md {UNPORTED_SEARCHERS[wanted]})")
        return super().create(name, config, provide)

    @staticmethod
    def load_trec_run(fn):
        return load_trec_run(fn)

    @staticmethod
    def write_trec_run(preds, outfn, mode="wt"):
        return write_trec_run(preds, outfn, mode=mode)

    def query_from_file(self, topicsfn, output_path):
        """Run all topics in the qid\\tquery TSV ``topicsfn``; returns output_path
        containing one TREC run file per searcher parameter combination."""
        raise NotImplementedError

    def query(self, query_string):
        """Search for a single query string; returns {docid: score} per param config."""
        import tempfile
        from pathlib import Path

        index = getattr(self, "index", None)
        if index is not None:
            index.create_index()
        with tempfile.TemporaryDirectory() as tmpdir:
            topicsfn = Path(tmpdir) / "topic.tsv"
            topicsfn.write_text(f"q1\t{query_string}\n")
            results_dir = Path(tmpdir) / "results"
            self.query_from_file(topicsfn, results_dir)

            runs = {}
            for fn in sorted(os.listdir(results_dir)):
                if fn == "done" or not (results_dir / fn).is_file():
                    continue
                run = load_trec_run(results_dir / fn)
                runs[fn] = run.get("q1", {})
        if len(runs) == 1:
            return next(iter(runs.values()))
        return runs


import_all_modules(__file__, __package__)
