"""Searcher modules: first-stage ranking (the JAX package's
``searcher/__init__.py``).

The ``Searcher`` base gives run-file IO, ``query_from_file`` and the
interactive ``query``. Ported so far: the exact sparse scoring engine
(``scoring.py``, served by ``serving.RetrievalService``) and the
late-interaction searcher ``colbert`` (``late_interaction.py``). The BM25
family of searcher modules comes with the rank task (ROADMAP).
"""

from __future__ import annotations

import os

from capreolus_tpu_torch.core import ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.trec import load_trec_run, write_trec_run


def _hbm_budget_mb(config):
    """hbmbudget in MB; only a missing or None key falls back to the default,
    so an explicit 0 is honoured."""
    v = config.get("hbmbudget", 12000.0)
    return 12000.0 if v is None else float(v)


@register_module_type
class Searcher(ModuleBase):
    """Base class for Searcher modules."""

    module_type = "searcher"

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
