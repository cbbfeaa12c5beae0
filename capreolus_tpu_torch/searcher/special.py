"""Static-run and MS MARCO searchers (the JAX package's ``searcher/special.py``,
in part): the ``StaticRunSearcher`` base, which hands back a run file the user
names in ``runfile``, and ``msmarcopsgbm25``. The searchers that read
downloaded or packaged runs (``msmarcopsg``, ``static_tct_colbert``,
``msptop200`` and the canned ``bm25static*`` runs) are not ported yet
(ROADMAP.md item 3b).

``msmarcopsgbm25`` is BM25 at the MS MARCO passage settings. The JAX searcher
of that name fails with ``KeyError: 'shards'`` (its config has no ``shards``
and its search reads one); the port's searches.
"""

from __future__ import annotations

import shutil
from pathlib import Path

from capreolus_tpu_torch.core import ConfigOption
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.searcher.tpu import BM25
from capreolus_tpu_torch.utils.caching import done_file


class StaticRunSearcher(Searcher):
    """A searcher that returns a pre-computed run file (``runfile``) instead of searching."""

    config_spec = [ConfigOption("runfile", None, "path to a local TREC run file")]

    def _get_run_file(self):
        configured = self.config.get("runfile")
        if not configured:
            raise IOError(f"searcher {self.module_name} needs a runfile config option")
        return configured

    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if not already:
                shutil.copy(self._get_run_file(), output_path / "static_run")
        return output_path


@Searcher.register
class MsmarcoPsgBm25(BM25):
    """BM25 over the MS MARCO passage index with the official candidate-set sizes."""

    module_name = "msmarcopsgbm25"
    config_spec = [
        ConfigOption("k1", [0.82], "term saturation", value_type="floatlist"),
        ConfigOption("b", [0.68], "length normalization", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
        ConfigOption("tripleversion", "small", "triples file version: small, large.v1, or large.v2"),
    ]
