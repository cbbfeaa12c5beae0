"""Static-run and MS MARCO searchers (the JAX package's ``searcher/special.py``):
``StaticRunSearcher``, which hands back a run file, with the eleven canned
runs (``bm25static*``, ``rm3static*``, ``qdelstaticcovidabstract``) resolved
from ``runfile``, then the run shipped in the port's ``data/``, then a
download (``OfflineEnvironmentError`` offline); ``msmarcopsg`` (the official
MS MARCO candidate sets from local files), ``msmarcopsgbm25``,
``static_tct_colbert`` and ``msptop200``.

``msmarcopsgbm25`` is BM25 at the MS MARCO passage settings. The JAX searcher
of that name fails with ``KeyError: 'shards'`` (its config has no ``shards``
and its search reads one); the port's searches.
"""

from __future__ import annotations

import shutil
from pathlib import Path

from capreolus_tpu_torch.core import ConfigOption, Dependency, constants
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.searcher.tpu import BM25
from capreolus_tpu_torch.utils.caching import done_file
from capreolus_tpu_torch.utils.common import download_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


class StaticRunSearcher(Searcher):
    """A searcher that returns a pre-computed run file instead of searching.

    Subclasses set ``run_url`` (downloaded, gated offline) or users set ``runfile``.
    """

    run_url = None
    config_spec = [ConfigOption("runfile", None, "path to a local TREC run file")]

    def _get_run_file(self):
        configured = self.config.get("runfile")
        if configured:
            return configured
        if self.run_url is None:
            raise IOError(f"searcher {self.module_name} needs a runfile config option")
        # runs the reference distributes inside its package are shipped in the
        # port's data/ too, so these searchers work offline
        packaged = constants["PACKAGE_PATH"] / "data" / self.run_url.split("/")[-1]
        if packaged.exists():
            return packaged
        dest = self.get_cache_path() / "static" / self.run_url.split("/")[-1]
        return download_file(self.run_url, dest)

    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if not already:
                shutil.copy(self._get_run_file(), output_path / "static_run")
        return output_path


_CAPREOLUS_RAW = "https://raw.githubusercontent.com/capreolus-ir/capreolus/master/capreolus/data"

# the reference ships 11 canned run files as StaticRun searchers
# (searcher/anserini.py:277-344); registered here by the same names, fetching the
# same runs from their public source
_STATIC_RUNS = {
    "bm25staticrob04yang19": f"{_CAPREOLUS_RAW}/rob04_yang19_rm3.run",
    "bm25staticrob04yang19desc": f"{_CAPREOLUS_RAW}/rob04_yang19_desc_rm3.run",
    "bm25staticrob04huston14title": f"{_CAPREOLUS_RAW}/rob04_huston14_title_rm3.run",
    "bm25staticrob04huston14desc": f"{_CAPREOLUS_RAW}/rob04_huston14_desc_rm3.run",
    "bm25staticgov2": f"{_CAPREOLUS_RAW}/gov2_bm25.run",
    "bm25staticgov2desc": f"{_CAPREOLUS_RAW}/gov2_desc_bm25.run",
    "bm25staticgenomics": f"{_CAPREOLUS_RAW}/genomics_bm25.run",
    "bm25staticcds": f"{_CAPREOLUS_RAW}/cds_bm25.run",
    "qdelstaticcovidabstract": f"{_CAPREOLUS_RAW}/anserini.covid-r5.abstract.qdel.bm25-top1k.txt",
    "rm3staticcore18title": f"{_CAPREOLUS_RAW}/core18_title_rm3.run",
    "rm3staticcore18desc": f"{_CAPREOLUS_RAW}/core18_desc_rm3.run",
}

for _name, _url in _STATIC_RUNS.items():
    cls = type(
        f"StaticRun_{_name.replace('.', '_')}",
        (StaticRunSearcher,),
        {"module_name": _name, "run_url": _url,
         "__doc__": f"Canned run file searcher '{_name}' (parity: searcher/anserini.py:255-345)."},
    )
    Searcher.register(cls)


@Searcher.register
class MsmarcoPsg(Searcher):
    """Official MS MARCO candidate sets: fake train run from the official triples +
    top-1000 dev candidates (parity: searcher/special.py:72-113)."""

    module_name = "msmarcopsg"
    dependencies = [Dependency(key="benchmark", module="benchmark", name="msmarcopsg")]
    config_spec = [ConfigOption("tripletsfile", None, "path to qidpidtriples train file"),
                   ConfigOption("top1000file", None, "path to top1000.dev file"),
                   ConfigOption("tripleversion", "small", "triples file version: small, large.v1, or "
                                "large.v2 (parity: special.py:81; selects which official file to supply)")]

    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if not already:
                self._build_run(output_path)
        return output_path

    def _build_run(self, output_path):
        triples = self.config.get("tripletsfile")
        top1000 = self.config.get("top1000file")
        if not triples or not top1000:
            raise IOError(
                "msmarcopsg searcher needs searcher.tripletsfile (qidpidtriples.train) and "
                "searcher.top1000file (top1000.dev) from the official MS MARCO downloads"
            )
        out = output_path / "searcher_msmarcopsg"
        with open(out, "wt", encoding="utf-8") as f:
            seen = set()
            with open(triples, encoding="utf-8") as t:
                for line in t:
                    qid, pos, neg = line.split()[:3]
                    for rank, pid in enumerate((pos, neg), start=1):
                        if (qid, pid) not in seen:
                            seen.add((qid, pid))
                            f.write(f"{qid} Q0 {pid} {rank} {1.0 / rank} msmarcopsg\n")
            with open(top1000, encoding="utf-8") as t:
                rank_per_qid = {}
                for line in t:
                    qid, pid = line.split()[:2]
                    rank = rank_per_qid.get(qid, 0) + 1
                    rank_per_qid[qid] = rank
                    f.write(f"{qid} Q0 {pid} {rank} {1.0 / rank} msmarcopsg\n")


@Searcher.register
class MsmarcoPsgBm25(BM25):
    """BM25 over the MS MARCO passage index with the official candidate-set sizes
    (parity: searcher/special.py:117-165)."""

    module_name = "msmarcopsgbm25"
    config_spec = [
        ConfigOption("k1", [0.82], "term saturation", value_type="floatlist"),
        ConfigOption("b", [0.68], "length normalization", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
        ConfigOption("tripleversion", "small", "triples file version: small, large.v1, or large.v2 "
                     "(parity: special.py:129)"),
    ]


@Searcher.register
class StaticTctColBert(StaticRunSearcher):
    """TCT-ColBERT dense run download (parity: searcher/special.py:170-212)."""

    module_name = "static_tct_colbert"
    run_url = None  # castorini download requires auth; supply runfile


@Searcher.register
class MsPsgTop200(StaticRunSearcher):
    """Top-200 candidates for MS MARCO passage (parity: searcher/special.py:216-305).

    The reference downloads per-split runs from Google Drive selected by the
    ``firststage`` option (tct, bm25, or train>dev combos like tct>bm25); those
    links require authentication, so here the option selects which local
    ``runfile`` semantics apply and is accepted for config compatibility."""

    module_name = "msptop200"
    run_url = None
    config_spec = StaticRunSearcher.config_spec + [
        ConfigOption("firststage", "tct", "first-stage source: tct, bm25, tct>bm25, or bm25>tct "
                     "(parity: searcher/special.py:225-231)"),
    ]
