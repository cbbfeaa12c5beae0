"""Hybrid first-stage retrieval (the JAX package's ``searcher/fusion.py``):
fuse two searchers' rankings with reciprocal rank fusion or score
interpolation. Both sub-searchers run over the same collection (the
dependency graph provides it to both), each through its own engine, on the
device the caller sets on each (the rank task sets its own on both). The
default ``searcher2`` is ``dense``, as in the JAX package, so that configs and
paths match; the port lacks it, and creating fusion with it raises
``ConfigError`` (ROADMAP.md item 6). ``colbert`` and the sparse searchers work.

Fusion methods:

- ``rrf`` (default): reciprocal rank fusion, score = sum_r 1/(k + rank_r)
  over the runs that retrieved the doc (Cormack et al., SIGIR'09). Rank-based,
  so incomparable score scales (BM25 vs cosine) need no calibration; k=60 is
  the published default.
- ``interp``: per-query min-max normalization of each run to [0, 1], then
  alpha * searcher1 + (1 - alpha) * searcher2 (missing docs contribute 0 from
  that run) — the same convex mixing the rerank task uses, applied at the
  first stage.

Grid-searched sub-searchers (float-list parameters) emit one run file per
parameter combination; fusion takes the CROSS PRODUCT and emits one fused run
per (run1, run2) combination, so a parameter sweep on either side is fully
evaluated downstream by ``search_best_run`` (the common case is a single
combination on each side, producing a single fused run).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.utils.caching import done_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def rrf_fuse(runs, k=60, hits=1000):
    """Reciprocal rank fusion of {qid: {docid: score}} runs (rank-based)."""
    fused = {}
    for run in runs:
        for qid, docs in run.items():
            agg = fused.setdefault(qid, {})
            ranked = sorted(docs.items(), key=lambda kv: (-kv[1], kv[0]))
            for rank, (docid, _) in enumerate(ranked, start=1):
                agg[docid] = agg.get(docid, 0.0) + 1.0 / (k + rank)
    return _top(fused, hits)


def interp_fuse(run1, run2, alpha=0.5, hits=1000):
    """Convex mix of per-query min-max-normalized scores."""

    def normalize(docs):
        if not docs:
            return {}
        lo, hi = min(docs.values()), max(docs.values())
        span = hi - lo
        if span <= 0:  # constant scores: every retrieved doc counts fully
            return {d: 1.0 for d in docs}
        return {d: (s - lo) / span for d, s in docs.items()}

    fused = {}
    for qid in set(run1) | set(run2):
        n1 = normalize(run1.get(qid, {}))
        n2 = normalize(run2.get(qid, {}))
        fused[qid] = {d: alpha * n1.get(d, 0.0) + (1 - alpha) * n2.get(d, 0.0)
                      for d in set(n1) | set(n2)}
    return _top(fused, hits)


def _top(fused, hits):
    return {qid: dict(sorted(docs.items(), key=lambda kv: (-kv[1], kv[0]))[:hits])
            for qid, docs in fused.items()}


@Searcher.register
class FusionSearcher(Searcher):
    """Hybrid retrieval: run searcher1 and searcher2, fuse their rankings."""

    module_name = "fusion"
    dependencies = [
        Dependency(key="searcher1", module="searcher", name="BM25"),
        Dependency(key="searcher2", module="searcher", name="dense"),
    ]
    config_spec = [
        ConfigOption("method", "rrf", "fusion method: rrf (reciprocal rank fusion, "
                     "rank-based — no score calibration needed) or interp (per-query "
                     "min-max normalized convex mix)"),
        ConfigOption("k", 60, "RRF rank constant (method=rrf)", value_type="int"),
        ConfigOption("alpha", 0.5, "weight on searcher1 (method=interp)"),
        ConfigOption("hits", 1000, "fused results per query", value_type="int"),
    ]

    def build(self):
        if self.config["method"] not in ("rrf", "interp"):
            raise ConfigError(f"fusion method must be 'rrf' or 'interp', "
                              f"got {self.config['method']!r}")

    def fuse(self, run1, run2):
        """Fuse two loaded runs ({qid: {docid: score}})."""
        hits = int(self.config["hits"])
        if self.config["method"] == "rrf":
            return rrf_fuse([run1, run2], k=int(self.config["k"]), hits=hits)
        return interp_fuse(run1, run2, alpha=float(self.config["alpha"]), hits=hits)

    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if already:
                return output_path
            runs1 = self._sub_runs(self.searcher1, topicsfn, output_path / "searcher1")
            runs2 = self._sub_runs(self.searcher2, topicsfn, output_path / "searcher2")
            if not runs1 or not runs2:
                raise ValueError("a sub-searcher produced no run files")
            if len(runs1) > 1 or len(runs2) > 1:
                logger.info("fusing the %d x %d cross product of grid-searched "
                            "sub-runs", len(runs1), len(runs2))
            single = len(runs1) == 1 and len(runs2) == 1
            loaded2 = [self.load_trec_run(p) for p in runs2]
            for i, p1 in enumerate(runs1):
                run1 = self.load_trec_run(p1)
                for j, run2 in enumerate(loaded2):
                    fused = self.fuse(run1, run2)
                    ordered = OrderedDict(
                        (qid, fused[qid]) for qid in sorted(fused, key=_qid_sort_key))
                    tag = "" if single else f"_{i}x{j}"
                    self.write_trec_run(
                        ordered,
                        output_path / f"searcher_fusion_method-{self.config['method']}{tag}")
        return output_path

    @staticmethod
    def _sub_runs(searcher, topicsfn, outdir):
        out = searcher.query_from_file(topicsfn, outdir)
        return sorted(p for p in out.iterdir() if p.name != "done" and p.is_file())


def _qid_sort_key(qid):
    return (0, int(qid)) if qid.isdigit() else (1, qid)
