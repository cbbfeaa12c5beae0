"""First-stage sparse searchers (the JAX package's ``searcher/tpu.py``): BM25
(a k1 x b grid), BM25Grid, QLDirichlet, QLJM, INL2, SPL, F2Exp, F2Log and
BM25RM3, each a scoring model of the engine (``scoring.py``).

The search loop (``TpuSearcherMixin``) analyzes the topics, scores them in
batches of ``QUERY_BATCH`` with at most ``DISPATCH_WINDOW`` batches in flight,
and writes one TREC run file per parameter combination, named and formatted
as the JAX searchers name and format theirs (``_param_tag``, ``_write_run``),
under the done-file protocol. It dispatches as the JAX loop does:

- a single-point BM25 without a cap runs exact block-max pruning
  (``pruning=True``, the default) through the engine's pipelined
  ``search_pruned_stream``: bit-identical to exhaustive scoring;
- otherwise each batch goes through ``search`` with the ``maxpostings`` cap,
  which takes the tiered path above ``EXACT_MAX_DOCS`` docs, under a cap and
  in streaming mode, and the exact path below;
- ``hbmbudget`` (MB) reaches the engine's ``DeviceIndex``: corpora whose tiles
  exceed it run in host-streaming mode.

The searchers run on ``self.device``, an attribute (not a config option, so
the device never enters the module path) that the rank task or the caller
sets; ``None`` means "cuda", which raises without a card. ``shards > 1``
raises ``ConfigError`` (ROADMAP.md item 6, "Multi-device").

On the exact path the port splits an engine call whose dense accumulator
would exceed ``ACC_BUDGET_ELEMENTS`` over its queries first, then over its
grid points (``plan_engine_calls``). Every (grid point, query) row is scored
on its own, so the run files are byte-identical with and without the split.
"""

from __future__ import annotations

import itertools
from collections import Counter, deque
from pathlib import Path

import numpy as np

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.searcher import Searcher, _hbm_budget_mb
from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine, grid_points
from capreolus_tpu_torch.utils.caching import done_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

QUERY_BATCH = 64
# in-flight engine calls during pipelined search dispatch: enough depth that
# result transfers overlap the next calls' compute, small enough that result
# buffers cannot accumulate without bound in device memory
DISPATCH_WINDOW = 4
# Elements G*Q*(N+1) of one engine call's dense f32 accumulator (G grid points,
# Q queries, N docs): 2^26, 256 MiB. Over the resident index one call holds
# about 41 bytes per element at its peak, ~2.7 GB: 40 for the accumulator (4),
# the stable sort's contiguous copy of it (4), its values (4) and int64
# ordinals (8), and cub's alternate key and value buffers (12) with its ordinal
# input (8); the rest for the scores gathered per slot, which grow with the
# queries' postings. chip_smoke.py's phase 8 measures one call at the budget
# on the card (40.64 bytes per element on the 50k golden, an H100) and holds
# it to 44. A result in flight keeps only its [G, Q, topk] slice
# (``_score_exact`` returns compact copies). Unsplit, BM25Grid's default 100
# points at QUERY_BATCH=64 take 320M elements on a 50k-doc corpus (~1.3 GB of
# accumulator, ~13 GB in all) and 3.4G at Robust04's 528k docs (~13.5 GB of
# accumulator, over 130 GB in all).
ACC_BUDGET_ELEMENTS = 1 << 26


def _windowed(result_iter, window=DISPATCH_WINDOW):
    """Drain ``result_iter`` (whose construction IS the device dispatch) at
    most ``window`` items ahead of the consumer."""
    buf = deque()
    for r in result_iter:
        buf.append(r)
        if len(buf) > window:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _load_topics_tsv(topicsfn):
    """[(qid, text)] from a ``qid<TAB>query`` file, skipping blank lines."""
    topics = []
    with open(topicsfn, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                qid, text = line.rstrip("\n").split("\t", 1)
                topics.append((qid, text))
    return topics


def plan_engine_calls(num_queries, grid_size, num_docs, budget):
    """[(q0, q1, g0, g1)]: the engine calls that score ``num_queries`` queries at
    ``grid_size`` grid points with at most ``budget`` accumulator elements
    G*Q*(N+1) each where that can be done, queries split first, then grid
    points (one query at one point takes N+1 elements, whatever the budget).
    Ordered by query range, then grid range, so each grid point's queries come
    in their order."""
    rows = num_docs + 1
    if grid_size * num_queries * rows <= budget:
        q_step, g_step = max(1, num_queries), max(1, grid_size)
    elif grid_size * rows <= budget:
        q_step, g_step = budget // (grid_size * rows), grid_size
    else:
        q_step, g_step = 1, max(1, budget // rows)
    return [(q0, min(q0 + q_step, num_queries), g0, min(g0 + g_step, grid_size))
            for q0 in range(0, max(1, num_queries), q_step) for g0 in range(0, grid_size, g_step)]


def fetch(result):
    """Numpy (scores, ords) [g, q, topk] of an engine result: a pending tiered
    result ([*grid, q, topk]), or the exact path's device tensors."""
    if hasattr(result, "get"):
        scores, ords = result.get()
    else:
        scores, ords = result[0].cpu().numpy(), result[1].cpu().numpy()
    return scores.reshape(-1, *scores.shape[-2:]), ords.reshape(-1, *ords.shape[-2:])


def _ranked(scores, ords, docids):
    """{docid: score} of one query's row, in rank order, up to its first score
    <= 0 (no more matching docs: scores are non-negative)."""
    ranked = {}
    for s, o in zip(scores, ords):
        if s <= 0.0:
            break
        ranked[docids[o]] = float(s)
    return ranked


class TpuSearcherMixin:
    """Shared search loop: analyze queries, batch, run the engine, write run files."""

    model = "bm25"  # scoring model key in SCORING_MODELS
    device = None  # set by the rank task or the caller; None means "cuda"
    engine_calls = 0  # engine calls made by this searcher (more than its batches where they split)

    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    def get_engine(self) -> ScoringEngine:
        self.index.create_index()
        device = self._device()
        if getattr(self, "_engine", None) is None or self._engine.dindex.device != device:
            budget_mb = _hbm_budget_mb(self.config)
            self._engine = ScoringEngine(DeviceIndex(self.index.data, device=device,
                                                     hbm_budget=budget_mb * 1e6 if budget_mb > 0 else None))
        return self._engine

    def grid_params(self):
        """Returns (fixed_params, grid) where grid maps param -> list of values."""
        raise NotImplementedError

    def query_weights(self, text, engine):
        """Analyze a query string into [(term_id, weight)] with qtf weights."""
        vocab = self.index.data.vocab
        counts = Counter(self.index.analyze(text))
        return [(vocab[t], float(c)) for t, c in counts.items() if t in vocab]

    def _query_from_file(self, topicsfn, output_path):
        output_path.mkdir(parents=True, exist_ok=True)
        with done_file(output_path) as already_done:
            if not already_done:
                self._search_all(topicsfn, output_path)
        return output_path

    def query_from_file(self, topicsfn, output_path):
        return self._query_from_file(Path(topicsfn), Path(output_path))

    def _engine_calls(self, engine, term_lists, model, fixed, grid, topk, max_postings=0):
        """Dispatch one batch's engine calls; yields (q0, g0, result) where
        ``fetch(result)`` gives numpy [g, q, topk] scores and ordinals. On the
        exact path the calls stay under the accumulator budget; the tiered
        path scores the batch and its grid in one call. Each call is counted
        in ``self.engine_calls``."""
        if not engine.exact_path(max_postings_per_term=max_postings):
            self.engine_calls += 1
            yield 0, 0, engine.search(term_lists, model=model, params=fixed, grid=grid, topk=topk,
                                      max_postings_per_term=max_postings, materialize=False)
            return
        points = grid_points(grid) if grid else {}
        grid_size = len(next(iter(points.values()))) if points else 1
        plan = plan_engine_calls(len(term_lists), grid_size, engine.dindex.num_docs, ACC_BUDGET_ELEMENTS)
        for q0, q1, g0, g1 in plan:
            part = {k: v[g0:g1] for k, v in points.items()}
            scores, ords = engine.search_points(term_lists[q0:q1], model=model, params=fixed, points=part,
                                                topk=topk, materialize=False)
            self.engine_calls += 1
            yield q0, g0, (scores, ords)

    def _search_batch(self, engine, term_lists, model, params, topk):
        """One batch at one parameter point: (scores, ords) numpy [Q, topk]."""
        parts = [fetch(r) for _, _, r in self._engine_calls(engine, term_lists, model, params, {}, topk)]
        return np.concatenate([s[0] for s, _ in parts]), np.concatenate([o[0] for _, o in parts])

    def _search_all(self, topicsfn, output_path):
        engine = self.get_engine()
        topics = _load_topics_tsv(topicsfn)
        hits = min(int(self.config.get("hits", 1000)), engine.dindex.num_docs)
        fixed, grid = self.grid_params()
        param_axes = tuple(sorted(grid))
        combos = list(itertools.product(*[grid[k] for k in param_axes])) or [()]
        docids = engine.dindex.host.docid_strings

        runs = {self._param_tag(fixed, dict(zip(param_axes, combo))): {} for combo in combos}
        tags = list(runs)

        # exact block-max dynamic pruning (default-on): bit-identical results;
        # engages for single-parameter-point BM25 with no approximate cap
        max_postings = int(self.config.get("maxpostings", 0))
        use_prune = (len(combos) == 1 and max_postings == 0 and bool(self.config.get("pruning", True))
                     and engine.supports_pruning(self.model))

        batches = [topics[s : s + QUERY_BATCH] for s in range(0, len(topics), QUERY_BATCH)]
        batch_terms = [[self.query_weights(text, engine) for _, text in b] for b in batches]
        # pipelined dispatch with a bounded in-flight window: the host builds the
        # run dicts of one batch while the device computes the next ones
        if use_prune:
            prune_params = {**fixed, **dict(zip(param_axes, combos[0]))}
            self.engine_calls += len(batches)
            pending = ((bi, 0, 0, res) for bi, res in enumerate(engine.search_pruned_stream(
                batch_terms, model=self.model, params=prune_params, topk=hits, materialize=False,
                window=DISPATCH_WINDOW)))
        else:
            pending = _windowed(
                (bi, q0, g0, res) for bi, terms in enumerate(batch_terms)
                for q0, g0, res in self._engine_calls(engine, terms, self.model, fixed, grid, hits, max_postings))
        for bi, q0, g0, res in pending:
            scores, ords = fetch(res)  # [g, q, hits]
            for gi in range(scores.shape[0]):
                run = runs[tags[g0 + gi]]
                for qi in range(scores.shape[1]):
                    qid = batches[bi][q0 + qi][0]
                    if batch_terms[bi][q0 + qi]:
                        run[qid] = _ranked(scores[gi, qi], ords[gi, qi], docids)

        for tag, run in runs.items():
            outfn = output_path / tag
            self._write_run(run, outfn)
            logger.info("wrote run file %s (%d queries)", outfn, len(run))

    def _write_run(self, run, outfn):
        with open(outfn, "wt", encoding="utf-8") as f:
            for qid, docs in run.items():
                for rank, (docid, score) in enumerate(docs.items(), start=1):
                    f.write(f"{qid} Q0 {docid} {rank} {score:.6f} capreolus_tpu\n")

    def _param_tag(self, fixed, combo_params):
        parts = [f"searcher_{self.module_name}"]
        for k in sorted({**fixed, **combo_params}):
            v = {**fixed, **combo_params}[k]
            parts.append(f"{k}-{v:g}" if isinstance(v, float) else f"{k}-{v}")
        return "_".join(parts)


class TpuSearcherBase(TpuSearcherMixin, Searcher):
    dependencies = [Dependency(key="index", module="index", name="tpu")]


class _ExpansionSearcherBase(TpuSearcherBase):
    """Shared two-pass search: initial BM25 -> expansion-term selection -> rescore."""

    model = "bm25"

    def combo_grid(self):
        raise NotImplementedError

    def expand_query(self, terms, fb_scores, fb_ords, data, combo):
        raise NotImplementedError

    def _search_all(self, topicsfn, output_path):
        engine = self.get_engine()
        data = engine.dindex.host
        topics = _load_topics_tsv(topicsfn)
        hits = min(int(self.config["hits"]), engine.dindex.num_docs)

        for combo in self.combo_grid():
            run = {}
            k1, b = combo["k1"], combo["b"]
            for start in range(0, len(topics), QUERY_BATCH):
                batch = topics[start : start + QUERY_BATCH]
                term_lists = [self.query_weights(text, engine) for _, text in batch]
                fb_scores, fb_ords = self._search_batch(engine, term_lists, "bm25", {"k1": k1, "b": b},
                                                        int(combo["fbDocs"]))
                expanded = [
                    self.expand_query(term_lists[qi], fb_scores[qi], fb_ords[qi], data, combo)
                    for qi in range(len(batch))
                ]
                scores, doc_ords = self._search_batch(engine, expanded, "bm25", {"k1": k1, "b": b}, hits)
                for qi, (qid, _) in enumerate(batch):
                    if term_lists[qi]:
                        run[qid] = _ranked(scores[qi], doc_ords[qi], data.docid_strings)
            tag = self._param_tag({}, combo)
            self._write_run(run, output_path / tag)
            logger.info("wrote run file %s", output_path / tag)


@Searcher.register
class BM25(TpuSearcherBase):
    """BM25 with k1/b grid search.

    ``shards`` > 1 (postings partitioned across devices) raises ``ConfigError``
    until multi-device search is ported."""

    module_name = "BM25"
    model = "bm25"
    config_spec = [
        ConfigOption("k1", [0.9], "controls term saturation", value_type="floatlist"),
        ConfigOption("b", [0.4], "controls document length normalization", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results to return"),
        ConfigOption("fields", "title", "accepted for reference-config compatibility; "
                     "the TPU index searches merged document contents"),
        ConfigOption("shards", 1, "devices to shard the postings across (1 = single chip)"),
        ConfigOption("maxpostings", 0, "impact-ordered early termination: score only each term's "
                     "top-N highest-impact postings (0 = exact; approximate when set)"),
        ConfigOption("pruning", True, "exact block-max dynamic pruning (WAND/MaxScore semantics): "
                     "skips doc ranges provably below the top-k threshold; results are "
                     "bit-identical to exhaustive scoring"),
        ConfigOption("hbmbudget", 12000.0, "HBM budget (MB) for resident postings tiles; corpora "
                     "whose tiles exceed it run in host-streaming mode (per-batch working-set "
                     "uploads, like Lucene's disk-resident postings). 0 = always resident"),
    ]
    config_keys_not_in_path = ["shards", "pruning", "hbmbudget"]  # none changes results

    def build(self):
        if int(self.config.get("shards", 1)) > 1:
            raise ConfigError(f"searcher.shards={self.config['shards']}: multi-device search is not ported "
                              f"to PyTorch yet (ROADMAP.md item 6, 'Multi-device')")

    def grid_params(self):
        return {}, {"k1": list(self.config["k1"]), "b": list(self.config["b"])}


@Searcher.register
class BM25Grid(TpuSearcherBase):
    """BM25 over a full k1 x b grid defined by ranges."""

    module_name = "BM25Grid"
    model = "bm25"
    config_spec = [
        ConfigOption("k1max", 1.0, "maximum k1"),
        ConfigOption("bmax", 1.0, "maximum b"),
        ConfigOption("k1min", 0.1, "minimum k1"),
        ConfigOption("bmin", 0.1, "minimum b"),
        ConfigOption("step", 0.1, "grid step"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        c = self.config
        k1s = list(np.round(np.arange(c["k1min"], c["k1max"] + 1e-9, c["step"]), 4))
        bs = list(np.round(np.arange(c["bmin"], c["bmax"] + 1e-9, c["step"]), 4))
        return {}, {"k1": k1s, "b": bs}


@Searcher.register
class QLDirichlet(TpuSearcherBase):
    """Query likelihood with Dirichlet smoothing."""

    module_name = "QLDirichlet"
    model = "qld"
    config_spec = [
        ConfigOption("mu", [1000.0], "smoothing parameter", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"mu": list(self.config["mu"])}


@Searcher.register
class QLJM(TpuSearcherBase):
    """Query likelihood with Jelinek-Mercer smoothing."""

    module_name = "QLJM"
    model = "qljm"
    config_spec = [
        ConfigOption("lam", [0.1], "smoothing lambda", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"lam": list(self.config["lam"])}


@Searcher.register
class INL2(TpuSearcherBase):
    """DFR I(n)L2."""

    module_name = "INL2"
    model = "inl2"
    config_spec = [
        ConfigOption("c", [0.1], "hyperparameter", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"c": list(self.config["c"])}


@Searcher.register
class SPL(TpuSearcherBase):
    """DFR SPL."""

    module_name = "SPL"
    model = "spl"
    config_spec = [
        ConfigOption("c", [0.1], "hyperparameter", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"c": list(self.config["c"])}


@Searcher.register
class F2Exp(TpuSearcherBase):
    """Axiomatic F2EXP."""

    module_name = "F2Exp"
    model = "f2exp"
    config_spec = [
        ConfigOption("s", [0.5], "hyperparameter", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"s": list(self.config["s"])}


@Searcher.register
class F2Log(TpuSearcherBase):
    """Axiomatic F2LOG."""

    module_name = "F2Log"
    model = "f2log"
    config_spec = [
        ConfigOption("s", [0.5], "hyperparameter", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"s": list(self.config["s"])}


@Searcher.register
class BM25RM3(_ExpansionSearcherBase):
    """BM25 with RM3 pseudo-relevance feedback.

    Stage 1 BM25 retrieves feedback docs; the relevance model is estimated from the
    forward index (term vectors scaled by doc score, L1-normalized, top fbTerms kept),
    interpolated with the original query, and rescored with per-term weights.
    """

    module_name = "BM25RM3"
    model = "bm25"
    config_spec = [
        ConfigOption("k1", [0.9], "term saturation", value_type="floatlist"),
        ConfigOption("b", [0.4], "length normalization", value_type="floatlist"),
        ConfigOption("fbTerms", [5, 25], "expansion terms", value_type="intlist"),
        ConfigOption("fbDocs", [5, 10], "feedback depth", value_type="intlist"),
        ConfigOption("originalQueryWeight", [0.5], "original query interpolation", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def combo_grid(self):
        c = self.config
        for k1, b, fbt, fbd, oqw in itertools.product(c["k1"], c["b"], c["fbTerms"], c["fbDocs"],
                                                      c["originalQueryWeight"]):
            yield {"k1": k1, "b": b, "fbTerms": fbt, "fbDocs": fbd, "originalQueryWeight": oqw}

    def expand_query(self, terms, fb_scores, fb_ords, data, combo):
        return self._rm3_expand(terms, fb_scores, fb_ords, data, combo["fbTerms"], combo["originalQueryWeight"])

    @staticmethod
    def _rm3_expand(terms, fb_scores, fb_ords, data, fb_terms, oqw):
        if not terms:
            return terms
        weights = {}
        valid = fb_scores > 0
        total_score = float(fb_scores[valid].sum()) or 1.0
        for score, ord_ in zip(fb_scores[valid], fb_ords[valid]):
            s, e = data.fwd_offsets[ord_], data.fwd_offsets[ord_ + 1]
            tids = data.fwd_term_ids[s:e]
            tfs = data.fwd_tfs[s:e].astype(np.float64)
            dl = max(1.0, float(tfs.sum()))
            contrib = (tfs / dl) * (float(score) / total_score)
            for tid, w in zip(tids, contrib):
                weights[int(tid)] = weights.get(int(tid), 0.0) + float(w)
        top = sorted(weights.items(), key=lambda kv: -kv[1])[: int(fb_terms)]
        norm = sum(w for _, w in top) or 1.0
        fb_part = {tid: w / norm for tid, w in top}

        q_norm = sum(w for _, w in terms) or 1.0
        combined = {tid: oqw * w / q_norm for tid, w in terms}
        for tid, w in fb_part.items():
            combined[tid] = combined.get(tid, 0.0) + (1.0 - oqw) * w
        return sorted(combined.items())
