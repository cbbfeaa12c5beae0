"""Batched scoring engine over the inverted index (the exact path of the JAX
package's ``searcher/scoring.py``).

The CSR postings arrays (doc ids + term freqs) are reshaped into fixed-size tiles
``[n_tiles, TILE]`` and placed on the device once. A query batch is flattened on
the host into work units, one (query, tile) pair each, carrying the per-term
weights and the valid [lo, hi) range inside the tile. On the device:

    gather tiles -> elementwise scoring model -> scatter-add into a dense
    [Q, N+1] accumulator -> stable sort by score -> slice k

All scoring models (BM25, QL-Dirichlet, QL-JM, DFR INL2, SPL, F2Exp, F2Log, and
impact) share this engine and differ only in the elementwise formula; a
parameter grid is a written-out leading batch axis that shares the gathers.

Parity with the JAX engine (identical rankings, f32 scores within a few ulp):

- each formula keeps the JAX op order, in f32, with idf computed in f64 on the
  host and cast. XLA's CPU backend contracts a multiply and an add into one FMA
  and folds a division by a compile-time constant (avgdl) into a multiplication
  by its reciprocal, so single scores may differ in the last bits; equal
  inputs still give equal scores, so exact ties stay ties on both sides;
- payload tiles are int32 doc ids and f32 tf / doc lengths (the JAX engine
  stores exactly-representable bf16 payloads, which decode to the same f32
  values);
- the accumulator is filled one query-term slot at a time: within a slot every
  (query, doc) occurs once, so each document's sum is taken in query-term order
  on every device, with no colliding atomics (the JAX CPU scatter applies its
  updates in that order too);
- ties are broken by ascending internal doc ordinal (Lucene's docid tie-break,
  ``lax.top_k``'s order): a stable descending sort, then a slice. ``torch.topk``
  promises no tie order on CUDA.

Not ported in this slice: the tiered path, ordinal packing, block-max pruning,
host streaming and the pruning verdict store.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

TILE = 512


# --------------------------------------------------------------------- scoring models
# Each model maps elementwise (tf, dl, w1, w2, params, stats) -> score contribution.
# w1/w2 are per-term scalars baked host-side (idf, qtf, collection probability, df...).
# Every operand is an f32 tensor, so torch computes each op in f32 like XLA does.


def _bm25(tf, dl, w1, w2, params, stats):
    # w1 = qtf * idf;  Lucene 8+ BM25: idf * tf / (tf + k1*(1 - b + b*dl/avgdl))
    k1, b = params["k1"], params["b"]
    denom = tf + k1 * (1.0 - b + b * dl / stats["avgdl"])
    return w1 * tf / denom


def _impact(tf, dl, w1, w2, params, stats):
    # learned-sparse impact index: the tf payload is the quantized impact
    return w1 * tf


def _qld(tf, dl, w1, w2, params, stats):
    # w1 = qtf, w2 = P(t|C);  Lucene LMDirichletSimilarity with per-term floor at 0
    mu = params["mu"]
    score = torch.log1p(tf / (mu * w2)) + torch.log(mu / (dl + mu))
    return w1 * torch.clamp_min(score, 0.0)


def _qljm(tf, dl, w1, w2, params, stats):
    # w1 = qtf, w2 = P(t|C);  Lucene LMJelinekMercerSimilarity
    lam = params["lam"]
    dl = torch.clamp_min(dl, 1.0)
    return w1 * torch.log1p(((1.0 - lam) / lam) * (tf / dl) / w2)


def _inl2(tf, dl, w1, w2, params, stats):
    # DFR I(n)L2: tfn = tf * log2(1 + c*avgdl/dl); w1 = qtf, w2 = df
    c = params["c"]
    dl = torch.clamp_min(dl, 1.0)
    tfn = tf * (torch.log1p(c * stats["avgdl"] / dl) / stats["log2"])
    info = torch.log(stats["num_docs_p1"] / (w2 + 0.5)) / stats["log2"]
    return w1 * (1.0 / (tfn + 1.0)) * tfn * info


def _spl(tf, dl, w1, w2, params, stats):
    # SPL (smoothed power law): w1 = qtf, w2 = cf (collection tf)
    c = params["c"]
    dl = torch.clamp_min(dl, 1.0)
    tfn = tf * torch.log1p(c * stats["avgdl"] / dl) / stats["log2"]
    lam = w2 / stats["num_docs"]
    lam = torch.clamp(lam, 1e-9, 1.0 - 1e-9)
    score = -torch.log((torch.pow(lam, tfn / (tfn + 1.0)) - lam) / (1.0 - lam) + 1e-30)
    return w1 * torch.where(tf > 0, torch.clamp_min(score, 0.0), 0.0)


def _f2exp(tf, dl, w1, w2, params, stats):
    # axiomatic F2EXP: w1 = qtf, w2 = df
    s = params["s"]
    tfs = tf / (tf + s + s * dl / stats["avgdl"])
    return w1 * tfs * torch.pow(stats["num_docs_p1"] / w2, params.get("k", stats["f2exp_k"]))


def _f2log(tf, dl, w1, w2, params, stats):
    # axiomatic F2LOG: w1 = qtf, w2 = df
    s = params["s"]
    tfs = tf / (tf + s + s * dl / stats["avgdl"])
    return w1 * tfs * torch.log(stats["num_docs_p1"] / w2)


SCORING_MODELS = {
    "bm25": _bm25,
    "impact": _impact,
    "qld": _qld,
    "qljm": _qljm,
    "inl2": _inl2,
    "spl": _spl,
    "f2exp": _f2exp,
    "f2log": _f2log,
}

# models that read only the quantized (norm) doc-length payload, or none at all
_NORM_DL_MODELS = ("bm25", "impact")

# which statistic feeds the w2 channel for each model
_W2_SOURCE = {
    "bm25": "none",
    "impact": "none",
    "qld": "ptc",
    "qljm": "ptc",
    "inl2": "df",
    "spl": "cf",
    "f2exp": "df",
    "f2log": "df",
}


class DeviceIndex:
    """Tiled postings + statistics tables, resident on ``device``.

    Tiles are int32 doc ids and f32 payloads; pad postings carry doc id
    ``num_docs`` (a sentinel accumulator row that is dropped) and tf 0."""

    def __init__(self, index_data, device):
        self.host = index_data
        self.device = torch.device(device)
        nnz = len(index_data.doc_ids)
        n_tiles = max(1, (nnz + TILE - 1) // TILE)
        padded = n_tiles * TILE
        self.n_tiles = n_tiles

        doc_ids = np.full(padded, index_data.num_docs, dtype=np.int32)
        doc_ids[:nnz] = index_data.doc_ids
        tfs = np.zeros(padded, dtype=np.float32)
        tfs[:nnz] = index_data.tfs
        norm_dl_table = np.append(index_data.norm_doclens, 1).astype(np.float32)
        self._doc_ids_np = doc_ids
        self._exact_dl_table = np.append(index_data.doclens, 1).astype(np.float32)

        def put(arr):
            return torch.from_numpy(arr.reshape(n_tiles, TILE)).to(self.device)

        self.doc_tiles = put(doc_ids)
        self.tf_tiles = put(tfs)
        self.norm_dl_tiles = put(norm_dl_table[doc_ids])
        # exact (unquantized) posting-aligned doc lengths are only needed by the
        # QL/DFR family; materialized on first use
        self._exact_dl_tiles = None

        self.num_docs = index_data.num_docs
        self.num_terms = index_data.num_terms
        self.avgdl = float(index_data.avgdl)
        self.total_terms = float(index_data.total_term_count)
        self.term_offsets = index_data.term_offsets  # host-side for work-unit building
        self.df = index_data.df_array.astype(np.float64)
        self.cf = index_data.cf_array.astype(np.float64)
        # Lucene BM25 idf, in f64 on the host
        n = float(self.num_docs)
        with np.errstate(divide="ignore"):
            self.idf = np.log(1.0 + (n - self.df + 0.5) / (self.df + 0.5))

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=self.device)

        # the JAX formulas see these as weakly-typed f32 constants: Python-side
        # arithmetic (num_docs + 1.0) happens in f64 first, then rounds to f32
        self.stats = {
            "avgdl": f32(self.avgdl),
            "num_docs": f32(float(self.num_docs)),
            "num_docs_p1": f32(float(self.num_docs) + 1.0),
            "log2": torch.log(f32(2.0)),
            "f2exp_k": f32(0.35),
        }

    @property
    def exact_dl_tiles(self):
        if self._exact_dl_tiles is None:
            table = self._exact_dl_table[self._doc_ids_np]
            self._exact_dl_tiles = torch.from_numpy(table.reshape(self.n_tiles, TILE)).to(self.device)
        return self._exact_dl_tiles


class ScoringEngine:
    """Batched multi-model scoring with exact top-k over a DeviceIndex."""

    def __init__(self, device_index: DeviceIndex):
        self.dindex = device_index

    def _check_accumulator_bounds(self, num_queries: int):
        # the flat accumulator index qidx * (num_docs+1) + doc is kept within
        # int32 like the JAX engine's; fail loudly instead of growing silently
        if num_queries * (self.dindex.num_docs + 1) >= 2**31:
            raise ValueError(
                f"query batch of {num_queries} over {self.dindex.num_docs} docs overflows the "
                f"int32 flat accumulator (need num_queries*(num_docs+1) < 2^31); "
                f"use smaller batches"
            )

    # ------------------------------------------------------------------- exact path
    def _build_work_units(self, term_lists: Sequence[Sequence[Tuple[int, float]]], model: str):
        """Flatten a batch of queries into per-(query, tile) work units (vectorized).

        Returns numpy arrays (tile_idx, qidx, slot, w1, w2, lo, hi); ``slot`` is
        the position of the unit's term among its query's (non-empty) terms."""
        d = self.dindex
        tids = np.fromiter((t for terms in term_lists for t, _ in terms), dtype=np.int64)
        qw = np.fromiter((w for terms in term_lists for _, w in terms), dtype=np.float64)
        qix = np.fromiter(
            (q for q, terms in enumerate(term_lists) for _ in terms), dtype=np.int32, count=len(tids)
        )
        if len(tids):
            starts = d.term_offsets[tids]
            ends = d.term_offsets[tids + 1]
            nonempty = ends > starts
            tids, qw, qix, starts, ends = tids[nonempty], qw[nonempty], qix[nonempty], starts[nonempty], ends[nonempty]
        if len(tids) == 0:
            i32, f32 = np.zeros(0, np.int32), np.zeros(0, np.float32)
            return i32, i32, i32, f32, f32, i32, i32

        w1, w2 = self._term_weights(model, _W2_SOURCE[model], tids, qw)
        # slot: rank of each (query, term) pair within its query (query-major order)
        first_of_query = np.searchsorted(qix, qix, side="left")
        slot = (np.arange(len(qix)) - first_of_query).astype(np.int32)

        # expand each (query, term) into its covered tile range
        t0 = starts // TILE
        t1 = (ends - 1) // TILE
        counts = (t1 - t0 + 1).astype(np.int64)
        total = int(counts.sum())
        group_start = np.cumsum(counts) - counts
        within = np.arange(total, dtype=np.int64) - np.repeat(group_start, counts)
        tile = np.repeat(t0, counts) + within
        lo = np.maximum(0, np.repeat(starts, counts) - tile * TILE).astype(np.int32)
        hi = np.minimum(TILE, np.repeat(ends, counts) - tile * TILE).astype(np.int32)
        return (tile.astype(np.int32), np.repeat(qix, counts), np.repeat(slot, counts),
                np.repeat(w1, counts), np.repeat(w2, counts), lo, hi)

    def _term_weights(self, model, w2_source, tids, qw):
        d = self.dindex
        if model == "bm25":
            w1 = (qw * d.idf[tids]).astype(np.float32)
            w2 = np.zeros(len(tids), dtype=np.float32)
        else:
            w1 = qw.astype(np.float32)
            if w2_source == "ptc":
                w2 = (np.maximum(d.cf[tids], 1.0) / d.total_terms).astype(np.float32)
            elif w2_source == "df":
                w2 = np.maximum(d.df[tids], 1.0).astype(np.float32)
            elif w2_source == "cf":
                w2 = np.maximum(d.cf[tids], 1.0).astype(np.float32)
            else:
                w2 = np.zeros(len(tids), dtype=np.float32)
        return w1, w2

    def _score_exact(self, model, num_queries, topk, units, params):
        """Dense [G, Q, N+1] accumulator + stable sort: ([G, Q, topk] scores, ords)."""
        d = self.dindex
        dev = d.device
        slot_np = units[2]
        tile_idx, qidx, _, w1, w2, lo, hi = (torch.from_numpy(u).to(dev) for u in units)
        n_rows = d.num_docs + 1  # +1 sentinel slot for padding docids
        grid_size = next(iter(params.values())).shape[0] if params else 1

        docs = d.doc_tiles[tile_idx]  # [U, TILE]
        tfs = d.tf_tiles[tile_idx]
        dl = (d.norm_dl_tiles if model in _NORM_DL_MODELS else d.exact_dl_tiles)[tile_idx]
        pos = torch.arange(TILE, device=dev)
        mask = (pos >= lo[:, None]) & (pos < hi[:, None])
        # lanes outside [lo, hi) belong to neighbouring terms: park them on the sentinel row
        lin = qidx[:, None].long() * n_rows + torch.where(mask, docs, d.num_docs).long()
        s = SCORING_MODELS[model](tfs, dl, w1[:, None], w2[:, None], params, d.stats)
        s = torch.where(mask, s, 0.0).expand(grid_size, -1, -1)  # [G, U, TILE]

        acc = torch.zeros(grid_size, num_queries * n_rows, dtype=torch.float32, device=dev)
        num_slots = int(slot_np.max()) + 1 if len(slot_np) else 0
        for j in range(num_slots):
            sel = torch.from_numpy(np.flatnonzero(slot_np == j)).to(dev)
            acc.index_add_(1, lin[sel].reshape(-1), s[:, sel].reshape(grid_size, -1))
        scores = acc.view(grid_size, num_queries, n_rows)[:, :, : d.num_docs]
        values, ords = torch.sort(scores, dim=-1, descending=True, stable=True)
        return values[..., :topk], ords[..., :topk].to(torch.int32)

    # ------------------------------------------------------------------ public API
    def search(
        self,
        term_lists: Sequence[Sequence[Tuple[int, float]]],
        model: str = "bm25",
        params: Dict[str, float] = None,
        grid: Dict[str, Sequence[float]] = None,
        topk: int = 1000,
        exact_topk: bool = None,
        materialize: bool = True,
    ):
        """Score a batch of queries; returns (scores, doc_ords) numpy arrays.

        Without ``grid``: shapes [Q, topk]. With ``grid`` (param -> list of values):
        shapes [len(v1), ..., len(vk), Q, topk] with axes ordered by sorted param name.
        ``exact_topk`` None or True takes the exact path at every corpus size (the
        tiered path is not ported yet). With ``materialize=False`` the device
        tensors are returned and the caller copies them when it needs them.
        """
        if model not in SCORING_MODELS:
            raise ValueError(f"unknown scoring model {model!r}; known: {sorted(SCORING_MODELS)}")
        if exact_topk is False:
            raise NotImplementedError("the tiered scoring path is not ported yet; use exact_topk=None")
        params = dict(params or {})
        grid = dict(grid or {})
        num_queries = len(term_lists)
        topk = min(topk, self.dindex.num_docs)
        self._check_accumulator_bounds(num_queries)

        param_axes = tuple(sorted(grid))
        grid_shape = tuple(len(grid[k]) for k in param_axes)
        dev = self.dindex.device
        # every parameter becomes a [G, 1, 1] f32 tensor: G = product of the grid
        # axes (row-major over sorted names, like the JAX engine's nested vmaps)
        mesh = np.meshgrid(*[np.asarray(grid[k], dtype=np.float32) for k in param_axes], indexing="ij")
        grid_size = int(np.prod(grid_shape)) if param_axes else 1
        dev_params = {k: torch.full((grid_size, 1, 1), float(np.float32(v)), dtype=torch.float32, device=dev)
                      for k, v in params.items() if k not in grid}
        for k, values in zip(param_axes, mesh):
            dev_params[k] = torch.from_numpy(np.ascontiguousarray(values.reshape(-1, 1, 1))).to(dev)

        units = self._build_work_units(term_lists, model)
        scores, ords = self._score_exact(model, num_queries, topk, units, dev_params)
        out_shape = grid_shape + (num_queries, topk)
        scores, ords = scores.reshape(out_shape), ords.reshape(out_shape)
        if not materialize:
            return scores, ords
        return scores.cpu().numpy(), ords.cpu().numpy()
