"""Doc-sharded sparse search, any scoring model (the JAX package's
``parallel/sharded_search.py``).

The postings are partitioned by document range over the ``shard`` axis of a
``Mesh``: shard s holds docs [s * docs_per_shard, (s + 1) * docs_per_shard),
renumbered from 0, as posting-aligned tiles on its own device. A query batch
is scored on every shard with the single-device tiered engine's design: each
query's shard-local units padded to one width ``uw`` so candidate rows are
reshapes, a stable doc sort, duplicate-doc runs merged with masked doubling
shifts, then a stable sort by score (ties to the lower doc) to the local top
``local_k``. The shards' candidates are then concatenated shard-major on the
mesh's first device and merged by a stable descending sort
(``merge_shard_candidates``, which the dense and ColBERT searchers' sharded
engines share): within equal scores they are already in ascending global
ordinal, so the merge keeps the Lucene tie-break. JAX gathers the candidates with an ``all_gather`` inside
``shard_map``; here one process launches every shard's work before it copies
any result, so shards on several cards overlap.

The host side (``ShardedDeviceIndex``'s split, ``build_work_units``) is the
JAX package's numpy, line for line: the tiles, offsets and packed units are
equal to JAX's bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from capreolus_tpu_torch.searcher.scoring import SCORING_MODELS, TILE, _W2_SOURCE, _bucket
from capreolus_tpu_torch.searcher.streamed import topk_lower_ordinal_first
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on a card through pinned memory without a
    host sync, so that shards queue their uploads back to back."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class ShardedDeviceIndex:
    """Document-partitioned postings, one contiguous doc range per shard.

    Every shard is padded to the same tile count; pad postings carry the doc
    id ``docs_per_shard`` and tf 0. Shard s's tiles live on the s-th device
    of the mesh's ``axis``; the term offsets [S, V+1] stay on the host."""

    def __init__(self, index_data, mesh, axis: str = "shard"):
        self.mesh = mesh
        self.axis = axis
        num_shards = mesh.shape[axis]
        self.num_shards = num_shards
        self.devices = mesh.axis_devices(axis)
        self.num_docs = index_data.num_docs
        self.avgdl = float(index_data.avgdl)

        docs_per_shard = -(-self.num_docs // num_shards)
        self.docs_per_shard = docs_per_shard

        # doc-range split: postings are doc-sorted within impact class, not
        # globally, so partition by boolean masks per shard (one pass each)
        doc_ids = index_data.doc_ids
        tfs = index_data.tfs
        offsets = index_data.term_offsets
        num_terms = index_data.num_terms
        shard_of = doc_ids // docs_per_shard
        term_of = np.repeat(np.arange(num_terms, dtype=np.int64), np.diff(offsets))

        shard_docs, shard_tfs, shard_offsets = [], [], []
        for sh in range(num_shards):
            m = shard_of == sh
            shard_docs.append((doc_ids[m] - sh * docs_per_shard).astype(np.int32))
            shard_tfs.append(tfs[m].astype(np.float32))
            counts = np.bincount(term_of[m], minlength=num_terms)
            off = np.zeros(num_terms + 1, dtype=np.int64)
            np.cumsum(counts, out=off[1:])
            shard_offsets.append(off)

        max_nnz = max(len(d) for d in shard_docs)
        n_tiles = max(1, -(-max_nnz // TILE))
        padded = n_tiles * TILE

        doc_tiles = np.full((num_shards, padded), docs_per_shard, dtype=np.int32)
        tf_tiles = np.zeros((num_shards, padded), dtype=np.float32)
        # posting-aligned doc lengths (the single-device DeviceIndex's layout)
        norm_dl_tiles = np.ones((num_shards, padded), dtype=np.float32)
        exact_dl_tiles = np.ones((num_shards, padded), dtype=np.float32)
        for sh in range(num_shards):
            n = len(shard_docs[sh])
            doc_tiles[sh, :n] = shard_docs[sh]
            tf_tiles[sh, :n] = shard_tfs[sh]
            lo = sh * docs_per_shard
            hi = min(self.num_docs, (sh + 1) * docs_per_shard)
            ndl = np.append(index_data.norm_doclens[lo:hi].astype(np.float32),
                            np.ones(docs_per_shard - (hi - lo) + 1, np.float32))
            edl = np.append(index_data.doclens[lo:hi].astype(np.float32),
                            np.ones(docs_per_shard - (hi - lo) + 1, np.float32))
            norm_dl_tiles[sh, :n] = ndl[shard_docs[sh]]
            exact_dl_tiles[sh, :n] = edl[shard_docs[sh]]

        def place(arr):
            arr = arr.reshape(num_shards, n_tiles, TILE)
            return [_upload(arr[sh], dev) for sh, dev in enumerate(self.devices)]

        self.n_tiles = n_tiles
        self.doc_tiles = place(doc_tiles)
        self.tf_tiles = place(tf_tiles)
        self.norm_dl_tiles = place(norm_dl_tiles)
        self.exact_dl_tiles = place(exact_dl_tiles)
        self.term_offsets = np.stack(shard_offsets)  # [S, V+1], host-side

        n = float(self.num_docs)
        df = index_data.df_array.astype(np.float64)
        self.df = df
        self.cf = index_data.cf_array.astype(np.float64)
        self.total_terms = float(index_data.total_term_count)
        with np.errstate(divide="ignore"):
            self.idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        # the formulas' constants on each shard's device, as DeviceIndex.stats
        # holds them (f32; Python-side arithmetic first, as JAX's weak types)
        self.stats = [{
            "avgdl": torch.full((), self.avgdl, dtype=torch.float32, device=dev),
            "num_docs": torch.full((), n, dtype=torch.float32, device=dev),
            "num_docs_p1": torch.full((), n + 1.0, dtype=torch.float32, device=dev),
            "log2": torch.log(torch.full((), 2.0, dtype=torch.float32, device=dev)),
            "f2exp_k": torch.full((), 0.35, dtype=torch.float32, device=dev),
        } for dev in self.devices]

    # ------------------------------------------------------------------ host work units
    def build_work_units(self, term_lists: Sequence[Sequence[Tuple[int, float]]], model: str = "bm25"):
        """Vectorized per-shard unit building in the uniform row layout.

        Every query gets ``uw`` unit slots per shard (uw = max units over all
        (shard, query) pairs, bucketed), so per-query candidate rows on device
        are pure reshapes. Returns ([S, 5, nq*uw] packed int32, uw, r_max)."""
        w2_source = _W2_SOURCE[model]
        nq = len(term_lists)
        r_max = _bucket(max((len(t) for t in term_lists), default=1), minimum=4)

        tids = np.fromiter((t for terms in term_lists for t, _ in terms), dtype=np.int64)
        qw = np.fromiter((w for terms in term_lists for _, w in terms), dtype=np.float64)
        qix = np.fromiter((q for q, terms in enumerate(term_lists) for _ in terms),
                          dtype=np.int32, count=len(tids))
        if model == "bm25":
            w1_all = (qw * self.idf[tids]).astype(np.float32)
            w2_all = np.zeros(len(tids), dtype=np.float32)
        else:
            w1_all = qw.astype(np.float32)
            if w2_source == "ptc":
                w2_all = (np.maximum(self.cf[tids], 1.0) / self.total_terms).astype(np.float32)
            elif w2_source == "df":
                w2_all = np.maximum(self.df[tids], 1.0).astype(np.float32)
            elif w2_source == "cf":
                w2_all = np.maximum(self.cf[tids], 1.0).astype(np.float32)
            else:
                w2_all = np.zeros(len(tids), dtype=np.float32)

        per_shard = []
        uw = 1
        for sh in range(self.num_shards):
            offsets = self.term_offsets[sh]
            starts = offsets[tids]
            ends = offsets[tids + 1]
            keep = ends > starts
            s_qix, s_w1, s_w2 = qix[keep], w1_all[keep], w2_all[keep]
            s_starts, s_ends = starts[keep], ends[keep]
            t0 = s_starts // TILE
            t1 = (s_ends - 1) // TILE if len(s_ends) else t0
            counts = (t1 - t0 + 1).astype(np.int64)
            total = int(counts.sum())
            group_start = np.cumsum(counts) - counts
            within = np.arange(total, dtype=np.int64) - np.repeat(group_start, counts)
            tile = (np.repeat(t0, counts) + within).astype(np.int64)
            rs, re = np.repeat(s_starts, counts), np.repeat(s_ends, counts)
            lo = np.maximum(0, rs - tile * TILE).astype(np.int32)
            hi = np.minimum(TILE, re - tile * TILE).astype(np.int32)
            uq = np.repeat(s_qix, counts)
            units_per_q = np.bincount(uq, minlength=nq)
            uw = max(uw, int(units_per_q.max()) if nq else 1)
            slot_in_q = np.arange(total, dtype=np.int64) - np.searchsorted(uq, uq)
            per_shard.append((tile, uq, np.repeat(s_w1, counts), np.repeat(s_w2, counts),
                              lo, hi, slot_in_q))

        uw = _bucket(uw, minimum=4)
        packed = np.zeros((self.num_shards, 5, nq * uw), dtype=np.int32)
        for sh, (tile, uq, w1, w2, lo, hi, slot_in_q) in enumerate(per_shard):
            dest = uq.astype(np.int64) * uw + slot_in_q
            packed[sh, 0, dest] = tile
            packed[sh, 1, dest] = w1.view(np.int32)
            packed[sh, 2, dest] = w2.view(np.int32)
            packed[sh, 3, dest] = lo
            packed[sh, 4, dest] = hi  # pad units keep hi = 0 -> fully masked
        return packed, uw, r_max


def _shard_topk(sindex, sh, units, num_queries, uw, r_max, local_k, model, params):
    """One shard's local top ``local_k``: ([Q, local_k] scores, global
    ordinals, ``num_docs`` where the score is not positive), on its device."""
    dev = sindex.devices[sh]
    dps = sindex.docs_per_shard
    width = uw * TILE
    dl_tiles = (sindex.norm_dl_tiles if model == "bm25" else sindex.exact_dl_tiles)[sh]
    tile_idx = units[0].long()
    w1 = units[1].view(torch.float32)
    w2 = units[2].view(torch.float32)
    lo, hi = units[3], units[4]

    docs = sindex.doc_tiles[sh][tile_idx]  # [U, TILE]
    tfs = sindex.tf_tiles[sh][tile_idx]
    dl = dl_tiles[tile_idx]
    pos = torch.arange(TILE, dtype=torch.int32, device=dev)
    mask = (pos >= lo[:, None]) & (pos < hi[:, None])
    s = SCORING_MODELS[model](tfs, dl, w1[:, None], w2[:, None], params, sindex.stats[sh])
    s = torch.where(mask, s, -1.0)
    docs = torch.where(mask, docs, dps)

    # accumulator-free dedup: a stable doc sort, then masked doubling shifts
    # put each duplicate run's sum on its first element
    docv, perm = torch.sort(docs.reshape(num_queries, width), dim=1, stable=True)
    merged = torch.gather(s.reshape(num_queries, width), 1, perm)
    shift = 1
    while shift < r_max:
        add = torch.zeros_like(merged)
        add[:, : width - shift] = torch.where(docv[:, shift:] == docv[:, :-shift], merged[:, shift:], 0.0)
        merged = merged + add
        shift *= 2
    first = torch.ones_like(docv, dtype=torch.bool)
    first[:, 1:] = docv[:, 1:] != docv[:, :-1]
    merged = torch.where(first & (merged > 0), merged, -1.0)
    # (score desc, doc asc): the rows are in ascending doc order and the sort is stable
    top, idx = torch.sort(merged, dim=1, descending=True, stable=True)
    local_scores = top[:, :local_k]
    local_ords = torch.gather(docv, 1, idx[:, :local_k])
    global_ords = torch.where(local_scores > 0, local_ords + sh * dps, sindex.num_docs)
    return local_scores, global_ords


def sharded_search(sindex: ShardedDeviceIndex, work_units, num_queries: int, topk: int,
                   model: str = "bm25", params: dict = None, materialize: bool = True):
    """Score a batch on every shard (local sort-based top-k), then merge the
    candidates on the mesh's first device. Returns (scores [Q, k], global doc
    ordinals) with k = min(topk, S * local_k): numpy when ``materialize``
    (blocking), tensors on the first device otherwise, so that a pipelining
    caller (``search_async``) can dispatch the next batch first."""
    packed, uw, r_max = work_units
    local_k = min(topk, sindex.docs_per_shard, uw * TILE)
    # every shard's inputs are queued before any shard's scoring
    units = [_upload(packed[sh], dev) for sh, dev in enumerate(sindex.devices)]
    dev_params = [{k: torch.full((), float(np.float32(v)), dtype=torch.float32, device=dev)
                   for k, v in dict(params or {}).items()} for dev in sindex.devices]
    parts = [_shard_topk(sindex, sh, units[sh], num_queries, uw, r_max, local_k, model, dev_params[sh])
             for sh in range(sindex.num_shards)]

    m_scores, m_ords = merge_shard_candidates(parts, topk, sindex.devices[0])
    if not materialize:
        return m_scores, m_ords
    return m_scores.cpu().numpy(), m_ords.cpu().numpy()


def merge_shard_candidates(cands, hits, first):
    """The top ``hits`` of the shards' candidates, merged on device ``first``:
    ``cands`` holds each shard's ([Q, k_s] scores, [Q, k_s] global
    ordinals), ties to the lower ordinal within the shard. Concatenated
    shard-major, equal scores sit in ascending global ordinal, so a stable
    descending sort keeps the (score desc, ordinal asc) tie-break. Returns
    ([Q, min(hits, sum k_s)] scores, ordinals) on ``first``."""
    s_all = torch.cat([s.to(first) for s, _ in cands], dim=1)
    o_all = torch.cat([o.to(first) for _, o in cands], dim=1)
    ms, idx = topk_lower_ordinal_first(s_all, hits)
    return ms, torch.gather(o_all, 1, idx)


def cached_shards(owner, gen, devices, build):
    """``owner``'s shard tensors for index generation ``gen`` on ``devices``,
    rebuilt by ``build()`` when either has changed since the last call (kept
    in ``owner._shard_corpus``); the old shards are dropped before the new
    ones are uploaded."""
    key = (gen, tuple(str(dev) for dev in devices))
    cached = getattr(owner, "_shard_corpus", None)
    if cached is None or cached[0] != key:
        owner._shard_corpus = None
        owner._shard_corpus = (key, build())
    return owner._shard_corpus[1]


def sharded_bm25_topk(sindex: ShardedDeviceIndex, work_units, num_queries: int, topk: int,
                      k1: float = 0.9, b: float = 0.4):
    """BM25 convenience wrapper over sharded_search."""
    return sharded_search(sindex, work_units, num_queries, topk, model="bm25", params={"k1": k1, "b": b})
