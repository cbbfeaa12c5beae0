"""Batched scoring engine over the inverted index (the JAX package's
``searcher/scoring.py``).

The CSR postings arrays (doc ids + term freqs) are reshaped into fixed-size tiles
``[n_tiles, TILE]`` and placed on the device once (or, above ``hbm_budget``,
kept on the host and streamed per batch). A query batch is flattened on the host
into work units, one (query, tile) pair each, carrying the per-term weights and
the valid [lo, hi) range inside the tile. Two device paths:

exact (corpora of at most ``EXACT_MAX_DOCS`` docs, parity tests):

    gather tiles -> elementwise scoring model -> scatter-add into a dense
    [Q, N+1] accumulator -> stable sort by score -> slice k

tiered (larger corpora, pruning, caps, streaming): queries are host-sorted by
candidate volume into row tiers; every query's units are padded to its tier's
fixed width, so per-query candidate rows are pure reshapes:

    gather tiles -> elementwise scoring model -> per tier: stable sort by doc,
    merge duplicate-doc runs with log2(r_max) masked shift-adds, stable sort
    by score (desc), slice k -> gather the real query rows -> pack ordinals

All scoring models (BM25, QL-Dirichlet, QL-JM, DFR INL2, SPL, F2Exp, F2Log, and
impact) share both paths and differ only in the elementwise formula; a
parameter grid is a written-out leading batch axis that shares the gathers
(and, on the tiered path, the doc sort).

Parity with the JAX engine:

- each formula keeps the JAX op order, in f32, with idf computed in f64 on the
  host and cast. XLA's CPU backend contracts a multiply and an add into one FMA
  and folds a division by a compile-time constant (avgdl) into a multiplication
  by its reciprocal, so single scores may differ in the last bits; equal
  inputs still give equal scores, so exact ties stay ties on both sides;
- payload tiles are int32 doc ids and, where exact, bf16 tf / doc lengths as
  the JAX engine stores them (the bf16 conversion is torch's, round to nearest
  even like XLA's); they decode to the same f32 values before the formula;
- the exact path fills its accumulator one query-term slot at a time, so each
  document's sum is taken in query-term order; the tiered path's doc sort is
  stable, so a duplicate run keeps unit order (query-major, term order) and
  the shift-add tree sums it the same way whether spans were pruned or not:
  pruned, streamed and exhaustive tiered results are bit-identical. Tiered and
  exact scores are a tree sum against a sequential sum (within 1e-5 relative);
- ties are broken by ascending internal doc ordinal (Lucene's docid
  tie-break): a stable descending sort of rows already in ascending doc order
  (``torch.topk`` promises no tie order on CUDA);
- packed ordinal words are JAX's bits, held in int32 tensors (CUDA has few
  uint32 kernels) and read on the host as uint32;
- ``score_dtype="bfloat16"`` transfers bf16 scores and widens them to f32 on
  the host: the values equal JAX's bf16 results, the numpy dtype is float32
  (the card's machine has no ``ml_dtypes``).

Block-max pruning builds its spans with the native C++ span builder
(``native/pruner.cpp``, through ``ctypes``; its spans equal the JAX
package's native spans) and falls back to the numpy path (``compute_theta``
and ``_spans_pruned``) when the library does not load. The two paths sample
other threshold candidates, so their spans differ; both keep results exact.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from capreolus_tpu_torch.native import get_pruner_lib
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

TILE = 512
# corpora up to this many docs take the exact dense path by default (the JAX
# engine's rule): a dense [Q, N] sort is cheap there
EXACT_MAX_DOCS = 65536
# elements [g, U, TILE] of the tiered path's per-lane scores held at once: a
# parameter grid is scored in chunks of grid points under this bound
TIER_GRID_LANES = 1 << 26


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


def unpack_doc_ords(packed: np.ndarray) -> np.ndarray:
    """Inverse of a 3-byte ordinal packing ([..., 3] uint8 -> int32)."""
    packed = packed.astype(np.int32)
    return packed[..., 0] | (packed[..., 1] << 8) | (packed[..., 2] << 16)


def ord_pack_bits(num_docs: int) -> int:
    """Bit width for device-side ordinal packing: the narrowest width that
    represents every doc ordinal PLUS the pad sentinel ``num_docs`` (18 bits
    at 200k docs), capped at 24."""
    bits = max(int(num_docs).bit_length(), 1)  # represents values 0..num_docs
    return min(bits, 24)


def _ord_pack_geometry(bits: int) -> Tuple[int, int]:
    """(group_size, words_per_group): the smallest group of b-bit values whose
    packed bitstream is whole uint32 words. Groups concatenate into one
    continuous little-endian b-bit stream (group g, local i = global g*G + i
    at stream bit b*(g*G + i)), so the host unpack below is geometry-free."""
    g = 32 // math.gcd(bits, 32)
    return g, bits * g // 32


def unpack_doc_ords_bits(packed: np.ndarray, k: int, bits: int) -> np.ndarray:
    """Inverse of the device-side b-bit ordinal packing
    ([..., n_groups, words_per_group] uint32 -> [..., k] int32)."""
    lead = packed.shape[:-2]
    w = packed.reshape(*lead, -1).astype(np.uint64)
    w = np.concatenate([w, np.zeros((*lead, 1), np.uint64)], axis=-1)
    u = w[..., :-1] | (w[..., 1:] << np.uint64(32))  # 64-bit windows at each word
    start = np.arange(k, dtype=np.int64) * bits
    vals = (u[..., start // 32] >> (start % 32).astype(np.uint64)) & np.uint64((1 << bits) - 1)
    return vals.astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(n: int, minimum: int = 64) -> int:
    """Round n up to the next power of two (bounded below): the JAX engine's
    shape buckets, kept so both packages pad batches the same way."""
    size = minimum
    while size < n:
        size *= 2
    return size


# ------------------------------------------------------------------ payloads
# A posting payload array on the host is float32, or uint16 holding bf16 bit
# patterns where every value is exactly representable in bf16 (the JAX engine's
# compact payloads, 2 bytes instead of 4; numpy has no bfloat16 of its own).


def _bf16_bits(arr_f32) -> np.ndarray:
    """Host-side bf16 conversion (torch's, round to nearest even like XLA's
    convert) as uint16 bit patterns; never routes the array through a device."""
    t = torch.from_numpy(np.ascontiguousarray(arr_f32, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def _bf16_payload_ok(arr_f32: np.ndarray) -> bool:
    """True when the array is exactly representable in bf16: integer values
    <= 256 always are (8 mantissa bits), otherwise verify the round trip."""
    if arr_f32.size == 0:
        return True
    return bool(arr_f32.max() <= 256) or bool((arr_f32 == _bf16_bits_to_f32(_bf16_bits(arr_f32))).all())


def _payload_full(shape, value: float, dtype) -> np.ndarray:
    """A payload array of ``dtype`` (float32, or uint16 bf16 bits) filled with ``value``."""
    if np.dtype(dtype) == np.uint16:
        return np.full(shape, _bf16_bits(np.float32([value]))[0], np.uint16)
    return np.full(shape, value, dtype)


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host array (copied only when it is read-only, as a
    memory-mapped index is); uint16 payloads become bfloat16 tensors."""
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _upload(arr, device: torch.device) -> torch.Tensor:
    """Host array -> ``device``. To a card the copy goes from pinned memory and
    does not block the host: a copy from pageable memory would wait for the
    device's queue and serialize the pipelined batches."""
    t = _host_tensor(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _host_scores(t: torch.Tensor) -> np.ndarray:
    """A host score tensor as numpy; bf16 scores (which numpy cannot hold)
    widen to f32, which keeps their values."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


# ------------------------------------------------------------------ disk tile cache
# When the index is disk-resident (index.mmap), the tile-layout payloads the
# engine consumes are ALSO kept on disk, built slab-wise from the memory-mapped
# canonical postings (peak host RAM = one slab) and memory-mapped back. The
# format is the JAX engine's (bf16 payloads as raw uint16).

TILES_CACHE_VERSION = 1
_TILE_SLAB = 1 << 22  # postings per build slab (~16 MB of int32)


def _load_or_build_tile_cache(index_data, tile_dir, n_tiles: int):
    """Return memory-mapped (doc_tiles, tf_tiles, norm_dl_tiles), each
    [n_tiles, TILE], building the on-disk cache on first use."""
    from capreolus_tpu_torch.utils.caching import done_file

    tile_dir = Path(tile_dir)

    def _try_load():
        meta_path = tile_dir / "meta.npz"
        if not meta_path.exists():
            return None
        with np.load(meta_path) as meta:
            if int(meta["version"]) != TILES_CACHE_VERSION or int(meta["n_tiles"]) != n_tiles \
                    or int(meta["tile"]) != TILE:
                return None
        doc = np.load(tile_dir / "doc_ids.npy", mmap_mode="r")
        tf = np.load(tile_dir / "tf.npy", mmap_mode="r")
        ndl = np.load(tile_dir / "norm_dl.npy", mmap_mode="r")
        return doc.reshape(n_tiles, TILE), tf.reshape(n_tiles, TILE), ndl.reshape(n_tiles, TILE)

    if (tile_dir / "done").exists():
        out = _try_load()
        if out is not None:
            return out
        import shutil

        logger.warning("stale tile cache at %s; rebuilding", tile_dir)
        shutil.rmtree(tile_dir, ignore_errors=True)

    with done_file(tile_dir) as already:
        if not already:
            _build_tile_cache(index_data, tile_dir, n_tiles)
    out = _try_load()
    if out is None:
        raise RuntimeError(f"tile cache build at {tile_dir} produced no loadable cache")
    return out


def _build_tile_cache(index_data, tile_dir, n_tiles: int):
    from numpy.lib.format import open_memmap

    nnz = len(index_data.doc_ids)
    padded = n_tiles * TILE
    num_docs = index_data.num_docs
    norm_dl_table = np.append(index_data.norm_doclens.astype(np.float32), 1.0)

    tf_bf16 = True
    for s0 in range(0, nnz, _TILE_SLAB):
        if not _bf16_payload_ok(np.asarray(index_data.tfs[s0 : s0 + _TILE_SLAB]).astype(np.float32)):
            tf_bf16 = False
            break
    # norm doclens are SmallFloat-quantized (<= 4 significant bits) so the
    # table check suffices: every tile value is a table entry
    ndl_bf16 = _bf16_payload_ok(norm_dl_table)

    def _as_payload(arr_f32, bf16):
        return _bf16_bits(arr_f32) if bf16 else arr_f32

    doc_mm = open_memmap(tile_dir / "doc_ids.npy", mode="w+", dtype=np.int32, shape=(padded,))
    tf_mm = open_memmap(tile_dir / "tf.npy", mode="w+", dtype=np.uint16 if tf_bf16 else np.float32,
                        shape=(padded,))
    ndl_mm = open_memmap(tile_dir / "norm_dl.npy", mode="w+", dtype=np.uint16 if ndl_bf16 else np.float32,
                         shape=(padded,))
    for s0 in range(0, nnz, _TILE_SLAB):
        e = min(s0 + _TILE_SLAB, nnz)
        d = np.asarray(index_data.doc_ids[s0:e])
        doc_mm[s0:e] = d
        tf_mm[s0:e] = _as_payload(np.asarray(index_data.tfs[s0:e]).astype(np.float32), tf_bf16)
        ndl_mm[s0:e] = _as_payload(norm_dl_table[d], ndl_bf16)
    # padding matches the in-RAM builder: pad doc ordinal = num_docs (whose
    # norm_dl table entry is 1.0), pad tf = 0
    doc_mm[nnz:] = num_docs
    tf_mm[nnz:] = _as_payload(np.zeros(padded - nnz, np.float32), tf_bf16)
    ndl_mm[nnz:] = _as_payload(np.full(padded - nnz, norm_dl_table[num_docs], np.float32), ndl_bf16)
    for mm in (doc_mm, tf_mm, ndl_mm):
        mm.flush()
    del doc_mm, tf_mm, ndl_mm
    np.savez(tile_dir / "meta.npz", version=np.int64(TILES_CACHE_VERSION),
             n_tiles=np.int64(n_tiles), tile=np.int64(TILE),
             tf_dtype="bf16" if tf_bf16 else "f32", ndl_dtype="bf16" if ndl_bf16 else "f32")
    logger.info("built disk tile cache at %s (%d tiles, tf=%s, norm_dl=%s)", tile_dir, n_tiles,
                "bf16" if tf_bf16 else "f32", "bf16" if ndl_bf16 else "f32")


class DeviceIndex:
    """Tiled postings + statistics tables: resident on ``device`` by default,
    or host-streaming for corpora whose tiles exceed ``hbm_budget`` bytes.

    Tiles are int32 doc ids and (where exact) bf16 payloads, 8 bytes per
    posting for BM25 as in the JAX engine, so one budget switches both
    packages to streaming at the same corpus size. Pad postings carry doc id
    ``num_docs`` (a sentinel that is dropped) and tf 0. In streaming mode the
    tile arrays stay in host RAM (or on disk, memory-mapped) and each query
    batch uploads only its working set: the union of tiles its work units
    touch, pruning and caps applied first."""

    def __init__(self, index_data, device, hbm_budget=None):
        self.host = index_data
        self.device = torch.device(device)
        nnz = len(index_data.doc_ids)
        n_tiles = max(1, (nnz + TILE - 1) // TILE)
        padded = n_tiles * TILE
        self.n_tiles = n_tiles
        norm_dl_table = np.append(index_data.norm_doclens.astype(np.float32), 1.0)
        exact_dl_table = np.append(index_data.doclens.astype(np.float32), 1.0)
        self._tile_dir = getattr(index_data, "tile_dir", None)

        if self._tile_dir is not None:
            # disk-resident index (index.mmap): the tile payloads live on disk
            # too, built slab-wise and memory-mapped
            doc_tiles_np, tf_np, norm_dl_np = _load_or_build_tile_cache(index_data, self._tile_dir, n_tiles)
        else:
            doc_ids = np.full(padded, index_data.num_docs, dtype=np.int32)
            doc_ids[:nnz] = index_data.doc_ids
            tfs = np.zeros(padded, dtype=np.float32)
            tfs[:nnz] = index_data.tfs

            def compact_np(arr):
                return _bf16_bits(arr) if _bf16_payload_ok(arr) else arr.astype(np.float32)

            doc_tiles_np = doc_ids.reshape(n_tiles, TILE)
            tf_np = compact_np(tfs.reshape(n_tiles, TILE))
            norm_dl_np = compact_np(norm_dl_table[doc_ids].reshape(n_tiles, TILE))
        self.tile_bytes = doc_tiles_np.nbytes + tf_np.nbytes + norm_dl_np.nbytes
        self._exact_dl_tiles = None
        self._exact_dl_tiles_np = None
        self._exact_dl_src = (exact_dl_table, doc_tiles_np)
        self.streaming = hbm_budget is not None and self.tile_bytes > hbm_budget
        if self.streaming:
            logger.info("postings tiles (%.1f MB) exceed the device budget (%.1f MB): "
                        "host-streaming mode (per-batch working-set uploads)",
                        self.tile_bytes / 1e6, hbm_budget / 1e6)
            self.doc_tiles_np = doc_tiles_np
            self.tf_tiles_np = tf_np
            self.norm_dl_tiles_np = norm_dl_np
            self.doc_tiles = self.tf_tiles = self.norm_dl_tiles = None
        else:
            self.doc_tiles = _host_tensor(doc_tiles_np).to(self.device)
            self.tf_tiles = _host_tensor(tf_np).to(self.device)
            self.norm_dl_tiles = _host_tensor(norm_dl_np).to(self.device)

        self.num_docs = index_data.num_docs
        self.num_terms = index_data.num_terms
        self.avgdl = float(index_data.avgdl)
        self.total_terms = float(index_data.total_term_count)
        self.term_offsets = index_data.term_offsets  # host-side for work-unit building
        # host postings stay reachable for capped-span / pruning span building
        self.host_tfs = index_data.tfs
        # block-max side tables (index/tpu.py build_prune_tables); None -> no pruning
        self.prune = getattr(index_data, "prune_tables", None)
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

    def _gather_exact_dl_np(self):
        """Posting-aligned exact doc lengths (f32), disk-cached and memory-mapped
        when the index is disk-resident."""
        exact_dl_table, doc_tile_ids = self._exact_dl_src
        if self._tile_dir is None:
            return exact_dl_table[np.asarray(doc_tile_ids)].astype(np.float32)
        from numpy.lib.format import open_memmap

        path = Path(self._tile_dir) / "exact_dl.npy"
        if not path.exists():
            tmp = path.with_name(path.name + f".tmp{os.getpid()}_{threading.get_ident()}")
            mm = open_memmap(tmp, mode="w+", dtype=np.float32, shape=doc_tile_ids.shape)
            rows = max(1, _TILE_SLAB // TILE)
            for r0 in range(0, doc_tile_ids.shape[0], rows):
                mm[r0 : r0 + rows] = exact_dl_table[np.asarray(doc_tile_ids[r0 : r0 + rows])]
            mm.flush()
            del mm
            os.replace(tmp, path)
        return np.load(path, mmap_mode="r")

    @property
    def exact_dl_tiles(self):
        """Exact (unquantized) posting-aligned doc lengths on the device: only
        the QL/DFR family reads them, so they are materialized on first use."""
        if self._exact_dl_tiles is None:
            self._exact_dl_tiles = _host_tensor(self._gather_exact_dl_np()).to(self.device)
        return self._exact_dl_tiles

    @property
    def exact_dl_tiles_np(self):
        if self._exact_dl_tiles_np is None:
            self._exact_dl_tiles_np = self._gather_exact_dl_np()
        return self._exact_dl_tiles_np


class TieredResult:
    """Pending results of a tiered search. The device-to-host copies start at
    dispatch (into pinned host memory, with a CUDA event recorded behind them),
    so transfers overlap later batches' compute; ``get`` waits on that event,
    unpacks the ordinal bits and trims the Q padding. Rows arrive compacted and
    in the caller's query order (the device gathers them through out_index)."""

    def __init__(self, scores, ords, num_queries, topk, grid_shape, ord_bits):
        self.scores = scores  # [*grid, Q_pad, topk] device tensor (f32 or bf16)
        self.ords = ords  # [*grid, Q_pad, topk] int32, or bit-packed words held in int32
        self.num_queries = num_queries
        self.topk = topk
        self.grid_shape = tuple(grid_shape)
        self.ord_bits = ord_bits  # 0 = raw int32 ordinals
        self._event = None
        if scores.is_cuda:
            host = []
            for t in (scores, ords):
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
            self._event = torch.cuda.Event()
            self._event.record()
            self._host = tuple(host)
        else:
            self._host = (scores, ords)

    def get(self):
        """([*grid, Q, topk] f32 scores, [...] int32 doc ords) numpy arrays."""
        if self._event is not None:
            self._event.synchronize()  # a pinned buffer read before its copy lands holds garbage
        scores, ords = self._host
        scores = _host_scores(scores)
        ords = ords.numpy()
        if self.ord_bits:
            ords = unpack_doc_ords_bits(ords.view(np.uint32), self.topk, self.ord_bits)
        return scores[..., : self.num_queries, :], ords[..., : self.num_queries, :]


class _ReadyResult:
    """An already-fetched result with the TieredResult interface, so
    search_stream's probes can hold materialized segments and still yield
    objects whose ``.get()`` callers expect."""

    def __init__(self, arrays):
        self._arrays = arrays

    def get(self):
        return self._arrays


def _pack_bits(v: torch.Tensor, bits: int, topk: int, pad: int) -> torch.Tensor:
    """Ordinals at ``bits`` bits: groups of G values pack into whole 32-bit
    words (one continuous little-endian b-bit stream; unpack_doc_ords_bits is
    the inverse). [..., topk] int32 -> [..., kp // G, words_per_group] int32
    holding the uint32 words' bit patterns. Shifts run in int64."""
    g, wpg = _ord_pack_geometry(bits)
    kp = _round_up(topk, g)
    v = v.long()
    if kp > topk:
        v = torch.cat([v, torch.full((*v.shape[:-1], kp - topk), pad, dtype=torch.int64, device=v.device)], -1)
    v = v.reshape(*v.shape[:-1], kp // g, g)
    words = []
    for j in range(wpg):
        w = torch.zeros(v.shape[:-1], dtype=torch.int64, device=v.device)
        lo_bit = 32 * j  # word j covers stream bits [32j, 32j+32)
        for i in range(g):
            v0 = bits * i  # value i covers [b*i, b*i + b)
            if v0 + bits <= lo_bit or v0 >= lo_bit + 32:
                continue
            w = w | (v[..., i] >> (lo_bit - v0) if lo_bit >= v0 else v[..., i] << (v0 - lo_bit))
        words.append(w & 0xFFFFFFFF)
    w = torch.stack(words, dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


class ScoringEngine:
    """Batched multi-model scoring with exact top-k over a DeviceIndex: the
    exact dense path for small corpora, the tiered path for the rest (see the
    module docstring). Both produce identical rankings, ties included."""

    # tier row sizes start here and grow 4x per tier
    TIER_BASE_LANES = 2048

    def __init__(self, device_index: DeviceIndex):
        self.dindex = device_index
        self._cap_cache = {}  # (term_id, cap) -> kept-span arrays for maxpostings
        self._theta_cache = {}  # (term_id, (k1, b)) -> span-head (docs, contributions)
        self._prune_effective = {}  # (topk, k1, b) -> sticky does-SYNCHRONOUS-pruning-pay (wall-clock A/B)
        self._prune_tiles_ok = {}  # (topk, k1, b) -> sticky do-spans-drop-tiles (shared sync + stream)
        self._prune_stream_effective = {}  # (topk, k1, b) -> sticky does-PIPELINED-pruning-pay
        self._prune_verdicts = None  # lazy on-disk verdict store
        self._dirty_verdicts = set()  # verdict keys this engine changed since its last flush
        self._verdict_lock = threading.Lock()  # the store is shared by every thread that searches
        self._prune_warm = set()  # (key, mode) pairs whose first run is behind them
        self._sync_serves = {}  # per-key search_pruned calls under a settled verdict
        self._span_executor = None  # lazy worker pool for search_stream host prep
        self._upload_stream = None  # side stream of streaming mode's working-set uploads
        self.last_stream_probe = None  # (t_pruned, t_exhaustive) of the last stream A/B
        self.last_prune_stats = None
        self.last_stream_stats = None
        self._native_prune_arrays = None  # the native span builder's index arrays, taken on its first call

    def _check_accumulator_bounds(self, num_queries: int):
        # the flat accumulator index qidx * (num_docs+1) + doc is kept within
        # int32 like the JAX engine's; fail loudly instead of growing silently
        if num_queries * (self.dindex.num_docs + 1) >= 2**31:
            raise ValueError(
                f"query batch of {num_queries} over {self.dindex.num_docs} docs overflows the "
                f"int32 flat accumulator (need num_queries*(num_docs+1) < 2^31); "
                f"use smaller batches or the tiered path (exact_topk=False)"
            )

    def exact_path(self, exact_topk=None, max_postings_per_term: int = 0) -> bool:
        """Whether ``search`` takes the exact dense path: never in streaming
        mode or under a maxpostings cap (only the tiered path expresses either);
        by default for corpora of at most EXACT_MAX_DOCS docs."""
        if self.dindex.streaming or int(max_postings_per_term or 0) > 0:
            return False
        if exact_topk is None:
            return self.dindex.num_docs <= EXACT_MAX_DOCS
        return bool(exact_topk)

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

    def explain(self, term_list, doc_ord: int, model: str = "bm25", params=None):
        """Lucene ``Explanation`` analog: the per-term score breakdown of ONE
        document for a query (host-side, reading the canonical postings).

        Returns ``{"total": float, "model": str, "terms": [{"term_id", "weight"
        (qtf / query weight), "tf", "dl", "contribution"}, ...]}``; each
        contribution is the engine's f32 formula on the device. Terms absent
        from the document contribute 0, like the engine's masked lanes."""
        if model not in SCORING_MODELS:
            raise ValueError(f"unknown scoring model {model!r}")
        params = dict(params or ({"k1": 0.9, "b": 0.4} if model == "bm25" else {}))
        d = self.dindex
        w2src = _W2_SOURCE[model]
        host = d.host
        dl_table = host.norm_doclens if model in _NORM_DL_MODELS else host.doclens
        dl = float(dl_table[int(doc_ord)])

        def f32(x):
            return torch.tensor(float(np.float32(x)), dtype=torch.float32, device=d.device)

        rows = []
        total = 0.0
        for tid, qw in term_list:
            tid = int(tid)
            tf = 0.0
            if 0 <= tid < d.num_terms:
                docs_t, tfs_t = host.postings(tid)
                hit = np.nonzero(np.asarray(docs_t) == int(doc_ord))[0]
                if len(hit):
                    tf = float(np.asarray(tfs_t)[hit[0]])
            contribution = 0.0
            if tf > 0:
                w1, w2 = self._term_weights(model, w2src, np.array([tid]), np.array([float(qw)]))
                contribution = float(SCORING_MODELS[model](
                    f32(tf), f32(dl), f32(w1[0]), f32(w2[0]), {k: f32(v) for k, v in params.items()},
                    d.stats).item())
            rows.append({"term_id": tid, "weight": float(qw), "tf": tf, "dl": dl, "contribution": contribution})
            total += contribution
        return {"total": total, "model": model, "terms": rows}

    def _device_params(self, params, points):
        """Every parameter as a [G, 1, 1] f32 tensor on the device (G grid points,
        1 without ``points``)."""
        dev = self.dindex.device
        grid_size = len(next(iter(points.values()))) if points else 1
        out = {k: torch.full((grid_size, 1, 1), float(np.float32(v)), dtype=torch.float32, device=dev)
               for k, v in params.items() if k not in points}
        for k, values in points.items():
            out[k] = _upload(np.asarray(values, dtype=np.float32).reshape(-1, 1, 1), dev)
        return out, grid_size

    def _score_exact(self, model, num_queries, topk, units, params):
        """Dense [G, Q, N+1] accumulator + stable sort: ([G, Q, topk] scores, ords)."""
        d = self.dindex
        dev = d.device
        slot_np = units[2]
        tile_idx, qidx, _, w1, w2, lo, hi = (_upload(u, dev) for u in units)
        tile_idx = tile_idx.long()
        n_rows = d.num_docs + 1  # +1 sentinel slot for padding docids
        grid_size = next(iter(params.values())).shape[0] if params else 1

        docs = d.doc_tiles[tile_idx]  # [U, TILE]
        tfs = _f32(d.tf_tiles[tile_idx])
        dl = _f32((d.norm_dl_tiles if model in _NORM_DL_MODELS else d.exact_dl_tiles)[tile_idx])
        pos = torch.arange(TILE, device=dev)
        mask = (pos >= lo[:, None]) & (pos < hi[:, None])
        # lanes outside [lo, hi) belong to neighbouring terms: park them on the sentinel row
        lin = qidx[:, None].long() * n_rows + torch.where(mask, docs, d.num_docs).long()
        s = SCORING_MODELS[model](tfs, dl, w1[:, None], w2[:, None], params, d.stats)
        s = torch.where(mask, s, 0.0).expand(grid_size, -1, -1)  # [G, U, TILE]

        acc = torch.zeros(grid_size, num_queries * n_rows, dtype=torch.float32, device=dev)
        num_slots = int(slot_np.max()) + 1 if len(slot_np) else 0
        for j in range(num_slots):
            sel = _upload(np.flatnonzero(slot_np == j), dev)
            acc.index_add_(1, lin[sel].reshape(-1), s[:, sel].reshape(grid_size, -1))
        scores = acc.view(grid_size, num_queries, n_rows)[:, :, : d.num_docs]
        values, ords = torch.sort(scores, dim=-1, descending=True, stable=True)
        # compact copies: a view would keep the whole sorted [G, Q, N] buffer alive while in flight
        return values[..., :topk].contiguous(), ords[..., :topk].to(torch.int32)

    # ------------------------------------------------------------------ tiered path
    def _tier_ladder(self, max_units: int, r_pad: int):
        """Unit widths per tier: ceil(base*4^i / TILE) + r_pad edge-tile allowance."""
        tiers = []
        lanes = self.TIER_BASE_LANES
        while True:
            uw = lanes // TILE + r_pad
            tiers.append(uw)
            if uw >= max_units:
                return tuple(tiers)
            lanes *= 4

    def _flat_terms(self, term_lists, model):
        """Flatten term_lists into per-(query, term) arrays with postings spans.

        Returns (tids, qix, starts, ends, w1, w2): query-major order, empty
        terms dropped."""
        d = self.dindex
        w2_source = _W2_SOURCE[model]
        tids = np.fromiter((t for terms in term_lists for t, _ in terms), dtype=np.int64)
        qw = np.fromiter((w for terms in term_lists for _, w in terms), dtype=np.float64)
        qix = np.fromiter((q for q, terms in enumerate(term_lists) for _ in terms),
                          dtype=np.int32, count=len(tids))
        if len(tids):
            starts = d.term_offsets[tids].astype(np.int64)
            ends = d.term_offsets[tids + 1].astype(np.int64)
            keep = ends > starts
            tids, qw, qix, starts, ends = tids[keep], qw[keep], qix[keep], starts[keep], ends[keep]
        else:
            starts = ends = np.zeros(0, np.int64)
        w1, w2 = self._term_weights(model, w2_source, tids, qw)
        return tids, qix, starts, ends, w1, w2

    def _cap_runs(self, tid, start, end, cap):
        """Early-termination cap on one term: the kept set is all postings whose
        impact (tf) is >= the term's cap-th largest (ties included). Against the
        canonical range-major layout the kept postings form one contiguous run
        per range (each range's impact-sorted head), so the result is a list of
        spans, cached per (term, cap). Returns (starts[], ends[]) in absolute
        posting offsets."""
        df = int(end - start)
        key = (int(tid), int(cap))
        cached = self._cap_cache.get(key)
        if cached is None:
            tfs = np.asarray(self.dindex.host_tfs[start:end])
            tau = np.partition(tfs, df - cap)[df - cap]  # cap-th largest tf
            m = np.concatenate([[False], tfs >= tau, [False]])
            idx = np.flatnonzero(m[1:] != m[:-1])  # run boundaries
            cached = (start + idx[0::2], start + idx[1::2])
            self._cap_cache[key] = cached
        return cached

    def _capped_spans(self, tids, qix, starts, ends, w1, w2, cap):
        """Apply the early-termination cap (an int, or a callable df -> cap),
        expanding capped terms into their per-range head spans. Query-major
        order is preserved."""
        cap_of = cap if callable(cap) else (lambda df: cap)
        oq, os_, oe, ow1, ow2 = [], [], [], [], []
        for i in range(len(tids)):
            df = int(ends[i] - starts[i])
            c = int(cap_of(df))
            if c >= df:
                s, e = np.asarray([starts[i]]), np.asarray([ends[i]])
            else:
                s, e = self._cap_runs(tids[i], starts[i], ends[i], c)
            oq.append(np.full(len(s), qix[i], np.int32))
            os_.append(np.asarray(s, np.int64))
            oe.append(np.asarray(e, np.int64))
            ow1.append(np.full(len(s), w1[i], np.float32))
            ow2.append(np.full(len(s), w2[i], np.float32))
        if not oq:
            return qix, starts, ends, w1, w2
        return (np.concatenate(oq), np.concatenate(os_), np.concatenate(oe),
                np.concatenate(ow1).astype(np.float32), np.concatenate(ow2).astype(np.float32))

    def _build_tiered(self, term_lists, model, max_postings: int = 0, spans=None):
        """Host side: tier-sort queries, pad each query's units to its tier width.

        Returns (packed [5, u_pad], tiers [(uw, qt_pad, qt, qbase)], u0s,
        inv_order, r_max). ``spans`` (qix, starts, ends, w1, w2) overrides the
        term_lists-derived spans (the block-max pruned path)."""
        nq = len(term_lists)
        # max duplicate copies of one doc in a query row = number of terms (spans
        # of the same term are doc-disjoint), regardless of spans-per-term
        r_max = _bucket(max((len(t) for t in term_lists), default=1), minimum=4)
        if spans is None:
            tids, qix, starts, ends, w1, w2 = self._flat_terms(term_lists, model)
            if max_postings > 0:
                qix, starts, ends, w1, w2 = self._capped_spans(tids, qix, starts, ends, w1, w2, max_postings)
        else:
            qix, starts, ends, w1, w2 = spans
        return self._build_tiered_from_spans(nq, r_max, qix, starts, ends, w1, w2)

    def _build_tiered_from_spans(self, nq, r_max, qix, starts, ends, w1, w2):
        t0 = starts // TILE
        t1 = (ends - 1) // TILE
        counts = (t1 - t0 + 1).astype(np.int64)
        units_per_q = np.bincount(qix, weights=counts, minlength=nq).astype(np.int64)

        ladder = self._tier_ladder(int(units_per_q.max()) if nq else 1, r_max)
        tier_of = np.searchsorted(np.asarray(ladder), units_per_q)
        order = np.argsort(tier_of, kind="stable")
        inv_order = np.argsort(order)
        q_tier = tier_of[order]
        tier_counts = np.bincount(q_tier, minlength=len(ladder))

        total = int(counts.sum())
        group_start = np.cumsum(counts) - counts
        within = np.arange(total, dtype=np.int64) - np.repeat(group_start, counts)
        tile = (np.repeat(t0, counts) + within).astype(np.int64)
        rs, re = np.repeat(starts, counts), np.repeat(ends, counts)
        lo = np.maximum(0, rs - tile * TILE).astype(np.int32)
        hi = np.minimum(TILE, re - tile * TILE).astype(np.int32)
        uq_old = np.repeat(qix, counts)
        uw1 = np.repeat(w1, counts)
        uw2 = np.repeat(w2, counts)

        # destination unit slot: per-query base (tier-sorted) + running slot
        newq = inv_order[uq_old] if total else uq_old
        slot_in_q = np.arange(total, dtype=np.int64) - np.searchsorted(uq_old, uq_old)
        tier_widths = np.asarray(ladder)[q_tier]
        qbase_units = np.cumsum(tier_widths) - tier_widths
        dest_unit = (qbase_units[newq] + slot_in_q) if total else np.zeros(0, np.int64)

        total_units = int(tier_widths.sum()) if nq else 1

        tub = np.cumsum(np.concatenate([[0], tier_counts * np.asarray(ladder)]))
        tiers = []
        u0s = []
        qbase = 0
        need_units = total_units
        for t, uw in enumerate(ladder):
            qt = int(tier_counts[t])
            if qt == 0:
                continue
            qt_pad = _bucket(qt, minimum=4)
            tiers.append((int(uw), qt_pad, qt, qbase))
            u0s.append(int(tub[t]))
            # the device slices qt_pad (BUCKETED) rows of width uw from u0: the
            # packed array must cover the padded slice, not just the real units
            need_units = max(need_units, int(tub[t]) + qt_pad * int(uw))
            qbase += qt

        u_pad = _bucket(need_units)
        packed = np.zeros((5, u_pad), dtype=np.int32)
        packed[0, dest_unit] = tile
        packed[1, dest_unit] = uw1.view(np.int32)
        packed[2, dest_unit] = uw2.view(np.int32)
        packed[3, dest_unit] = lo
        packed[4, dest_unit] = hi  # pad units keep hi = 0 -> fully masked
        return packed, tiers, np.asarray(u0s, np.int32), inv_order, r_max

    def _score_tiered(self, model, topk, r_max, tier_shapes, score_dtype, ord_bits,
                      packed, u0s, out_index, params, doc_tiles, tf_tiles, dl_tiles):
        """Score all lanes, then per tier sort-dedup-rank, then compact rows.

        tier_shapes: ((unit_width, qt_pad), ...); u0s: per-tier unit offsets;
        out_index [Q_pad] maps each ORIGINAL query position to its padded-concat
        tier row; params: [G, 1, 1] tensors. Returns (scores [G, Q_pad, topk]
        in ``score_dtype``, ords [G, Q_pad, topk] int32 or packed words) in the
        caller's query order: the device gathers only real query rows, so tier
        padding never crosses to the host."""
        d = self.dindex
        dev = d.device
        n = d.num_docs
        tile_idx = packed[0].long()
        w1 = packed[1].view(torch.float32)
        w2 = packed[2].view(torch.float32)
        lo, hi = packed[3], packed[4]
        docs = doc_tiles[tile_idx]  # [U, TILE]
        tfs = _f32(tf_tiles[tile_idx])
        dl = _f32(dl_tiles[tile_idx])
        pos = torch.arange(TILE, dtype=torch.int32, device=dev)
        mask = (pos >= lo[:, None]) & (pos < hi[:, None])
        docs = torch.where(mask, docs, n)
        model_fn = SCORING_MODELS[model]

        # per tier, the doc sort and the duplicate-run masks: shared by every grid point
        tiers = []
        for (uw, qt), u0 in zip(tier_shapes, u0s):
            width = uw * TILE
            dt = docs[u0 : u0 + qt * uw].reshape(qt, width)
            # stable: a duplicate run keeps unit order, so its tree sum does not
            # depend on which other spans the batch holds (pruned == exhaustive)
            docv, perm = torch.sort(dt, dim=1, stable=True)
            sames, shift = [], 1
            while shift < r_max:  # duplicate-doc runs have length <= r_max
                sames.append(docv[:, shift:] == docv[:, :-shift])
                shift *= 2
            first = torch.ones_like(docv, dtype=torch.bool)
            first[:, 1:] = docv[:, 1:] != docv[:, :-1]
            tiers.append((u0, uw, qt, width, docv, perm, sames, first))

        grid_size = next(iter(params.values())).shape[0] if params else 1
        units = tile_idx.shape[0]
        g_chunk = max(1, TIER_GRID_LANES // max(1, units * TILE))
        score_out, ord_out = [], []
        for g0 in range(0, grid_size, g_chunk):
            p = {k: v[g0 : g0 + g_chunk] for k, v in params.items()}
            gc = min(g_chunk, grid_size - g0)
            s = model_fn(tfs, dl, w1[:, None], w2[:, None], p, d.stats)
            s = torch.where(mask, s, -1.0).expand(gc, units, TILE)
            rows_s, rows_d = [], []
            for u0, uw, qt, width, docv, perm, sames, first in tiers:
                st = s[:, u0 : u0 + qt * uw].reshape(gc, qt, width)
                merged = torch.gather(st, 2, perm.expand(gc, qt, width))
                # masked doubling shifts put each duplicate run's exact sum on its first element
                shift = 1
                for same in sames:
                    add = torch.zeros_like(merged)
                    add[..., : width - shift] = torch.where(same, merged[..., shift:], 0.0)
                    merged = merged + add
                    shift *= 2
                merged = torch.where(first & (merged > 0), merged, -1.0)
                # rank: score desc, doc ordinal asc (Lucene's docid tie-break): the
                # rows are in ascending doc order, and the sort is stable
                top, idx = torch.sort(merged, dim=-1, descending=True, stable=True)
                k = min(topk, width)
                top_scores = top[..., :k]
                top_docs = torch.gather(docv.expand(gc, qt, width), 2, idx[..., :k])
                top_docs = torch.where(top_scores > 0, top_docs, n)
                if k < topk:
                    top_scores = torch.cat(
                        [top_scores, torch.full((gc, qt, topk - k), -1.0, device=dev)], dim=-1)
                    top_docs = torch.cat(
                        [top_docs, torch.full((gc, qt, topk - k), n, dtype=torch.int32, device=dev)], dim=-1)
                rows_s.append(top_scores)
                rows_d.append(top_docs)
            # device-side row compaction: the real query rows, in the caller's order
            sc = torch.cat(rows_s, dim=1)[:, out_index]
            dc = torch.cat(rows_d, dim=1)[:, out_index]
            if ord_bits:
                dc = _pack_bits(dc, ord_bits, topk, n)
            score_out.append(sc.to(getattr(torch, score_dtype)))
            ord_out.append(dc)
        return torch.cat(score_out), torch.cat(ord_out)

    # ------------------------------------------------------------------ host streaming
    def _stream_working_set(self, packed, model):
        """Gather the batch's working set (the unique tiles its units touch)
        from the host-resident tile arrays into compact buffers, and remap the
        units' tile indices into the buffer. Buffer rows are bucketed to powers
        of two; pad rows carry sentinel docs (masked by hi=0 anyway). Host numpy
        only: search_stream runs it on its worker threads."""
        d = self.dindex
        # working set over REAL units only (pad units carry tile 0 with hi=0 and
        # must not force tile 0 into every upload or inflate the stats); pads are
        # remapped to row 0, which is valid and masked on the device anyway
        real = packed[4] > 0  # tiered layout rows: tile, w1, w2, lo, hi
        uniq = np.unique(packed[0][real]) if real.any() else np.zeros(1, packed[0].dtype)
        remap = np.clip(np.searchsorted(uniq, packed[0]), 0, len(uniq) - 1)
        n_buf = _bucket(len(uniq), minimum=64)
        doc_buf = np.full((n_buf, TILE), d.num_docs, np.int32)
        doc_buf[: len(uniq)] = d.doc_tiles_np[uniq]
        tf_buf = _payload_full((n_buf, TILE), 0.0, d.tf_tiles_np.dtype)
        tf_buf[: len(uniq)] = d.tf_tiles_np[uniq]
        dl_src = d.norm_dl_tiles_np if model in _NORM_DL_MODELS else d.exact_dl_tiles_np
        dl_buf = _payload_full((n_buf, TILE), 1.0, dl_src.dtype)
        dl_buf[: len(uniq)] = dl_src[uniq]
        packed = packed.copy()
        packed[0] = remap.astype(np.int32)
        self.last_stream_stats = {"tiles_uploaded": int(len(uniq)),
                                  "bytes_uploaded": int(doc_buf.nbytes + tf_buf.nbytes + dl_buf.nbytes),
                                  "total_tiles": int(d.n_tiles)}
        return packed, (doc_buf, tf_buf, dl_buf)

    def _upload_working_set(self, buffers):
        """Working-set buffers -> the device. On a card they go from pinned
        memory on a side stream, and the compute stream waits on an event, so
        the upload overlaps earlier batches' compute. Runs on the dispatch
        thread."""
        dev = self.dindex.device
        if dev.type != "cuda":
            return tuple(_host_tensor(b) for b in buffers)
        pinned = [_host_tensor(b).pin_memory() for b in buffers]
        if self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(device=dev)
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(self._upload_stream):
            out = tuple(p.to(dev, non_blocking=True) for p in pinned)
            done = torch.cuda.Event()
            done.record()
        compute.wait_event(done)
        for t in out:  # allocated on the side stream, read on the compute stream
            t.record_stream(compute)
        return out

    # ------------------------------------------------------------------ block-max pruning
    # Exact dynamic pruning (the analog of WAND/MaxScore over Lucene's block-max
    # skip data): a free host-side threshold theta_q lower-bounds the true k-th
    # best score using achievable single-posting contributions (each (term,
    # range) span head is a real posting, so a doc's full score is >= the sum of
    # its head contributions); the device pass then skips every doc range R whose
    # score upper bound U_q(R) = sum over query terms of the term's max possible
    # contribution within R is STRICTLY below theta_q. Any doc in a skipped range
    # has true score <= U_q(R) < theta_q <= true k-th best, so no top-k doc
    # (tie-breaks included) is ever skipped, and all surviving docs score exactly:
    # the pruned result is bit-identical to exhaustive scoring, in ONE device pass.

    def supports_pruning(self, model="bm25", grid=None, max_postings_per_term=0):
        """Exact pruning needs BM25 (monotone bound: contribution increases in tf,
        decreases in dl for any k1/b), a single parameter point, no approximate
        cap, and an index built with block-max tables (canonical range layout)."""
        return (model == "bm25" and not grid and not max_postings_per_term
                and self.dindex.prune is not None)

    def compute_theta(self, term_lists, params=None, topk=1000):
        """Host-side pruning thresholds, [Q] f32: the k-th best achievable score
        among span-head postings (summed per doc: a doc's true score is >= the
        sum of its single-term head contributions). -1 when a query has fewer
        than k head candidates (pruning disabled for it). No device work."""
        params = dict(params or {"k1": 0.9, "b": 0.4})  # Anserini BM25 defaults
        k1, b = float(params["k1"]), float(params["b"])
        topk = min(topk, self.dindex.num_docs)
        pt = self.dindex.prune
        d = self.dindex
        cache_key_params = (k1, b)
        theta = np.full(len(term_lists), -1.0, dtype=np.float32)
        for q, terms in enumerate(term_lists):
            docs_parts, c_parts = [], []
            for t, w in terms:
                cached = self._theta_cache.get((t, cache_key_params))
                if cached is None:
                    a, b_ = int(pt["rt_offsets"][t]), int(pt["rt_offsets"][t + 1])
                    heads = pt["rt_start"][a:b_]
                    hd = d.host.doc_ids[heads]
                    tf_h = d.host_tfs[heads].astype(np.float64)
                    dl_h = d.host.norm_doclens[hd].astype(np.float64)
                    c = d.idf[t] * tf_h / (tf_h + k1 * (1.0 - b + b * dl_h / d.avgdl))
                    cached = (hd, c)
                    self._theta_cache[(t, cache_key_params)] = cached
                docs_parts.append(cached[0])
                c_parts.append(cached[1] * w)
            if not docs_parts:
                continue
            dd = np.concatenate(docs_parts)
            cc = np.concatenate(c_parts)
            if len(dd) < topk:
                continue
            # top (2k) entries, then dedup-by-doc with per-doc sums (valid lower
            # bounds); k-th best of those is a valid theta
            m = min(len(cc), 2 * topk)
            sel = np.argpartition(cc, len(cc) - m)[len(cc) - m:]
            dd, cc = dd[sel], cc[sel]
            o = np.argsort(dd)
            dd, cc = dd[o], cc[o]
            seg = np.concatenate([[0], np.flatnonzero(dd[1:] != dd[:-1]) + 1])
            sums = np.add.reduceat(cc, seg)
            if len(sums) >= topk:
                theta[q] = np.partition(sums, len(sums) - topk)[len(sums) - topk]
        return theta

    # when pruning keeps more than this fraction of device tiles, the batch
    # falls back to the exhaustive span set (pruning is then a no-op and the
    # extra host work / irregular unit shapes buy nothing)
    PRUNE_MIN_TILE_SAVINGS = 0.1

    def _spans_pruned(self, term_lists, model, params, theta):
        """Build the pruned span set: keep only the (term, doc-range) spans of
        ranges whose bound survives theta, COARSENED to the device's 512-lane
        tile grid. The device can only skip whole tiles, so surviving ranges
        expand to the tiles containing them (a superset: extra docs from pruned
        ranges carry partial scores strictly below theta and cannot enter the
        top-k, so exactness is preserved) and the span count per term is bounded
        by its tile count, never more device units than exhaustive scoring.
        Returns None when pruning would keep nearly all tiles (caller falls back
        to the exhaustive path)."""
        pt = self.dindex.prune
        k1, b = float(params["k1"]), float(params["b"])
        avgdl = self.dindex.avgdl
        tids, qix, starts, ends, w1, w2 = self._flat_terms(term_lists, model)
        rt_off, rt_range = pt["rt_offsets"], pt["rt_range"]
        rt_start, rt_end = pt["rt_start"], pt["rt_end"]
        rt_max_tf, rt_min_dl = pt["rt_max_tf"], pt["rt_min_dl"]
        range_size = int(pt["range_size"])
        num_ranges = (self.dindex.num_docs + range_size - 1) // range_size

        def ub(tf, dl, w):  # BM25 contribution upper bound at (max tf, min dl)
            return w * tf / (tf + k1 * (1.0 - b + b * dl / avgdl))

        oq, os_, oe, ow1, ow2 = [], [], [], [], []
        total_tiles = kept_tiles = 0
        kept_lanes = total_lanes = 0
        bounds = np.searchsorted(qix, np.arange(len(term_lists) + 1))
        for q in range(len(term_lists)):
            idx = range(int(bounds[q]), int(bounds[q + 1]))
            th = float(theta[q])
            prunable = {i for i in idx if rt_off[tids[i] + 1] > rt_off[tids[i]]} if th > 0 else set()
            U = None
            if prunable:
                U = np.zeros(num_ranges, dtype=np.float64)
                for i in idx:
                    a, b_ = int(rt_off[tids[i]]), int(rt_off[tids[i] + 1])
                    if b_ > a:
                        U[rt_range[a:b_]] += ub(rt_max_tf[a:b_].astype(np.float64),
                                                rt_min_dl[a:b_].astype(np.float64), float(w1[i]))
                    else:  # term without tables: charge its global bound everywhere
                        U += ub(float(pt["gmax_tf"][tids[i]]), float(pt["gmin_dl"][tids[i]]), float(w1[i]))
                # strict skip below theta, with a safety margin for f32-vs-f64
                # rounding between the device score sum and the host bound
                keep = U * (1.0 + 1e-5) + 1e-6 >= th
            for i in idx:
                start, end = int(starts[i]), int(ends[i])
                n_tiles_full = (end - 1) // TILE - start // TILE + 1
                total_tiles += n_tiles_full
                total_lanes += end - start
                if U is None or i not in prunable:
                    cs, ce = np.asarray([start], np.int64), np.asarray([end], np.int64)
                    kept_lanes += end - start
                else:
                    a, b_ = int(rt_off[tids[i]]), int(rt_off[tids[i] + 1])
                    sel = keep[rt_range[a:b_]]
                    if not sel.any():
                        continue
                    s_sel, e_sel = rt_start[a:b_][sel], rt_end[a:b_][sel]
                    kept_lanes += int((e_sel - s_sel).sum())
                    # snap survivors outward to the GLOBAL tile grid, then merge
                    # overlapping/adjacent intervals (entries are start-sorted)
                    s_k = np.maximum(start, (s_sel // TILE) * TILE)
                    e_k = np.minimum(end, ((e_sel - 1) // TILE + 1) * TILE)
                    cm = np.maximum.accumulate(e_k)
                    brk = np.flatnonzero(s_k[1:] > cm[:-1])
                    cs = s_k[np.concatenate([[0], brk + 1])].astype(np.int64)
                    ce = cm[np.concatenate([brk, [len(s_k) - 1]])].astype(np.int64)
                kept_tiles += int(((ce - 1) // TILE - cs // TILE + 1).sum())
                oq.append(np.full(len(cs), qix[i], np.int32))
                os_.append(cs)
                oe.append(ce)
                ow1.append(np.full(len(cs), w1[i], np.float32))
                ow2.append(np.full(len(cs), w2[i], np.float32))
        self.last_prune_stats = {"total_lanes": total_lanes, "kept_lanes": kept_lanes,
                                 "total_tiles": total_tiles, "kept_tiles": kept_tiles}
        if kept_tiles > (1.0 - self.PRUNE_MIN_TILE_SAVINGS) * total_tiles:
            return None  # not enough tile-level savings: run exhaustive
        if not oq:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32), np.zeros(0, np.float32))
        return (np.concatenate(oq), np.concatenate(os_), np.concatenate(oe),
                np.concatenate(ow1), np.concatenate(ow2))

    def _build_prune_spans(self, term_lists, model, params, topk):
        """Spans for an exact pruned pass, or None when tile savings are too
        small. Uses the native C++ span builder (native/pruner.cpp: threshold,
        bounds and span extraction in one pass) when it loads; the numpy path
        (compute_theta + _spans_pruned) is the fallback. The two sample other
        threshold candidates, so their spans differ; both keep results exact."""
        lib = get_pruner_lib()
        if lib is None:
            theta = self.compute_theta(term_lists, params=params, topk=topk)
            return self._spans_pruned(term_lists, model, params, theta)

        d = self.dindex
        pt = d.prune
        tids, qix, starts, ends, w1, w2 = self._flat_terms(term_lists, model)
        q_offsets = np.searchsorted(qix, np.arange(len(term_lists) + 1)).astype(np.int64)
        arrs = self._native_prune_arrays
        if arrs is None:
            def as_native(a, dt):
                # the index build already stores these at the native dtypes:
                # a copy here would cost O(postings) once, inside the first batch
                a = np.asarray(a)
                return a if a.dtype == dt and a.flags["C_CONTIGUOUS"] else np.ascontiguousarray(a, dtype=dt)

            arrs = self._native_prune_arrays = (
                as_native(pt["rt_offsets"], np.int64), as_native(pt["rt_range"], np.int32),
                as_native(pt["rt_start"], np.int64), as_native(pt["rt_end"], np.int64),
                as_native(pt["rt_max_tf"], np.float32), as_native(pt["rt_min_dl"], np.float32),
                as_native(pt["gmax_tf"], np.float32), as_native(pt["gmin_dl"], np.float32),
                as_native(d.host.doc_ids, np.int32), as_native(d.host_tfs, np.int32),
                as_native(d.host.norm_doclens, np.int32))
        rt_off = arrs[0]
        # at most one span per range entry of each term, plus one per table-less term
        cap = int((rt_off[tids + 1] - rt_off[tids]).sum()) + len(tids) + 1
        out_qix = np.empty(cap, np.int32)
        out_s = np.empty(cap, np.int64)
        out_e = np.empty(cap, np.int64)
        out_w1 = np.empty(cap, np.float32)
        out_stats = np.zeros(4, np.int64)

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        tids_c = np.ascontiguousarray(tids, np.int64)
        w1_c = np.ascontiguousarray(w1, np.float32)
        starts_c = np.ascontiguousarray(starts, np.int64)
        ends_c = np.ascontiguousarray(ends, np.int64)
        num_ranges = (d.num_docs + int(pt["range_size"]) - 1) // int(pt["range_size"])
        n = lib.ctpu_prune_spans(
            p(q_offsets, i64), len(term_lists),
            p(tids_c, i64), p(w1_c, f32), p(starts_c, i64), p(ends_c, i64),
            p(arrs[0], i64), p(arrs[1], i32), p(arrs[2], i64), p(arrs[3], i64),
            p(arrs[4], f32), p(arrs[5], f32), p(arrs[6], f32), p(arrs[7], f32),
            p(arrs[8], i32), p(arrs[9], i32), p(arrs[10], i32),
            float(params["k1"]), float(params["b"]), d.avgdl,
            num_ranges, min(int(topk), d.num_docs), TILE, self.PRUNE_MIN_TILE_SAVINGS,
            p(out_qix, i32), p(out_s, i64), p(out_e, i64), p(out_w1, f32), p(out_stats, i64))
        self.last_prune_stats = {"total_lanes": int(out_stats[0]), "kept_lanes": int(out_stats[1]),
                                 "total_tiles": int(out_stats[2]), "kept_tiles": int(out_stats[3])}
        if n < 0:
            return None
        return (out_qix[:n].copy(), out_s[:n].copy(), out_e[:n].copy(), out_w1[:n].copy(),
                np.zeros(n, np.float32))

    def _prepare_tiered(self, term_lists, model, max_postings=0, spans=None):
        """Host-side batch construction: tier/unit packing plus (in streaming
        mode) the working-set gather and remap, everything search() does before
        the device work, bundled so search_stream can run it on a worker thread
        AHEAD of dispatch. Returns the opaque tuple search() accepts as
        ``_prebuilt``."""
        packed, tiers, u0s, inv_order, r_max = self._build_tiered(term_lists, model, max_postings, spans=spans)
        buffers = None
        if self.dindex.streaming:
            packed, buffers = self._stream_working_set(packed, model)
        return packed, tiers, u0s, inv_order, r_max, buffers

    def _get_span_executor(self):
        if self._span_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._span_executor = ThreadPoolExecutor(
                max_workers=max(1, min(4, os.cpu_count() or 1)), thread_name_prefix="stream-prep")
        return self._span_executor

    # ----------------------------------------------- persisted pruning verdicts
    # A wall-clock A/B verdict is a property of (corpus, topk, params, residency
    # mode, device), not of one engine instance: once settled it is stored next
    # to the index's tile cache so fresh engines and fresh PROCESSES skip
    # re-probing a settled regime. The key names the device (its type and, on a
    # card, its name): one index cache can serve the CPU and a card, and a
    # verdict settled on one never serves the other.
    PRUNE_VERDICT_SCHEMA = 4  # v4: the key names the device
    # within-noise probes observed (across processes) before pruning is
    # permanently retired for the key: a tie means pruning cannot CLEARLY win,
    # and exhaustive is the safe baseline (results are bit-identical)
    PRUNE_TIE_LIMIT = 2
    # a mode must win by this margin for a verdict to stick
    PRUNE_PROBE_MARGIN = 0.10
    # short-stream exploration: streams below this batch count can't amortize
    # an intra-stream probe; they explore at the STREAM level instead: whole
    # streams alternate modes at full speed
    PRUNE_LONG_STREAM = 32
    # settled short-stream verdicts re-explore the opposite mode every Nth serve
    PRUNE_RECHECK_EVERY = 8
    # stream-level wall samples kept per mode (min over ring = mode cost)
    PRUNE_SAMPLE_RING = 4

    def _verdict_path(self):
        td = getattr(self.dindex, "_tile_dir", None)
        if td is not None:
            return os.path.join(td, "prune_verdicts.json")
        return getattr(self.dindex.host, "verdict_path", None)

    def _verdict_key(self, kind, key):
        topk, k1, b = key
        d = self.dindex
        mode = "stream" if d.streaming else "resident"
        return (f"v{self.PRUNE_VERDICT_SCHEMA}:{kind}:{topk}:{k1}:{b}:{mode}:{_device_name(d.device)}:"
                f"{d.num_docs}:{len(d.host.doc_ids)}")

    def _read_verdict_file(self, p):
        """The current-schema entries of the store at ``p`` ({} when absent or unreadable)."""
        try:
            with open(p) as f:
                loaded = json.load(f)
        except (OSError, ValueError):
            return {}
        # stale-schema keys can never be read again: drop them
        pre = f"v{self.PRUNE_VERDICT_SCHEMA}:"
        return {k: v for k, v in loaded.items() if k.startswith(pre)} if isinstance(loaded, dict) else {}

    def _load_verdicts(self):
        with self._verdict_lock:
            if self._prune_verdicts is None:
                p = self._verdict_path()
                self._prune_verdicts = self._read_verdict_file(p) if p is not None and os.path.exists(p) else {}
            return self._prune_verdicts

    def _persisted_verdict(self, kind, key):
        ent = self._load_verdicts().get(self._verdict_key(kind, key))
        return ent.get("verdict") if isinstance(ent, dict) else ent

    def _record_verdict(self, kind, key, verdict=None, tie=False):
        """Record a probe outcome. A clear-margin ``verdict`` persists
        immediately; ``tie=True`` accumulates within-noise probes and retires
        pruning (verdict False) once PRUNE_TIE_LIMIT ties have been seen."""
        vs = self._load_verdicts()
        ks = self._verdict_key(kind, key)
        with self._verdict_lock:
            old = vs.get(ks)
            ent = dict(old) if isinstance(old, dict) else {}  # keep samples/serves
            if tie:
                ent["ties"] = ent.get("ties", 0) + 1
                if ent["ties"] >= self.PRUNE_TIE_LIMIT:
                    ent["verdict"] = False
            else:
                ent["verdict"] = bool(verdict)
                ent["ties"] = 0
            vs[ks] = ent
            self._dirty_verdicts.add(ks)
        self._flush_verdicts()

    def _flush_verdicts(self):
        """Write the store: under the engine's lock (a snapshot, so no other
        thread mutates what is being dumped) and an exclusive lock on the file,
        the entries on disk are merged with the ones this engine changed before
        the atomic rename, so two engines' flushes keep both's entries."""
        p = self._verdict_path()
        if p is None or self._prune_verdicts is None:
            return
        import fcntl

        with self._verdict_lock:
            try:
                with open(f"{p}.lock", "a") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    merged = self._read_verdict_file(p) if os.path.exists(p) else {}
                    merged.update({k: self._prune_verdicts[k] for k in self._dirty_verdicts
                                   if k in self._prune_verdicts})
                    snapshot = json.dumps(merged, indent=0)
                    tmp = f"{p}.tmp{os.getpid()}_{threading.get_ident()}"
                    with open(tmp, "w") as f:
                        f.write(snapshot)
                    os.replace(tmp, p)
                # entries other engines settled become this engine's view too
                self._prune_verdicts.update({k: v for k, v in merged.items() if k not in self._dirty_verdicts})
                self._dirty_verdicts.clear()
            except OSError:  # read-only index dir: verdicts stay in memory only
                pass

    def _verdict_entry(self, kind, key):
        ent = self._load_verdicts().get(self._verdict_key(kind, key))
        return dict(ent) if isinstance(ent, dict) else {}

    def _store_verdict_entry(self, kind, key, ent, flush=True):
        """``flush=False`` updates the in-memory store only: counter-only bumps
        (serves/explore_n) don't need a JSON rewrite per stream; the next
        verdict-bearing store (or a cycle-point bump) flushes them."""
        vs = self._load_verdicts()
        ks = self._verdict_key(kind, key)
        with self._verdict_lock:
            vs[ks] = ent
            self._dirty_verdicts.add(ks)
        if flush:
            self._flush_verdicts()

    def _stream_mode_plan(self, key):
        """Short-stream adaptive plan: (serve_pruned, record_sample).

        Settled verdicts serve directly at full speed; every
        PRUNE_RECHECK_EVERY-th serve explores the OPPOSITE mode and records a
        fresh wall sample, so a verdict recorded under stale conditions heals.
        Unsettled regimes alternate whole streams between modes (exhaustive
        first, the safe baseline) and record every wall: exploration IS
        serving."""
        ent = self._verdict_entry("stream", key)
        verdict = ent.get("verdict")
        if verdict is not None:
            serves = ent.get("serves", 0) + 1
            ent["serves"] = serves
            at_cycle = serves % self.PRUNE_RECHECK_EVERY in (0, self.PRUNE_RECHECK_EVERY // 2)
            # counter-only bumps skip the per-stream JSON rewrite
            self._store_verdict_entry("stream", key, ent, flush=at_cycle)
            if serves % self.PRUNE_RECHECK_EVERY == 0:
                return (not verdict), True
            if serves % self.PRUNE_RECHECK_EVERY == self.PRUNE_RECHECK_EVERY // 2:
                # mid-cycle: refresh the SERVING mode's wall sample too, so
                # flips compare fresh-vs-fresh
                return bool(verdict), True
            return bool(verdict), False
        n = ent.get("explore_n", 0)
        ent["explore_n"] = n + 1
        self._store_verdict_entry("stream", key, ent, flush=False)  # sample follows
        return (n % 2 == 1), True

    def _stream_level_record(self, key, served_pruned, per_batch_wall):
        """Add a stream-level wall sample and (re)settle the verdict when both
        modes have evidence: min-per-mode over the last PRUNE_SAMPLE_RING
        samples, clear PRUNE_PROBE_MARGIN to decide, persistent overlap after
        enough looks retires pruning to the safe baseline."""
        ent = self._verdict_entry("stream", key)
        samples = ent.setdefault("samples", {})
        ring = samples.setdefault("p" if served_pruned else "e", [])
        ring.append(round(float(per_batch_wall), 6))
        del ring[: -self.PRUNE_SAMPLE_RING]
        p, e = samples.get("p", []), samples.get("e", [])
        m = self.PRUNE_PROBE_MARGIN
        if len(p) >= 2 and len(e) >= 2:
            tp, te = min(p), min(e)
            new = None
            if tp < (1.0 - m) * te:
                new = True
            elif te < (1.0 - m) * tp:
                new = False
            cur = ent.get("verdict")
            if new is not None:
                if new != cur:
                    ent["verdict"] = new
                    ent["serves"] = 0
                    # wall-clock evidence supersedes accumulated tie strikes
                    ent["ties"] = 0
                    logger.info("pruned-stream verdict %s from stream-level walls "
                                "(pruned min %.1f ms/batch vs exhaustive %.1f)",
                                "PRUNING ON" if new else "exhaustive", tp * 1e3, te * 1e3)
                self._prune_stream_effective[key] = new
            elif cur is None and len(p) >= self.PRUNE_SAMPLE_RING and len(e) >= self.PRUNE_SAMPLE_RING:
                # enough looks, no separation: exhaustive is the safe baseline
                ent["verdict"] = False
                ent["serves"] = 0
                self._prune_stream_effective[key] = False
        self._store_verdict_entry("stream", key, ent)

    def search_pruned(self, term_lists, model="bm25", params=None, topk=1000, **kw):
        """Exact block-max pruned search: free host-side thresholds + ONE pruned
        device pass. Results are bit-identical to search() without pruning.

        Adaptive (never worse than exhaustive beyond two probe batches): the
        first batch checks whether range pruning drops device TILES at all (it
        does when postings are doc-id clustered; it cannot on uniformly random
        doc assignment), then an A/B wall-clock probe on the next batches
        compares true end-to-end cost (the host-side bound work can exceed the
        device work it saves even when tiles drop). The decision is sticky per
        (topk, params); every 64th call under a settled verdict re-probes."""
        _time = time  # module-level binding: tests control the probe clock

        params = dict(params or {"k1": 0.9, "b": 0.4})  # Anserini BM25 defaults
        key = (int(topk), float(params["k1"]), float(params["b"]))
        state = self._prune_effective.get(key)
        if state is None:  # a settled verdict from an earlier process skips the probe
            state = self._persisted_verdict("sync", key)
            if state is not None:
                self._prune_effective[key] = state
        prior = state
        if (state is not None and self._prune_tiles_ok.get(key) is not False
                and self._persisted_verdict("tiles", key) is not False):
            # periodic healing: every 64th call under a settled verdict re-runs
            # the A/B (cost: one extra batch) and a clear opposite margin flips
            # it. Structural (tiles) verdicts are deterministic and never re-probe.
            n = self._sync_serves.get(key, 0) + 1
            self._sync_serves[key] = n
            if n % (8 * self.PRUNE_RECHECK_EVERY) == 0:
                state = None
        if state is not None:
            # a settled fast path only ever runs ONE mode; remember which, so a
            # later healing re-probe knows the other mode still needs a warm-up
            self._prune_warm.add((key, bool(state)))
        if state is False:
            return self.search(term_lists, model=model, params=params, topk=topk, exact_topk=False, **kw)

        def timed(fn):
            t0 = _time.perf_counter()
            r = fn()
            if isinstance(r, TieredResult):
                r.get()  # the wall includes the fetch: asynchronous launches alone look free
            return r, _time.perf_counter() - t0

        if state is None:
            # probe 1: does pruning drop tiles at all?
            t0 = _time.perf_counter()
            spans = self._build_prune_spans(term_lists, model, params, topk)
            host_cost = _time.perf_counter() - t0
            if spans is None:
                logger.info("block-max pruning ineffective at this corpus/topk "
                            "(kept %.0f%% of tiles); falling back to exhaustive scoring",
                            100.0 * self.last_prune_stats["kept_tiles"]
                            / max(1, self.last_prune_stats["total_tiles"]))
                self._prune_effective[key] = False
                self._prune_tiles_ok[key] = False
                # structural for THIS engine's workload, but the thresholds
                # depend on the probe batch's query mix: the PERSISTED retire
                # needs two independent observations (tie-style)
                self._record_verdict("sync", key, tie=True)
                self._record_verdict("tiles", key, tie=True)
                return self.search(term_lists, model=model, params=params, topk=topk, exact_topk=False, **kw)
            self._prune_tiles_ok[key] = True

            def run_pruned():
                return self.search(term_lists, model=model, params=params, topk=topk,
                                   prune_spans=spans, exact_topk=False, **kw)

            def run_exh():
                return self.search(term_lists, model=model, params=params, topk=topk, exact_topk=False, **kw)

            # warm each NOT-YET-WARM mode first (first calls pay allocator and
            # library set-up) so it cannot poison the A/B
            for mode, run in ((True, run_pruned), (False, run_exh)):
                if (key, mode) not in self._prune_warm:
                    timed(run)
                    self._prune_warm.add((key, mode))
            # probe 2: A/B the true cost (device work + fetch, synchronous)
            r_prune, t_prune = timed(run_pruned)
            _, t_exh = timed(run_exh)
            t_p_full = t_prune + host_cost
            m = self.PRUNE_PROBE_MARGIN
            ratio = max(t_p_full, t_exh) / max(1e-9, min(t_p_full, t_exh))
            stick = True
            if ratio >= 3.0:
                # anomalous for a genuine mode difference: serve the prior (or
                # this call's winner), record nothing, don't go sticky
                effective = prior if prior is not None else (t_p_full < t_exh)
                label = "anomalous ratio, this call only"
                stick = prior is not None
            elif t_p_full < (1.0 - m) * t_exh:
                effective, label = True, "PRUNING ON"
                self._record_verdict("sync", key, True)
            elif t_exh < (1.0 - m) * t_p_full:
                effective, label = False, "exhaustive"
                self._record_verdict("sync", key, False)
            elif prior is not None:
                effective, label = prior, "within noise, keeping settled verdict"
            else:
                # within noise: exhaustive is the safe baseline; retired on disk
                # after PRUNE_TIE_LIMIT independent ties
                effective, label = False, "exhaustive (within noise)"
                self._record_verdict("sync", key, tie=True)
            if stick:
                self._prune_effective[key] = effective
            logger.info("block-max pruning A/B probe: pruned %.1f ms (+%.1f ms host) vs "
                        "exhaustive %.1f ms -> %s", t_prune * 1e3, host_cost * 1e3, t_exh * 1e3, label)
            return r_prune  # bit-identical either way

        spans = self._build_prune_spans(term_lists, model, params, topk)
        if spans is None:  # query mix shifted; keep exactness, stay adaptive
            return self.search(term_lists, model=model, params=params, topk=topk, exact_topk=False, **kw)
        return self.search(term_lists, model=model, params=params, topk=topk,
                           prune_spans=spans, exact_topk=False, **kw)

    def search_stream(self, batches, model="bm25", params=None, topk=1000,
                      window=4, pruned=False, adaptive=True, **kw):
        """Pipelined search over many query batches.

        ALL host-side batch construction (exact block-max span pruning when
        ``pruned``, tier/unit packing, and streaming mode's working-set gathers)
        runs on a worker pool AHEAD of dispatch (numpy releases the GIL), so the
        dispatch thread only uploads, launches and starts asynchronous fetches.

        Returns a lazy iterator (batch order) of whatever ``search`` returns
        for the given kwargs (pass ``materialize=False`` to pipeline fetches
        too). At most ``window`` batches' device work is in flight at once, so
        result buffers and streaming uploads stay bounded in device memory.
        Results are bit-identical to exhaustive ``search`` in every mode.

        ``pruned=True`` is adaptive in two stages (sticky per (topk, params)):
          1. tile probe: batch 0's spans are built inline; if pruning keeps
             ~all tiles (no doc-id locality), all remaining batches skip
             bound work entirely.
          2. wall-clock probe: long streams interleave exhaustive and pruned
             segments and the per-segment walls decide; short streams explore
             at the stream level (whole streams alternate modes).
        ``adaptive=False`` forces the pruned path whenever tiles drop
        (diagnostics, never the production default).
        """
        from collections import deque

        params = dict(params or {"k1": 0.9, "b": 0.4})
        batches = list(batches)
        window = max(1, int(window))
        key = (int(topk), float(params.get("k1", 0.9)), float(params.get("b", 0.4)))
        if model not in _NORM_DL_MODELS:
            # materialize the lazy QL/DFR payload before worker threads race on it
            _ = self.dindex.exact_dl_tiles_np if self.dindex.streaming else self.dindex.exact_dl_tiles

        def gen():
            if not batches:
                return
            use_pruned = bool(pruned) and self.supports_pruning(model)
            if use_pruned and adaptive and self._prune_tiles_ok.get(key) is None:
                # structural tile verdicts settled by an earlier process skip
                # even the batch-0 span build
                ptiles = self._persisted_verdict("tiles", key)
                if ptiles is not None:
                    self._prune_tiles_ok[key] = ptiles
            if use_pruned and self._prune_tiles_ok.get(key) is False:
                use_pruned = False
            # prior: the last settled wall-clock verdict (this engine or an
            # earlier process); a PRIOR, re-measured, never a permanent skip
            decided = self._prune_stream_effective.get(key) if adaptive else None
            if decided is None and adaptive and use_pruned:
                decided = self._persisted_verdict("stream", key)
                if decided is not None:
                    self._prune_stream_effective[key] = decided
            prior = decided
            P = max(2, min(window, len(batches) // 4))
            long_stream = len(batches) >= max(2 * P, self.PRUNE_LONG_STREAM)
            will_probe = use_pruned and adaptive and long_stream
            explore_record = False
            # structural discovery (once per key): if the spans keep every
            # tile, neither pipelined nor synchronous pruning can pay
            spans0 = None
            if use_pruned and self._prune_tiles_ok.get(key) is None:
                spans0 = self._build_prune_spans(batches[0], model, params, topk)
                if spans0 is None:
                    self._prune_tiles_ok[key] = False
                    self._prune_effective.setdefault(key, False)
                    self._prune_stream_effective[key] = False
                    if adaptive:
                        # the persisted retire needs a SECOND independent observation
                        self._record_verdict("tiles", key, tie=True)
                        self._record_verdict("stream", key, tie=True)
                        self._record_verdict("sync", key, tie=True)
                    use_pruned = False
                else:
                    self._prune_tiles_ok[key] = True

            if use_pruned and adaptive and not long_stream:
                serve_pruned, explore_record = self._stream_mode_plan(key)
                if not serve_pruned:
                    use_pruned = False
            # spans for batch 0 are only needed when the pruned path will run
            if use_pruned and spans0 is None:
                spans0 = self._build_prune_spans(batches[0], model, params, topk)
                if spans0 is None:  # query-mix shift: exhaustive this stream
                    use_pruned = False

            ex = self._get_span_executor()

            def prepare(b, spans, do_prune):
                if do_prune and spans is None:
                    # None on a query-mix shift: that batch runs exhaustive (exact either way)
                    spans = self._build_prune_spans(b, model, params, topk)
                return self._prepare_tiered(b, model, spans=spans)

            def submit(i, do_prune):
                s0 = spans0 if (i == 0 and do_prune) else None
                return ex.submit(prepare, batches[i], s0, do_prune)

            def dispatch(i, fut):
                return self.search(batches[i], model=model, params=params, topk=topk,
                                   _prebuilt=fut.result(), exact_topk=False, **kw)

            def fetch(r):
                return _ReadyResult(r.get()) if isinstance(r, TieredResult) else r

            def run_segment(idxs, futs):
                t0 = time.perf_counter()
                pend, out = deque(), []
                for i, f in zip(idxs, futs):
                    pend.append(dispatch(i, f))
                    if len(pend) > window:
                        out.append(fetch(pend.popleft()))
                out.extend(fetch(p) for p in pend)
                return out, time.perf_counter() - t0

            def warm(mode_prune):
                # warm a mode on batch 0 UNTIMED (first calls pay allocator and
                # library set-up). Once per (key, mode) per engine.
                wkey = (key, mode_prune)
                if wkey in self._prune_warm:
                    return
                fetch(self.search(batches[0], model=model, params=params, topk=topk,
                                  _prebuilt=prepare(batches[0], spans0 if mode_prune else None, mode_prune),
                                  exact_topk=False, **kw))
                self._prune_warm.add(wkey)

            if will_probe and use_pruned:
                warm(False)
                warm(True)
                # wall-clock A/B probe: interleaved half-rounds (E, P, E, P),
                # each mode taking its per-batch MINIMUM across rounds; both
                # modes' host prep is submitted up front so the pruned segments'
                # spans overlap the exhaustive segments' device time
                half = max(1, P // 2)
                segs, pos = [], 0
                for r_i in range(2):
                    for seg_prune in (False, True):
                        n = half if r_i == 0 else P - half
                        if n > 0:
                            segs.append((seg_prune, range(pos, pos + n)))
                            pos += n
                seg_futs = [(sp, idxs, [submit(i, sp) for i in idxs]) for sp, idxs in segs]
                probe_out, t_by = [], {False: [], True: []}
                for seg_prune, idxs, futs in seg_futs:
                    out, t = run_segment(idxs, futs)
                    t_by[seg_prune].append(t / len(idxs))
                    probe_out.extend(out)
                t_e = min(t_by[False])
                t_p = min(t_by[True])
                # clear margin -> sticky and persisted; within noise -> the
                # settled prior, else exhaustive (tie recorded); >3x ratio ->
                # anomalous, serve the prior (or this stream's winner), record nothing
                self.last_stream_probe = (t_p, t_e)
                ratio = max(t_p, t_e) / max(1e-9, min(t_p, t_e))
                m = self.PRUNE_PROBE_MARGIN
                if ratio >= 3.0:
                    effective = prior if prior is not None else (t_p < t_e)
                    label = "anomalous ratio, this stream only"
                elif t_p < (1.0 - m) * t_e:
                    effective, label = True, "PRUNING ON"
                    self._prune_stream_effective[key] = True
                    self._record_verdict("stream", key, True)
                elif t_e < (1.0 - m) * t_p:
                    effective, label = False, "exhaustive"
                    self._prune_stream_effective[key] = False
                    self._record_verdict("stream", key, False)
                elif prior is not None:
                    effective, label = prior, "within noise, keeping settled verdict"
                else:
                    effective, label = False, "exhaustive (within noise)"
                    self._prune_stream_effective[key] = False
                    self._record_verdict("stream", key, tie=True)
                logger.info("pruned-stream A/B probe (%d batches/mode, interleaved rounds, "
                            "min/batch): pruned %.1f ms vs exhaustive %.1f ms -> %s",
                            P, t_p * 1e3, t_e * 1e3, label)
                for r in probe_out:
                    yield r
                start, do_prune = 2 * P, effective
            else:
                start, do_prune = 0, use_pruned

            if explore_record:
                # stream-level exploration: run the WHOLE stream in the planned
                # mode, pipelined like steady state but with eager fetches so the
                # wall (first dispatch -> last fetch) is a true mode cost
                warm(do_prune)
                out, t = run_segment(range(start, len(batches)),
                                     [submit(i, do_prune) for i in range(start, len(batches))])
                n = max(1, len(batches) - start)
                self._stream_level_record(key, do_prune, t / n)
                for r in out:
                    yield r
                return

            # steady state: bounded look-ahead of host prep, windowed dispatch
            ahead = max(2 * window, 4)
            futs = deque()
            nexti = start
            buf = deque()
            for i in range(start, len(batches)):
                while nexti < len(batches) and len(futs) < ahead:
                    futs.append(submit(nexti, do_prune))
                    nexti += 1
                buf.append(dispatch(i, futs.popleft()))
                if len(buf) > window:
                    yield buf.popleft()
            while buf:
                yield buf.popleft()

        return gen()

    def search_pruned_stream(self, batches, model="bm25", params=None, topk=1000,
                             window=4, adaptive=True, **kw):
        """Pipelined exact block-max pruned search: search_stream with
        ``pruned=True`` (see there for the adaptive semantics); the rank task's
        BM25 entry point (searcher/tpu.py)."""
        return self.search_stream(batches, model=model, params=params, topk=topk,
                                  window=window, pruned=True, adaptive=adaptive, **kw)

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
        score_dtype: str = "float32",
        pack_ords: bool = False,
        max_postings_per_term: int = 0,
        prune_theta=None,
        prune_spans=None,
        _prebuilt=None,
    ):
        """Score a batch of queries; returns (scores, doc_ords) numpy arrays.

        Without ``grid``: shapes [Q, topk]. With ``grid`` (param -> list of values):
        shapes [len(v1), ..., len(vk), Q, topk] with axes ordered by sorted param name.

        ``exact_topk`` None takes the exact path for corpora of at most
        EXACT_MAX_DOCS docs and the tiered path above (``exact_path``).
        ``max_postings_per_term`` > 0 enables impact-ordered early termination:
        only each term's top-N highest-impact postings are scored (ties at the
        N-th impact included). APPROXIMATE: returned scores are partial sums.
        ``prune_theta`` ([Q] f32 from compute_theta()) or ``prune_spans``
        enables EXACT block-max pruning (bit-identical results); requires
        supports_pruning(). ``score_dtype="bfloat16"`` returns bf16 scores
        widened to f32; ``pack_ords`` moves ordinals at ord_pack_bits(N) bits.

        With ``materialize=False`` the tiered path returns a TieredResult whose
        ``.get()`` yields the same arrays (its fetch already started), and the
        exact path returns the device tensors.
        """
        if model not in SCORING_MODELS:
            raise ValueError(f"unknown scoring model {model!r}; known: {sorted(SCORING_MODELS)}")
        params = dict(params or {})
        grid = dict(grid or {})
        num_queries = len(term_lists)
        topk = min(topk, self.dindex.num_docs)
        max_postings = int(max_postings_per_term or 0)
        if model not in _NORM_DL_MODELS:
            # the lazy QL/DFR payload, materialized on this thread
            _ = self.dindex.exact_dl_tiles_np if self.dindex.streaming else self.dindex.exact_dl_tiles
        if prune_theta is not None or prune_spans is not None:
            if not self.supports_pruning(model, grid, max_postings):
                raise ValueError("block-max pruning requires model=bm25, no grid, no "
                                 "maxpostings cap, and an index with prune tables")
            if prune_theta is not None and len(prune_theta) != num_queries:
                raise ValueError(f"prune_theta has {len(prune_theta)} entries for {num_queries} queries")
            exact_topk = False  # pruning rides the tiered span path
        if _prebuilt is not None:  # search_stream prepared the tiered units
            exact_topk = False
        exact = self.exact_path(exact_topk, max_postings)

        param_axes = tuple(sorted(grid))
        grid_shape = tuple(len(grid[k]) for k in param_axes)
        points = grid_points(grid) if param_axes else {}

        if exact:
            scores, ords = self.search_points(term_lists, model=model, params=params, points=points,
                                              topk=topk, materialize=False)
            out_shape = grid_shape + tuple(scores.shape[1:])
            scores, ords = scores.reshape(out_shape), ords.reshape(out_shape)
            scores = scores.to(getattr(torch, str(score_dtype)))
            if not materialize:
                return scores, ords
            return _host_scores(scores.cpu()), ords.cpu().numpy()

        if num_queries == 0:
            # an empty batch builds zero tiers: honour the tiered contract with
            # ready empty arrays
            shape = grid_shape + (0, topk)
            empty = (np.zeros(shape, np.float32), np.zeros(shape, np.int32))
            return empty if materialize else _ReadyResult(empty)

        # ordinal transfer compression; >= 2^24 docs would need wider packing
        # than the 24-bit cap, so those corpora fall back to raw int32
        ord_bits = ord_pack_bits(self.dindex.num_docs) if pack_ords and self.dindex.num_docs < (1 << 24) else 0
        if _prebuilt is not None:
            packed, tiers, u0s, inv_order, r_max, stream_buffers = _prebuilt
        else:
            spans = prune_spans
            if spans is None and prune_theta is not None:
                spans = self._spans_pruned(term_lists, model, params, prune_theta)
            packed, tiers, u0s, inv_order, r_max, stream_buffers = self._prepare_tiered(
                term_lists, model, max_postings, spans=spans)
        tier_shapes = tuple((uw, qt_pad) for uw, qt_pad, _, _ in tiers)
        d = self.dindex
        if stream_buffers is not None:
            buffers = self._upload_working_set(stream_buffers)
        else:
            buffers = (d.doc_tiles, d.tf_tiles, d.norm_dl_tiles if model in _NORM_DL_MODELS else d.exact_dl_tiles)
        # original query position -> its padded-concat tier row (the device
        # gathers these rows before the transfer)
        pad_bases = np.cumsum([0] + [qt_pad for _, qt_pad, _, _ in tiers])
        row_of_sorted = np.zeros(max(num_queries, 1), np.int32)
        for ti, (_, _, qt, qbase) in enumerate(tiers):
            row_of_sorted[qbase:qbase + qt] = pad_bases[ti] + np.arange(qt, dtype=np.int32)
        out_index = row_of_sorted[inv_order]
        q_pad = _bucket(max(num_queries, 1), minimum=4)
        if q_pad > len(out_index):  # pad rows are trimmed by TieredResult.get
            out_index = np.concatenate([out_index, np.zeros(q_pad - len(out_index), np.int32)])
        dev_params, _ = self._device_params(params, points)
        dev = d.device
        scores_out, ords_out = self._score_tiered(
            model, topk, r_max, tier_shapes, str(score_dtype), ord_bits,
            _upload(packed, dev), [int(u) for u in u0s], _upload(out_index, dev).long(), dev_params, *buffers)
        scores_out = scores_out.reshape(grid_shape + tuple(scores_out.shape[1:]))
        ords_out = ords_out.reshape(grid_shape + tuple(ords_out.shape[1:]))
        result = TieredResult(scores_out, ords_out, num_queries, topk, grid_shape, ord_bits)
        if not materialize:
            return result
        return result.get()

    def search_points(
        self,
        term_lists: Sequence[Sequence[Tuple[int, float]]],
        model: str = "bm25",
        params: Dict[str, float] = None,
        points: Dict[str, np.ndarray] = None,
        topk: int = 1000,
        materialize: bool = True,
    ):
        """The exact path over G written-out grid points: ``points`` maps each grid
        parameter to a 1-D array of G values (``grid_points`` writes a grid out
        row-major over sorted names, as the JAX engine's nested vmaps order
        it); shapes [G, Q, topk], G = 1 without ``points``. A caller may score
        any subset of a grid's points or queries in one call: every (grid
        point, query) row is computed on its own."""
        if model not in SCORING_MODELS:
            raise ValueError(f"unknown scoring model {model!r}; known: {sorted(SCORING_MODELS)}")
        if self.dindex.streaming:
            raise ValueError("the exact path needs the resident index; a streaming index takes search()")
        params = dict(params or {})
        points = dict(points or {})
        num_queries = len(term_lists)
        topk = min(topk, self.dindex.num_docs)
        self._check_accumulator_bounds(num_queries)
        dev_params, _ = self._device_params(params, points)
        units = self._build_work_units(term_lists, model)
        scores, ords = self._score_exact(model, num_queries, topk, units, dev_params)
        if not materialize:
            return scores, ords
        return scores.cpu().numpy(), ords.cpu().numpy()

    def search_fused(self, term_list_batches, model="bm25", params=None, topk=1000, score_dtype="float32"):
        """Score S equally-sized query batches with pipelined dispatch on the
        tiered path. Returns (scores [S, Q, topk], doc_ords [S, Q, topk]) numpy."""
        num_queries = len(term_list_batches[0])
        if not all(len(b) == num_queries for b in term_list_batches):
            raise ValueError("search_fused takes batches of one size")
        pending = [self.search(b, model=model, params=params, topk=topk, materialize=False,
                               score_dtype=score_dtype, exact_topk=False)
                   for b in term_list_batches]
        results = [p.get() for p in pending]
        scores = np.stack([np.asarray(s) for s, _ in results])
        ords = np.stack([np.asarray(o) for _, o in results])
        return scores, ords


def grid_points(grid: Dict[str, Sequence[float]]) -> Dict[str, np.ndarray]:
    """A parameter grid written out as G points, f32, row-major over the sorted
    parameter names: point i is the i-th combination of
    ``itertools.product(*[grid[k] for k in sorted(grid)])``."""
    param_axes = tuple(sorted(grid))
    mesh = np.meshgrid(*[np.asarray(grid[k], dtype=np.float32) for k in param_axes], indexing="ij")
    return {k: values.reshape(-1) for k, values in zip(param_axes, mesh)}
