"""Generation-aware derived caches for the embedding/impact searchers (a copy
of the JAX package's ``searcher/embedding_cache.py``).

Every derived cache (dense embedding matrices, ColBERT token tensors, raw
impact arrays) is generation-aware and incremental:

- cache filenames gain a ``_gen<N>`` suffix for generation N > 0 (generation 0
  keeps the legacy name, so existing caches stay valid);
- each cache writes a ``.docids`` sidecar naming the row order it was built
  over;
- building generation N first looks for the newest older-generation cache and
  REUSES the surviving documents' rows (a docid-keyed remap — deletions and
  reordering never re-encode anything), encoding only documents the previous
  cache has no row for. Merged results are identical to a from-scratch encode
  over the surviving corpus because the encoders are deterministic per
  document.

The port's index has no generations yet (ROADMAP.md item 9, ``refresh``): its
searchers name their caches through ``generation_path(base, 0)``, the legacy
name, and write the ``.docids`` sidecar, so that the incremental path finds
them when generations come.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def generation_path(base: Path, generation: int) -> Path:
    """Per-generation cache filename: the ``_gen<N>`` tag lands before the
    FIRST dotted suffix so multi-extension pairs (``x.emb.npy``/``x.mask.npy``)
    stay pairs. Generation 0 is the legacy (untagged) name."""
    base = Path(base)
    if generation == 0:
        return base
    root, dot, ext = base.name.partition(".")
    return base.with_name(f"{root}_gen{generation}{dot}{ext}")


def docids_path(cache_fn: Path) -> Path:
    return Path(str(cache_fn) + ".docids")


def write_docids(cache_fn: Path, docids) -> None:
    """Atomic sidecar write (the remap key for the NEXT generation)."""
    from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file

    try:
        with cached_file(docids_path(cache_fn), "wt") as f:
            f.write("\n".join(docids))
    except TargetFileExists:
        pass


def read_docids(cache_fn: Path):
    return docids_path(cache_fn).read_text(encoding="utf-8").splitlines()


def find_previous(base: Path, generation: int):
    """Newest older-generation cache that has its docids sidecar (without the
    sidecar there is no remap key and the caller re-encodes from scratch)."""
    for g in range(generation - 1, -1, -1):
        p = generation_path(base, g)
        if p.exists() and docids_path(p).exists():
            return p, g
    return None, None


def row_sources(old_docids, new_docids) -> np.ndarray:
    """[len(new_docids)] int64: for each new row, the old row it can be copied
    from, or -1 when the document must be encoded fresh."""
    old_pos = {d: i for i, d in enumerate(old_docids)}
    return np.fromiter((old_pos.get(d, -1) for d in new_docids),
                       dtype=np.int64, count=len(new_docids))


def identity_remap(src: np.ndarray, old_rows: int) -> bool:
    """True when the new corpus is row-for-row the old one (e.g. a doc-store
    compaction bumped the generation without changing documents) — the cache
    can be HARDLINKED instead of copied."""
    return len(src) == old_rows and not (src < 0).any() and \
        bool((src == np.arange(len(src))).all())


def link_identical(prev: Path, cache_fn: Path) -> None:
    """Hardlink (fallback: copy) an unchanged cache under the new generation's
    name: zero bytes for identity merges; unlinking either name later is safe
    (POSIX link counts; open mmaps keep their data)."""
    import shutil

    if Path(cache_fn).exists():
        return
    try:
        os.link(prev, cache_fn)
    except OSError:
        shutil.copy2(prev, cache_fn)


def prune_old_generations(base: Path, generation: int, keep: int = 1) -> None:
    """Delete generation-tagged cache files older than ``generation - keep``
    (sidecars, mask pairs, and derived int8/int4/ivf files share the root
    prefix and are caught by the same glob). The previous generation is kept
    so in-flight readers survive one refresh and the NEXT merge has a remap
    source — mirroring index/segments.py's deferred deletion policy. Without
    this, NRT serving with periodic merges writes one full corpus-sized cache
    copy per merge and never reclaims any."""
    base = Path(base)
    cutoff = generation - keep
    if cutoff <= 0:
        return
    root = base.name.partition(".")[0]
    for p in base.parent.glob(f"{root}*"):
        if not p.is_file():
            continue
        tail = p.name[len(root):]
        if tail.startswith("_gen"):
            g_str = tail[4:].split(".", 1)[0].split("_", 1)[0]
            try:
                g = int(g_str)
            except ValueError:
                continue
        else:
            g = 0  # the untagged legacy generation-0 family
        if g < cutoff:
            p.unlink(missing_ok=True)


def fill_kept_rows(out_arrays, old_arrays, src: np.ndarray, chunk: int = 4096) -> int:
    """Copy surviving documents' rows from the (memory-mapped) old caches into
    the new arrays, chunked so host copies stay bounded. ``src`` is
    row_sources(); rows with src < 0 are left for the encoder. Returns the
    number of reused rows."""
    kept_idx = np.flatnonzero(src >= 0)
    for start in range(0, len(kept_idx), chunk):
        rows = kept_idx[start:start + chunk]
        for out, old in zip(out_arrays, old_arrays):
            out[rows] = old[src[rows]]
    return len(kept_idx)
