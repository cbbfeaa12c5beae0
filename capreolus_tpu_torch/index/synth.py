"""Synthetic corpus builders for benchmarks and scale experiments (a copy of
the JAX package's ``index/synth.py`` over the port's index layout).

One shared implementation of the raw-pairs -> canonical-layout-IndexData recipe
(dedup to tfs, canonical range-major sort, CSR offsets, SmallFloat doclens,
block-max prune tables, npz cache) so ``chip_smoke.py`` and the tests
cannot drift from index/tpu.py's CURRENT postings layout: the npz cache name
embeds LAYOUT_VERSION, so a layout bump automatically invalidates every cached
synthetic corpus instead of silently benchmarking a stale layout.

The corpora are synthetic because the environment has no network access; term
statistics are Zipfian, sized like mid-size TREC collections.
"""

from __future__ import annotations

import os

import numpy as np


def _versioned(cache_fn: str) -> str:
    from capreolus_tpu_torch.index.tpu import LAYOUT_VERSION

    base, ext = os.path.splitext(cache_fn)
    return f"{base}_L{LAYOUT_VERSION}{ext or '.npz'}"


def load_index_npz(cache_fn: str):
    """Load a cached synthetic IndexData, or None when absent/stale."""
    from capreolus_tpu_torch.index.tpu import IndexData

    fn = _versioned(cache_fn)
    if not os.path.exists(fn):
        return None
    z = np.load(fn)
    idx = IndexData(term_offsets=z["term_offsets"], doc_ids=z["doc_ids"], tfs=z["tfs"],
                    doclens=z["doclens"], norm_doclens=z["norm_doclens"],
                    docid_strings=None, vocab=None,
                    prune_tables={k[3:]: z[k] for k in z.files if k.startswith("pt_")})
    # settled pruning A/B verdicts live next to the corpus cache so fresh
    # processes (e.g. successive benchmark runs) skip re-probing
    idx.verdict_path = fn + ".verdicts.json"
    return idx


def assemble_index(term_ids, doc_ords, rng, num_docs: int, num_terms: int,
                   tf_cap: int = 64, cache_fn: str | None = None):
    """Raw (term, doc) pair streams (duplicates allowed) -> IndexData in the
    canonical range-major layout with block-max tables; optionally cached."""
    key = np.asarray(term_ids, np.int64) * num_docs + np.asarray(doc_ords, np.int64)
    return assemble_index_from_key(key, rng, num_docs, num_terms, tf_cap=tf_cap,
                                   cache_fn=cache_fn)


def assemble_index_from_key(key, rng, num_docs: int, num_terms: int,
                            tf_cap: int = 64, cache_fn: str | None = None):
    """Like assemble_index but takes the packed int64 (term * num_docs + doc)
    key array directly — billion-posting callers pack the key themselves and
    drop their raw pair arrays first so peak host RAM stays bounded (the
    assembly itself is int32-lean after the dedup)."""
    from capreolus_tpu_torch.index.smallfloat import quantize_lengths
    from capreolus_tpu_torch.index.tpu import IndexData, build_prune_tables, canonical_postings_order

    key, counts = np.unique(key, return_counts=True)
    term_ids = (key // num_docs).astype(np.int32)
    doc_ords = (key % num_docs).astype(np.int32)
    del key
    tfs = np.minimum(counts + rng.integers(0, 3, size=len(counts)), tf_cap).astype(np.int32)
    del counts

    order, range_size = canonical_postings_order(term_ids, doc_ords, tfs, num_docs)
    term_ids, doc_ords, tfs = term_ids[order], doc_ords[order], tfs[order]
    del order
    offsets = np.zeros(num_terms + 1, dtype=np.int64)
    np.cumsum(np.bincount(term_ids, minlength=num_terms), out=offsets[1:])
    doclens = np.maximum(np.bincount(doc_ords, weights=tfs, minlength=num_docs), 1).astype(np.int32)
    norm = quantize_lengths(doclens).astype(np.int32)
    pt = build_prune_tables(offsets, doc_ords.astype(np.int32), tfs.astype(np.int32),
                            norm, num_docs, range_size=range_size)
    if cache_fn is not None:
        os.makedirs(os.path.dirname(_versioned(cache_fn)) or ".", exist_ok=True)
        np.savez(_versioned(cache_fn), term_offsets=offsets, doc_ids=doc_ords.astype(np.int32),
                 tfs=tfs.astype(np.int32), doclens=doclens, norm_doclens=norm,
                 **{f"pt_{k}": v for k, v in pt.items()})
    idx = IndexData(term_offsets=offsets, doc_ids=doc_ords.astype(np.int32),
                    tfs=tfs.astype(np.int32), doclens=doclens, norm_doclens=norm,
                    docid_strings=None, vocab=None, prune_tables=pt)
    if cache_fn is not None:
        idx.verdict_path = _versioned(cache_fn) + ".verdicts.json"
    return idx


def synth_uniform_index(num_docs: int, num_terms: int, avg_unique: int, seed: int = 0,
                        cache_fn: str | None = None):
    """Zipfian terms assigned to uniformly random doc ids — the provable worst
    case for block-max pruning (no doc-id locality); the headline bench corpus."""
    cached = load_index_npz(cache_fn) if cache_fn else None
    if cached is not None:
        return cached
    rng = np.random.Generator(np.random.PCG64(seed))
    nnz = num_docs * avg_unique
    z = rng.zipf(1.3, size=nnz * 2)
    z = z[z <= num_terms][:nnz]
    key = (z - 1).astype(np.int64) * num_docs
    del z
    key += rng.integers(0, num_docs, size=len(key))
    return assemble_index_from_key(key, rng, num_docs, num_terms, cache_fn=cache_fn)


def synth_clustered_index(num_docs: int, num_terms: int, avg_unique: int, seed: int = 2,
                          n_topics: int = 400, topic_vocab_size: int = 600,
                          cache_fn: str | None = None):
    """Topically-clustered corpus: docs belong to topics and draw ~70% of their
    terms from a topic vocabulary, doc ids sorted by topic — the doc-id locality
    real TREC corpora have (and BP docid reordering recovers), which block-max
    pruning exploits."""
    cached = load_index_npz(cache_fn) if cache_fn else None
    if cached is not None:
        return cached
    rng = np.random.Generator(np.random.PCG64(seed))
    topic_vocab = rng.integers(0, num_terms, size=(n_topics, topic_vocab_size))
    topic_of_doc = np.sort(rng.integers(0, n_topics, size=num_docs))  # ids sorted by topic
    n_local = int(avg_unique * 0.7)
    local = topic_vocab[topic_of_doc[:, None],
                        rng.integers(0, topic_vocab_size, size=(num_docs, n_local))].astype(np.int32)
    n_glob = avg_unique - n_local
    z = rng.zipf(1.3, size=num_docs * n_glob * 2)
    z = (z[z <= num_terms][: num_docs * n_glob].reshape(num_docs, n_glob) - 1).astype(np.int32)
    term_ids = np.concatenate([local, z], axis=1).reshape(-1)
    del local, z
    # pack the dedup key directly (int32 pairs never materialize twice): doc
    # ordinal d with avg_unique terms per doc occupies a contiguous run, so the
    # doc component is the run index
    key = term_ids.astype(np.int64) * num_docs
    del term_ids
    key += np.repeat(np.arange(num_docs, dtype=np.int64), avg_unique)
    return assemble_index_from_key(key, rng, num_docs, num_terms, cache_fn=cache_fn)
