"""Shared running-top-k merge for host-streaming corpora (the JAX package's
``searcher/streamed.py``).

One implementation of the fixed-shape upload loop and the running top-k
merge, so that the pad invariant lives in one place: rows past the corpus end
are masked to -inf BEFORE the chunk's own top-k (a zero pad row scores 0,
which beats real negative cosines, and would evict real documents of a
partial last chunk). Selection keeps ties in ascending ordinal, as
``jax.lax.top_k`` does: within a chunk by ordinal, and in the merge the
running list comes before the chunk, whose ordinals are all larger.
"""

from __future__ import annotations

import numpy as np
import torch


def topk_lower_ordinal_first(scores, k):
    """(values, indices) of the ``k`` largest scores per row, ties to the lower
    index, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no tie
    order on CUDA; a stable descending sort does)."""
    values, indices = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def streamed_topk(make_chunk, score_chunk, n, upload, hits):
    """Build a ``topk(q_emb, *ignored) -> ([Q, hits] f32 scores, [Q, hits]
    int64 global ordinals)`` over a host-resident corpus of ``n`` rows.

    ``make_chunk(start)`` uploads rows [start, start+upload) padded to the
    fixed shape; ``score_chunk(q_emb, chunk)`` returns [Q, upload] scores.
    The copy of chunk i+1 is queued behind the scoring of chunk i on the query's stream."""
    local_k = min(hits, upload)

    def merge_step(q_emb, chunk, base, run_s, run_o):
        scores = score_chunk(q_emb, chunk).float()
        # THE pad invariant: mask out-of-range rows before selection
        cols = torch.arange(scores.shape[1], device=scores.device)[None, :]
        scores = torch.where(cols + base < n, scores, float("-inf"))
        s, o = topk_lower_ordinal_first(scores, local_k)
        o = o + base
        cs = torch.cat([run_s, s], dim=1)
        co = torch.cat([run_o, o], dim=1)
        ms, idx = topk_lower_ordinal_first(cs, hits)
        return ms, torch.gather(co, 1, idx)

    def topk(q_emb, *_ignored):
        nq = q_emb.shape[0]
        run_s = torch.full((nq, hits), float("-inf"), dtype=torch.float32, device=q_emb.device)
        run_o = torch.zeros((nq, hits), dtype=torch.int64, device=q_emb.device)
        for start in range(0, n, upload):
            run_s, run_o = merge_step(q_emb, make_chunk(start), start, run_s, run_o)
        return run_s, run_o

    return topk


def pad_rows(arr, rows, fill=0):
    """Pad a leading-axis slice up to ``rows`` with ``fill`` (fixed shapes)."""
    if arr.shape[0] >= rows:
        return arr
    pad = np.full((rows - arr.shape[0], *arr.shape[1:]), fill, arr.dtype)
    return np.concatenate([arr, pad])
