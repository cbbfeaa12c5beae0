"""Doc-id reordering for posting locality (recursive graph bisection); a copy
of the JAX package's ``index/reorder.py``.

Block-max pruning skips (term, doc-range) spans whose score bound is below the
top-k threshold; how much it can skip depends entirely on doc-id locality —
postings of a term concentrated in few ranges give sharp bounds, scattered
postings give none. Real corpora have exploitable structure, and the standard
way to surface it is docid reordering by recursive graph bisection
(Dhulipala et al. 2016, "Compressing Graphs and Indexes with Recursive Graph
Bisection"): repeatedly split the doc set in half and greedily swap docs
between halves to minimize the expected posting-gap code length

    cost(t) = n1*log2(L1/(n1+1)) + n2*log2(L2/(n2+1))

summed over terms, where n1/n2 are t's posting counts in the two halves. The
same objective that compresses delta-coded postings concentrates them in doc-id
space, which is exactly what range bounds need.

This is a from-scratch vectorized numpy implementation (the reference has no
equivalent — Lucene keeps indexing order; Anserini relies on collection order).
Opt-in via ``index.docreorder=bp``. External docids and scores are unchanged;
only internal ordinals (and therefore score-tie order, a Lucene-like
indexing-order artifact) move.
"""

from __future__ import annotations

import numpy as np

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def _range_concat(starts, lengths):
    """Concatenate ranges [starts[i], starts[i]+lengths[i]) without a Python loop."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    group_start = np.cumsum(lengths) - lengths
    within = np.arange(total, dtype=np.int64) - np.repeat(group_start, lengths)
    return np.repeat(starts, lengths) + within


def bp_reorder(term_ids, doc_ords, num_docs, min_partition=32, iters=12, seed=0):
    """Returns an old->new ordinal permutation [num_docs] int64."""
    order = np.argsort(doc_ords, kind="stable")
    p_term = np.asarray(term_ids, np.int64)[order]
    p_doc = np.asarray(doc_ords, np.int64)[order]
    doc_start = np.searchsorted(p_doc, np.arange(num_docs + 1)).astype(np.int64)
    doc_len = np.diff(doc_start)

    result = np.empty(num_docs, dtype=np.int64)
    counter = [0]
    rng = np.random.RandomState(seed)
    stack = [np.arange(num_docs, dtype=np.int64)]

    while stack:
        docs = stack.pop()
        n = len(docs)
        if n <= min_partition:
            result[docs] = counter[0] + np.arange(n)
            counter[0] += n
            continue

        # local posting view: (term, local doc index), grouped by doc
        lens = doc_len[docs]
        post_idx = _range_concat(doc_start[docs], lens)
        lt_global = p_term[post_idx]
        uniq, lt = np.unique(lt_global, return_inverse=True)
        ldoc = np.repeat(np.arange(n, dtype=np.int64), lens)
        bounds = np.concatenate([[0], np.cumsum(lens)])

        half = n // 2
        l1, l2 = float(half), float(n - half)
        side = np.zeros(n, np.int8)
        side[half:] = 1

        def cost_term(a, b):
            return a * np.log2(l1 / (a + 1.0)) + b * np.log2(l2 / (b + 1.0))

        for _ in range(iters):
            pside = side[ldoc]
            n1 = np.bincount(lt[pside == 0], minlength=len(uniq)).astype(np.float64)
            n2 = np.bincount(lt[pside == 1], minlength=len(uniq)).astype(np.float64)
            base = cost_term(n1, n2)
            with np.errstate(divide="ignore", invalid="ignore"):
                # the n-1 variants are only ever GATHERED for postings on that
                # side (where the count is >= 1); the inf lanes are discarded
                g_to2 = base - cost_term(n1 - 1.0, n2 + 1.0)  # move one posting 1->2
                g_to1 = base - cost_term(n1 + 1.0, n2 - 1.0)
            if len(per_post := np.where(pside == 0, g_to2[lt], g_to1[lt])):
                gains = np.add.reduceat(per_post, np.minimum(bounds[:-1], len(per_post) - 1))
            else:
                gains = np.zeros(n)
            gains[lens == 0] = 0.0  # clipped/duplicate reduceat slots

            d0 = np.flatnonzero(side == 0)
            d1 = np.flatnonzero(side == 1)
            o0 = d0[np.argsort(-gains[d0], kind="stable")]
            o1 = d1[np.argsort(-gains[d1], kind="stable")]
            m = min(len(o0), len(o1))
            pair_gain = gains[o0[:m]] + gains[o1[:m]]
            k = int(np.searchsorted(-pair_gain, 0.0))  # pair gains descending; keep > 0
            if k == 0:
                break
            side[o0[:k]] = 1
            side[o1[:k]] = 0

        left = docs[side == 0]
        right = docs[side == 1]
        if len(left) == 0 or len(right) == 0:  # degenerate: fall back to a split
            rng.shuffle(docs)
            left, right = docs[:half], docs[half:]
        # LIFO stack: push right first so left gets the lower ordinals
        stack.append(right)
        stack.append(left)

    return result
