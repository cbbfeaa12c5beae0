"""Training batches of (query, positive, negative) triples made from the seed,
laid out as bertpassage lays out one passage of a document for training:
``[CLS] query [SEP] passage [SEP]`` then pads, with its mask and segment ids
(0 through the first [SEP], 1 after it through the last), each side [1,
batch, maxseqlen] (one accumulation step) as the trainer's producer hands
them over.

Every step of every seed holds the same multiset of query and sequence
lengths, in a seeded order, so every step asks for the same work; token ids
are uniform over the configuration's vocabulary range. Step ``i`` of a seed
is the same whoever makes it."""

from __future__ import annotations

import numpy as np

from lib.corpus import rng_of, spread

CLS, SEP = 101, 102


def batch(spec, seed, step, size, maxseqlen):
    """The step's batch: {"pos_bert_input", "pos_mask", "pos_seg",
    "neg_bert_input", "neg_mask", "neg_seg"}, int64 [1, size, maxseqlen]."""
    rng = rng_of(seed, f"triples.{step}")
    q_lens = rng.permutation(spread(*spec["query_tokens"], size))
    lo, hi = spec["vocab"]
    out = {}
    queries = [rng.integers(lo, hi, int(n)) for n in q_lens]
    for side in ("pos", "neg"):
        seq_lens = rng.permutation(spread(*spec["seq_len"], size))
        ids = np.zeros((size, maxseqlen), np.int64)
        mask = np.zeros((size, maxseqlen), np.int64)
        seg = np.zeros((size, maxseqlen), np.int64)
        for r, (q, n) in enumerate(zip(queries, seq_lens)):
            n = int(n)
            head = np.concatenate([[CLS], q, [SEP]])
            body = rng.integers(lo, hi, n - len(head) - 1)
            ids[r, :n] = np.concatenate([head, body, [SEP]])
            mask[r, :n] = 1
            seg[r, len(head):n] = 1
        out.update({f"{side}_bert_input": ids[None], f"{side}_mask": mask[None], f"{side}_seg": seg[None]})
    return out
