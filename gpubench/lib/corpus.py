"""Seeded text: a Robust04-shaped corpus and its topics, and short query
texts. The recipe is ``chip_smoke.py``'s (``_word``, ``build_corpus`` and
``robust04_shaped_corpus``): synthetic consonant-vowel words, Zipfian (s 1.1)
background draws over a vocabulary of ``vocab`` words, documents of
``min_len``-``max_len`` words. Every topic's title words sit at vocabulary
ranks ``title_ranks`` (each such word occurs in a few percent of the
documents, so every topic has ``topn`` first-stage candidates).

Each seed draws the same set of sizes (document lengths, title lengths) in
another order, so two seeds ask the system for the same amount of work."""

from __future__ import annotations

import os

import numpy as np

CONSONANTS = list("bdfgklmnprstvz")
VOWELS = list("aeiou")


def rng_of(seed, stream):
    """A numpy generator for one named stream of ``seed``: the streams of a
    seed are independent, and the same (seed, stream) gives the same draws."""
    words = [ord(c) for c in stream]
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *words])))


def vocabulary(rng, size, syllables=3):
    """``size`` distinct synthetic words of ``syllables`` consonant-vowel pairs."""
    vocab, seen = [], set()
    while len(vocab) < size:
        w = "".join(rng.choice(CONSONANTS) + rng.choice(VOWELS) for _ in range(syllables))
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def zipf_probs(n, s=1.1):
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


def spread(lo, hi, n):
    """``n`` whole numbers spread evenly over [lo, hi]: the sizes every seed shares."""
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def topics_and_docs(spec, seed):
    """(topics [str], docs [(docid, text)]) of the corpus ``spec`` (a
    configuration's ``corpus``: docs, min_len, max_len, vocab, topics,
    title_words [lo, hi], title_ranks [lo, hi])."""
    rng = rng_of(seed, "corpus")
    vocab = vocabulary(rng, spec["vocab"])
    vocab_arr = np.asarray(vocab)
    n_topics = spec["topics"]
    t_lo, t_hi = spec["title_words"]
    title_lens = rng.permutation(spread(t_lo, t_hi, n_topics))
    r_lo, r_hi = spec["title_ranks"]
    topics = [" ".join(vocab_arr[rng.choice(np.arange(r_lo, r_hi), size=int(k), replace=False)])
              for k in title_lens]
    n = spec["docs"]
    lengths = rng.permutation(spread(spec["min_len"], spec["max_len"], n))
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    draws = rng.choice(len(vocab), size=int(bounds[-1]), p=zipf_probs(len(vocab)))
    words = vocab_arr[draws]
    docs = [(f"RB{d:06d}", " ".join(words[bounds[d]:bounds[d + 1]])) for d in range(n)]
    return topics, docs


def write_trec(docs, directory, per_file=1000):
    """``docs`` as TREC files ``<DOC><DOCNO>..</DOCNO><TEXT>..</TEXT></DOC>`` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    for f0 in range(0, len(docs), per_file):
        parts = [f"<DOC>\n<DOCNO> {docid} </DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n"
                 for docid, text in docs[f0:f0 + per_file]]
        with open(os.path.join(directory, f"rb{f0 // per_file:04d}.trec"), "wt", encoding="ascii") as fh:
            fh.write("".join(parts))
    return directory


def query_pool(spec, seed):
    """``spec`` {"vocab", "words": [lo, hi], "pool"}: ``pool`` query texts whose
    lengths spread over [lo, hi] words, drawn Zipfian from a synthetic
    vocabulary. Made at set-up, so that drawing a request costs nothing."""
    rng = rng_of(seed, "queries")
    vocab = np.asarray(vocabulary(rng, spec["vocab"]))
    lo, hi = spec["words"]
    lens = rng.permutation(spread(lo, hi, spec["pool"]))
    probs = zipf_probs(len(vocab))
    return [" ".join(vocab[rng.choice(len(vocab), size=int(k), p=probs)]) for k in lens]


def cycle(pool, seed, stream):
    """An endless iterator over ``pool`` in seeded orders, one permutation after another."""
    rng = rng_of(seed, stream)
    while True:
        for i in rng.permutation(len(pool)):
            yield pool[i]
