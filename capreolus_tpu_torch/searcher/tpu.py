"""Helpers of the JAX package's ``searcher/tpu.py``. Only the topics reader is
ported so far, for the late-interaction searcher; the ``TpuSearcherMixin``
search loop and the BM25 family of searchers come with the rank task (ROADMAP
item 4)."""

from __future__ import annotations


def _load_topics_tsv(topicsfn):
    """[(qid, text)] from a ``qid<TAB>query`` file, skipping blank lines."""
    topics = []
    with open(topicsfn, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                qid, text = line.rstrip("\n").split("\t", 1)
                topics.append((qid, text))
    return topics
