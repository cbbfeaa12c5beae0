"""Batch collation (``ARRAY_KEYS`` and ``collate`` of the JAX package's
``trainer/jax_trainer.py``)."""

from __future__ import annotations

import numpy as np

ARRAY_KEYS = (
    "query", "query_idf", "posdoc", "negdoc", "label", "idfs",
    "pos_bert_input", "pos_mask", "pos_seg", "neg_bert_input", "neg_mask", "neg_seg",
    "history", "doctf", "query_char", "doc_char", "teacher_margin",
)


def collate(samples, keys=None):
    """Stack a list of extractor sample dicts into batched numpy arrays."""
    out = {}
    for key in samples[0]:
        if keys is not None and key not in keys:
            continue
        values = [s[key] for s in samples]
        if isinstance(values[0], np.ndarray) or np.isscalar(values[0]):
            out[key] = np.stack(values)
        else:
            out[key] = values  # strings (qid/docid) stay as lists
    return out
