"""The reference of monoBERT-MaxP reranking at int8 (``reference/plain.py``):
BM25's top ``topn`` for each query, bertpassage features, and every
candidate's MaxP score from the int8 encoder, calibrated on the first
request the service saw (the warm-up query).

The controls, each put in the program's place for the same queries:
``int4``, the same reference with ``levels`` 7; ``tf32``, the reference at
int8 with its f32 products (attention's two, the pooler and the classifier)
at TF32, the nearest step below the configuration's f32 with TF32 off."""

from __future__ import annotations

import numpy as np
import torch

from lib import registry, weights

plain = registry.load_module("reference", "plain")

TIE = 1e-5  # relative: a first-stage candidate at the cut may trade places with one this close (f32 against f64)


class Reference:
    def __init__(self, inputs, config, device, levels=127, products=None):
        plain.no_tf32()
        self.config, self.device = config, torch.device(device)
        self.docs = inputs["docs"]
        self.bm25 = plain.BM25(self.docs)
        model = inputs["model"]
        self.w = weights.seeded_weights(weights.bert_leaves(model, "classifier"), inputs["seed"], self.device)
        self.bert = plain.Bert(model, self.w, levels=levels, products=products)
        self.scores(inputs["warm"][0], calibrate=True)

    def candidates(self, query):
        """Ordinals of the top ``topn`` by BM25, and of any doc within ``TIE`` of the cut."""
        s = self.bm25.scores(query)
        order = np.lexsort((np.arange(len(s)), -s))
        topn = self.config["topn"]
        cut = s[order[topn - 1]] if len(order) >= topn else 0.0
        band = order[topn:][s[order[topn:]] >= cut * (1 - TIE)]
        return [int(o) for o in order[:topn] if s[o] > 0], [int(o) for o in band if s[o] > 0]

    def scores(self, query, calibrate=False):
        """({docid: score} of the candidates and the band, [docid] of the top
        ``topn`` in BM25 order)."""
        top, band = self.candidates(query)
        ords = top + band
        ids, mask, seg = (t.to(self.device) for t in plain.passage_inputs(
            query, [self.docs[o][1] for o in ords], self.config["extractor"]))
        with torch.no_grad():
            s = plain.maxp_scores(self.bert, self.w, ids, mask, seg, calibrate=calibrate).cpu().numpy()
        return {self.docs[o][0]: float(x) for o, x in zip(ords, s)}, [self.docs[o][0] for o in top]

    def answer(self, query, k):
        """The top k [(docid, score)] of the reference at its precision."""
        scored, top = self.scores(query)
        ranked = sorted(((d, scored[d]) for d in top), key=lambda kv: -kv[1])
        return ranked[:k]


def compare(ref, queries, served, k):
    """The number compared, ``gap``, over every query of the sample: the
    larger of the widest |served score - reference score| of a served doc and
    the widest amount by which a served doc's reference score lies below the
    reference's k-th best; inf for a served doc outside the reference's
    candidates (the first stage), a list shorter than the reference's, or a
    query left unanswered."""
    score_gap = rank_gap = 0.0
    if len(served) != len(queries):
        rank_gap = float("inf")  # a query left unanswered
    for query, hits in zip(queries, served):
        scored, top = ref.scores(query)
        kth = sorted((scored[d] for d in top), reverse=True)[:k][-1]
        if len(hits) < min(k, len(top)):
            rank_gap = float("inf")
        for docid, s in hits:
            if docid not in scored:
                rank_gap = float("inf")
                continue
            score_gap = max(score_gap, abs(s - scored[docid]))
            rank_gap = max(rank_gap, kth - scored[docid])
    return {"gap": max(score_gap, rank_gap)}


def check(inputs, config, mix, records, device):
    """The numbers of a run: the sampled requests' served answers against the reference at int8."""
    ref = Reference(inputs, config, device)
    queries = [q for r in records for q in r["payload"]]
    served = [h for r in records for h in r["answers"]["hits"]]
    return compare(ref, queries, served, mix["k"])


def control(**low_kw):
    """A control: the reference with ``low_kw`` put in the program's place."""

    def read(inputs, config, mix, records, device):
        ref = Reference(inputs, config, device)
        low = Reference(inputs, config, device, **low_kw)
        queries = [q for r in records for q in r["payload"]]
        return compare(ref, queries, [low.answer(q, mix["k"]) for q in queries], mix["k"])

    return read


CONTROLS = {"int4": control(levels=7), "tf32": control(products=plain.tf32)}
