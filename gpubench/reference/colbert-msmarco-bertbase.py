"""The reference of ColBERT retrieval over a bf16 corpus
(``reference/plain.py``): the f32 query encoder, MaxSim in f32 over the
corpus's f16 token embeddings rounded to bf16 (the precision the
configuration states for the corpus) with the queries rounded to bf16, and
each query's top ``k``. The corpus is made again from the seed
(``lib/tokens.py``) a token position and a block of docs at a time, and
MaxSim runs token-major over it: per block, the running max over token
positions of every query token's products, then the sum over query tokens
in f64.

The controls, each put in the program's place for the same queries:
``int8``, MaxSim with int8 codes (per query and per doc); ``tf32``, the
query encoder's f32 products at TF32 (the nearest step below the
configuration's f32 with TF32 off)."""

from __future__ import annotations

import torch

from lib import registry, weights
from lib.tokens import TokenCorpus, docid, ordinal

plain = registry.load_module("reference", "plain")


class Reference:
    def __init__(self, inputs, config, device, products=None, levels=None):
        plain.no_tf32()
        self.config, self.device, self.levels = config, torch.device(device), levels
        self.model = inputs["model"]
        self.w = weights.seeded_weights(weights.bert_leaves(self.model, "colbert"), inputs["seed"], self.device)
        self.bert = plain.Bert(self.model, self.w, products=products)
        spec, dim, ld = inputs["corpus"]
        self.corpus = TokenCorpus(spec, dim, ld, inputs["seed"], self.device)

    def queries(self, texts):
        ids = plain.colbert_query_ids(texts, self.config["searcher"]["maxqlen"]).to(self.device)
        with torch.no_grad():
            out = []
            for i in range(0, len(texts), 64):
                out.append(plain.colbert_queries(self.bert, self.w, ids[i:i + 64]))
        return torch.cat(out)

    def scores(self, texts):
        """[Q, N] f32 scores of the texts over the corpus, on the device. With
        ``levels`` (127: int8, 7: int4) the queries (per query) and the docs'
        f16 values (per doc) are integer codes, amax / levels, the products
        exact, dequantized by the two scales after the sum (as
        ``plain.maxsim_int``); else the queries and docs are rounded to bf16."""
        q = self.queries(texts)
        nq, lq, dim = q.shape
        levels = self.levels
        if levels:
            codes, qs = plain.quant_rows(q.reshape(nq, lq * dim), levels, 1e-30)
            q2 = codes.reshape(nq * lq, dim)
        else:
            q2 = q.to(torch.bfloat16).float().reshape(nq * lq, dim)
        c, out = self.corpus, []
        with torch.no_grad():
            for b in range(c.blocks):
                d0, d1 = c.docs_of(b)
                if levels:  # each doc's amax over its tokens, a first pass
                    amax = torch.stack([c.block(t, b).float().abs().amax(dim=1) for t in range(c.ld)]).amax(dim=0)
                    ds = plain.scale_of(amax.clamp_min(1e-30), levels)
                best = torch.full((nq * lq, d1 - d0), float("-inf"), device=self.device)
                for t in range(c.ld):
                    bias = torch.where(c.valid(t, b), 0.0, float("-inf"))[None]
                    if levels:
                        d = torch.round(c.block(t, b).float() / ds[:, None]).clamp_(-levels, levels)
                    else:
                        d = c.block(t, b).to(torch.bfloat16).float()
                    torch.maximum(best, torch.addmm(bias, q2, d.T), out=best)
                sums = best.view(nq, lq, -1).double().sum(dim=1)
                if levels:
                    sums = sums * qs.double() * ds.double()[None]
                out.append(sums.float())
        return torch.cat(out, dim=1)

    def answers(self, texts, k):
        """The top k [(docid, score)] of each text, ties to the lower ordinal."""
        s = self.scores(texts)
        values, order = torch.sort(s, dim=1, descending=True, stable=True)
        out = []
        for vals, ords in zip(values[:, :k].tolist(), order[:, :k].tolist()):
            out.append([(docid(o), v) for o, v in zip(ords, vals) if v != float("-inf")])
        return out


def compare(ref, texts, served, k):
    """The number compared, ``gap``: the larger of the widest |served score -
    reference score| of a served doc and the widest amount by which a served
    doc's reference score lies below the reference's k-th best; inf for a
    short list or a query left unanswered."""
    s = ref.scores(texts)
    finite = torch.isfinite(s)
    kth = torch.topk(torch.where(finite, s, float("-inf")), min(k, s.shape[1]), dim=1).values[:, -1].tolist()
    n_finite = finite.sum(dim=1).tolist()
    score_gap = rank_gap = 0.0
    if len(served) != len(texts):
        rank_gap = float("inf")  # a query left unanswered
    for i, hits in enumerate(served):
        if len(hits) < min(k, n_finite[i]):
            rank_gap = float("inf")
        if not hits:
            continue
        ords = torch.tensor([ordinal(d) for d, _ in hits], device=s.device)
        r = s[i, ords].tolist()
        for (_, score), ref_score in zip(hits, r):
            score_gap = max(score_gap, abs(score - ref_score))
            rank_gap = max(rank_gap, kth[i] - ref_score)
    return {"gap": max(score_gap, rank_gap)}


def sampled(records):
    return [q for r in records for q in r["payload"]], [h for r in records for h in r["answers"]["hits"]]


def check(inputs, config, mix, records, device):
    texts, served = sampled(records)
    return compare(Reference(inputs, config, device), texts, served, mix["k"])


def control(levels=None, products=None, served_levels=None):
    """A control: the reference at ``served_levels`` / ``products`` put in the
    program's place, compared against the reference at ``levels``."""

    def read(inputs, config, mix, records, device):
        texts, _ = sampled(records)
        low = Reference(inputs, config, device, products=products, levels=served_levels)
        served = low.answers(texts, mix["k"])
        del low
        return compare(Reference(inputs, config, device, levels=levels), texts, served, mix["k"])

    return read


CONTROLS = {"int8": control(served_levels=127), "tf32": control(products=plain.tf32)}
