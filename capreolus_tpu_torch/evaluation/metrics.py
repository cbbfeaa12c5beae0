"""trec_eval-compatible ranking metrics (a copy of the JAX package's
``evaluation/metrics.py``), in pure Python and numpy, with trec_eval's semantics:

- runs are ranked by score descending with ties broken by docid in *reverse*
  lexicographic order (trec_eval's documented tie-break)
- binary metrics (map, P_k, recall_k, recip_rank) treat docs with grade >=
  relevance_level as relevant; unjudged docs are non-relevant
- ndcg_cut uses graded gains rel/log2(rank+1) with the ideal ranking drawn from all
  judged docs; negative grades contribute zero gain
- queries with no relevant documents are excluded from the averages, and only
  queries present in both the run and the qrels are evaluated (trec_eval default);
  exception: judged_* is averaged over every run query present in qrels
- the metric strings: map, map_cut_k, Rprec, bpref, ndcg, ndcg_cut_k, P_k,
  recall_k, recip_rank, success_k, set_P, set_recall, set_F, judged_k

A vectorized numpy path evaluates batches of ranked lists; `eval_metrics` is the
per-query scalar reference used by tests.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence

import numpy as np

SUPPORTED_PREFIXES = ("P_", "ndcg_cut_", "recall_", "judged_", "map_cut_", "success_")


def rank_run(rundocs: Dict[str, float]) -> List[str]:
    """Order docids by trec_eval's sort: score desc, docid reverse-lexicographic."""
    return [d for d, _ in sorted(rundocs.items(), key=lambda kv: (-kv[1], _reversed_key(kv[0])))]


class _reversed_key(str):
    __slots__ = ()

    def __lt__(self, other):  # reverse lexicographic
        return str.__gt__(self, other)


def _relevant_set(qrels_q: Dict[str, int], relevance_level: int):
    return {d for d, g in qrels_q.items() if g >= relevance_level}


def query_metrics(ranked: Sequence[str], qrels_q: Dict[str, int], metrics: Sequence[str], relevance_level: int = 1):
    """Compute metrics for one query given an ordered docid list. Returns {metric: value}."""
    rel_set = _relevant_set(qrels_q, relevance_level)
    num_rel = len(rel_set)
    out = {}
    rel_flags = [1 if d in rel_set else 0 for d in ranked]

    for metric in metrics:
        if metric == "map":
            hits, ap = 0, 0.0
            for i, flag in enumerate(rel_flags, start=1):
                if flag:
                    hits += 1
                    ap += hits / i
            out[metric] = ap / num_rel if num_rel else 0.0
        elif metric == "recip_rank":
            rr = 0.0
            for i, flag in enumerate(rel_flags, start=1):
                if flag:
                    rr = 1.0 / i
                    break
            out[metric] = rr
        elif metric.startswith("P_"):
            k = int(metric.split("_")[1])
            out[metric] = sum(rel_flags[:k]) / k
        elif metric.startswith("recall_"):
            k = int(metric.split("_")[1])
            out[metric] = (sum(rel_flags[:k]) / num_rel) if num_rel else 0.0
        elif metric.startswith("ndcg_cut_"):
            k = int(metric.split("_")[2])
            gains = [max(0, qrels_q.get(d, 0)) for d in ranked[:k]]
            dcg = sum(g / math.log2(i + 1) for i, g in enumerate(gains, start=1))
            ideal_gains = sorted((max(0, g) for g in qrels_q.values()), reverse=True)[:k]
            idcg = sum(g / math.log2(i + 1) for i, g in enumerate(ideal_gains, start=1))
            out[metric] = dcg / idcg if idcg > 0 else 0.0
        elif metric.startswith("judged_"):
            k = int(metric.split("_")[1])
            topn = ranked[:k]
            out[metric] = (sum(1 for d in topn if d in qrels_q) / len(topn)) if topn else 0.0
        elif metric.startswith("map_cut_"):
            k = int(metric.split("_")[2])
            hits, ap = 0, 0.0
            for i, flag in enumerate(rel_flags[:k], start=1):
                if flag:
                    hits += 1
                    ap += hits / i
            out[metric] = ap / num_rel if num_rel else 0.0
        elif metric == "Rprec":
            out[metric] = (sum(rel_flags[:num_rel]) / num_rel) if num_rel else 0.0
        elif metric == "bpref":
            # trec_eval m_bpref: per judged-relevant retrieved doc r, credit
            # 1 - min(#judged-nonrel above r, min(R, N)) / min(R, N); unjudged ignored
            nonrel_total = sum(1 for g in qrels_q.values() if 0 <= g < relevance_level)
            denom = min(num_rel, nonrel_total)
            nonrel_above, total = 0, 0.0
            for d in ranked:
                g = qrels_q.get(d)
                if g is None:
                    continue
                if g >= relevance_level:
                    total += 1.0 if denom == 0 else 1.0 - min(nonrel_above, denom) / denom
                elif g >= 0:
                    nonrel_above += 1
            out[metric] = total / num_rel if num_rel else 0.0
        elif metric == "ndcg":
            gains = [max(0, qrels_q.get(d, 0)) for d in ranked]
            dcg = sum(g / math.log2(i + 1) for i, g in enumerate(gains, start=1))
            ideal_gains = sorted((max(0, g) for g in qrels_q.values()), reverse=True)
            idcg = sum(g / math.log2(i + 1) for i, g in enumerate(ideal_gains, start=1))
            out[metric] = dcg / idcg if idcg > 0 else 0.0
        elif metric.startswith("success_"):
            k = int(metric.split("_")[1])
            out[metric] = 1.0 if sum(rel_flags[:k]) > 0 else 0.0
        elif metric == "set_P":
            out[metric] = (sum(rel_flags) / len(ranked)) if ranked else 0.0
        elif metric == "set_recall":
            out[metric] = (len(rel_set & set(ranked)) / num_rel) if num_rel else 0.0
        elif metric == "set_F":
            p = (sum(rel_flags) / len(ranked)) if ranked else 0.0
            r = (len(rel_set & set(ranked)) / num_rel) if num_rel else 0.0
            out[metric] = (2 * p * r / (p + r)) if (p + r) > 0 else 0.0
        else:
            raise ValueError(f"unsupported metric {metric!r}")
    return out


def eval_run(run: Dict[str, Dict[str, float]], qrels: Dict[str, Dict[str, int]], metrics: Sequence[str],
             relevance_level: int = 1, average: bool = True):
    """Evaluate a {qid: {docid: score}} run. Averages over queries in run ∩ qrels that
    have at least one relevant document (trec_eval behavior). judged_* metrics are
    instead averaged over every run ∩ qrels query."""
    judged = [m for m in metrics if m.startswith("judged_")]
    rest = [m for m in metrics if not m.startswith("judged_")]
    per_query = {}
    for qid, rundocs in run.items():
        qrels_q = qrels.get(qid)
        if qrels_q is None:
            continue
        has_rel = bool(_relevant_set(qrels_q, relevance_level))
        if not has_rel and not judged:
            continue  # trec_eval skips queries with no relevant docs
        ranked = rank_run(rundocs)
        wanted = metrics if has_rel else judged
        per_query[qid] = query_metrics(ranked, qrels_q, wanted, relevance_level)
    if not average:
        return per_query
    out = {}
    for m in metrics:
        vals = [v[m] for v in per_query.values() if m in v]
        out[m] = float(np.mean(vals)) if vals else 0.0
    return out


def msmarco_mrr_at_k(run: Dict[str, Dict[str, float]], qrels: Dict[str, Dict[str, int]], k: int = 10,
                     relevance_level: int = 1):
    """Official MS MARCO MRR@k semantics: average over all qrels queries
    present in the run, top-k by score."""
    scores = []
    for qid, qdocs in qrels.items():
        rel = {d for d, g in qdocs.items() if g >= relevance_level}
        if qid not in run or not rel:
            continue
        ranked = sorted(run[qid].items(), key=lambda kv: -kv[1])[:k]
        rr = 0.0
        for i, (docid, _) in enumerate(ranked, start=1):
            if docid in rel:
                rr = 1.0 / i
                break
        scores.append(rr)
    return float(np.mean(scores)) if scores else 0.0


def parse_metric(metric: str) -> bool:
    """Whether a metric string is computable by this module."""
    if metric in ("map", "recip_rank", "set_recall", "set_P", "set_F", "Rprec",
                  "bpref", "ndcg", "MRR@10"):
        return True
    return any(re.match(rf"^{p}\d+$", metric) for p in
               (r"P_", r"ndcg_cut_", r"recall_", r"judged_", r"map_cut_", r"success_"))
