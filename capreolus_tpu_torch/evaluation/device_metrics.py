"""On-device ranking metrics (the JAX package's ``evaluation/device_metrics.py``):
nDCG@k, AP, P@k, recall@k and reciprocal rank as batched f32 tensor functions
over [Q, k] gain matrices, on an explicit ``device`` (default "cuda").

``eval_runs_device`` is a drop-in for ``evaluation.eval_runs`` when every
metric is supported (``device_supported``): the host stages each query's gain
vector once (numpy, rank order from ``metrics.rank_run``, trec_eval's
score-then-reverse-docid sort), and the metric arithmetic runs on the device
in f32, as the JAX functions run it. The means agree with the host's f64
metrics within about 1e-7 (``tests/test_torch_device_metrics.py``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from capreolus_tpu_torch.evaluation.metrics import rank_run

DEVICE_SUPPORTED = ("map", "recip_rank", "MRR@10")


def dcg_at_k(gains, k):
    """[Q, >=k] gains in rank order -> [Q] DCG@k with log2(rank+1) discounts."""
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=gains.device)
    discounts = 1.0 / torch.log2(ranks + 1.0)
    return (gains[:, :k] * discounts[None, :]).sum(dim=1)


def ndcg_at_k(gains, ideal_gains, k):
    dcg = dcg_at_k(gains, k)
    idcg = dcg_at_k(ideal_gains, k)
    return torch.where(idcg > 0, dcg / torch.clamp_min(idcg, 1e-9), 0.0)


def average_precision(rel_flags, num_rel):
    """[Q, D] binary relevance in rank order, [Q] total relevant -> [Q] AP."""
    hits = torch.cumsum(rel_flags, dim=1)
    ranks = torch.arange(1, rel_flags.shape[1] + 1, dtype=torch.float32, device=rel_flags.device)
    precisions = hits / ranks[None, :]
    ap = (precisions * rel_flags).sum(dim=1) / torch.clamp_min(num_rel, 1.0)
    return torch.where(num_rel > 0, ap, 0.0)


def precision_at_k(rel_flags, k):
    return rel_flags[:, :k].sum(dim=1) / k


def recall_at_k(rel_flags, num_rel, k):
    return torch.where(num_rel > 0, rel_flags[:, :k].sum(dim=1) / torch.clamp_min(num_rel, 1.0), 0.0)


def reciprocal_rank(rel_flags, k=0):
    """First-relevant reciprocal rank; k > 0 caps the considered depth (MRR@k).
    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    depth = rel_flags.shape[1] if k == 0 else min(k, rel_flags.shape[1])
    flags = rel_flags[:, :depth]
    ranks = torch.arange(1, depth + 1, dtype=torch.float32, device=rel_flags.device)
    first = torch.argmax((flags > 0).to(torch.int32), dim=1)
    found = flags.amax(dim=1) > 0
    return torch.where(found, 1.0 / ranks[first], 0.0)


def eval_runs_device(runs, qrels, metrics, relevance_level=1, device="cuda"):
    """``evaluation.eval_runs`` for supported metrics with the metric
    arithmetic on ``device``: the host stages per-query gain vectors only."""
    qids = [q for q in runs if q in qrels and any(g >= relevance_level for g in qrels[q].values())]
    if not qids:
        return {m: 0.0 for m in metrics}

    depth = max(max((len(runs[q]) for q in qids), default=1), 1)
    max_judged = max(len(qrels[q]) for q in qids)
    metric_ks = [int(m.rsplit("_", 1)[1]) for m in metrics if "_" in m and m.rsplit("_", 1)[1].isdigit()]
    pad_to = max([depth, max_judged] + metric_ks)

    gains = np.zeros((len(qids), pad_to), dtype=np.float32)
    flags = np.zeros((len(qids), pad_to), dtype=np.float32)
    ideal = np.zeros((len(qids), pad_to), dtype=np.float32)
    num_rel = np.zeros(len(qids), dtype=np.float32)
    for i, qid in enumerate(qids):
        for j, docid in enumerate(rank_run(runs[qid])):
            grade = qrels[qid].get(docid, 0)
            gains[i, j] = max(0, grade)
            flags[i, j] = 1.0 if grade >= relevance_level else 0.0
        judged = sorted((max(0, g) for g in qrels[qid].values()), reverse=True)
        ideal[i, : len(judged)] = judged
        num_rel[i] = sum(1 for g in qrels[qid].values() if g >= relevance_level)

    device = torch.device(device)
    gains, flags, ideal, num_rel = (torch.from_numpy(a).to(device) for a in (gains, flags, ideal, num_rel))
    out = {}
    for metric in metrics:
        if metric == "map":
            vals = average_precision(flags, num_rel)
        elif metric == "recip_rank":
            vals = reciprocal_rank(flags)
        elif metric == "MRR@10":
            vals = reciprocal_rank(flags, k=10)
        elif metric.startswith("ndcg_cut_"):
            vals = ndcg_at_k(gains, ideal, int(metric.split("_")[2]))
        elif metric.startswith("P_"):
            vals = precision_at_k(flags, int(metric.split("_")[1]))
        elif metric.startswith("recall_"):
            vals = recall_at_k(flags, num_rel, int(metric.split("_")[1]))
        else:
            raise ValueError(f"metric {metric!r} not supported on device")
        out[metric] = float(vals.mean())
    return out


def device_supported(metrics):
    """Whether every metric in the list can be evaluated on device."""
    return all(m in DEVICE_SUPPORTED or re.match(r"^(ndcg_cut|P|recall)_\d+$", m) for m in metrics)
