"""Experiment evaluation (the JAX package's ``evaluation/__init__.py``): metric
computation, cross-validated best-run selection, and run interpolation, over
the pure-Python trec_eval of ``evaluation/metrics.py``. The on-device metrics
(``device_metrics.py``) are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from capreolus_tpu_torch.evaluation.metrics import eval_run, msmarco_mrr_at_k
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.trec import load_trec_run

logger = get_logger(__name__)

MRR_10 = "MRR@10"
DEFAULT_METRICS = [
    "P_1",
    "P_5",
    "P_10",
    "P_20",
    "judged_10",
    "judged_20",
    "judged_200",
    "map",
    "ndcg_cut_5",
    "ndcg_cut_10",
    "ndcg_cut_20",
    "recall_100",
    "recall_1000",
    "recip_rank",
    MRR_10,
]


def _eval_runs(runs, qrels, metrics, relevance_level):
    overlap_qids = set(qrels) & set(runs)
    if len(overlap_qids) == 0:
        logger.warning("no overlapping qids between qrels and runs; skipping evaluation")
        return {m: -1 for m in metrics}
    if set(runs) != set(qrels):
        logger.warning(
            "queries mismatch in qrels and runs: qrels=%d runs=%d overlap=%d",
            len(qrels), len(runs), len(overlap_qids),
        )

    trec_metrics = [m for m in metrics if m != MRR_10]
    scores = eval_run(runs, qrels, trec_metrics, relevance_level=int(relevance_level))
    if MRR_10 in metrics:
        scores[MRR_10] = msmarco_mrr_at_k(runs, qrels, k=10, relevance_level=int(relevance_level))
    return scores


def eval_runs(runs, qrels, metrics, relevance_level=1):
    """Evaluate a {qid: {docid: score}} run dict; returns {metric: mean score}."""
    metrics = [metrics] if isinstance(metrics, str) else list(metrics)
    return _eval_runs(runs, qrels, metrics, relevance_level)


def eval_runfile(runfile, qrels, metrics, relevance_level=1):
    """Evaluate a TREC run file."""
    metrics = [metrics] if isinstance(metrics, str) else list(metrics)
    return _eval_runs(load_trec_run(runfile), qrels, metrics, relevance_level)


def search_best_run(runfile_dirs, benchmark, primary_metric, metrics=None, folds=None):
    """Per fold, pick the run file with the best dev (non_nn_dev) score on
    primary_metric, then evaluate the union of test qids across folds."""
    if not isinstance(runfile_dirs, (list, tuple)):
        runfile_dirs = [runfile_dirs]
    metrics = [] if not metrics else ([metrics] if isinstance(metrics, str) else list(metrics))
    if primary_metric not in metrics:
        metrics = [primary_metric] + metrics

    folds = {f: benchmark.folds[f] for f in [folds]} if folds else benchmark.folds
    runfiles = [
        os.path.join(d, f)
        for d in runfile_dirs
        for f in sorted(os.listdir(d))
        if f != "done" and not os.path.isdir(os.path.join(d, f))
    ]

    best = {f: {primary_metric: -np.inf, "path": None} for f in folds}
    for runfile in runfiles:
        runs = load_trec_run(runfile)
        for fold_name in folds:
            dev_qrels = {qid: benchmark.qrels[qid] for qid in benchmark.non_nn_dev[fold_name] if qid in benchmark.qrels}
            score = _eval_runs(runs, dev_qrels, [primary_metric], benchmark.relevance_level)[primary_metric]
            if score > best[fold_name][primary_metric]:
                best[fold_name] = {primary_metric: score, "path": runfile}

    for fold, scores in best.items():
        logger.info("best dev score on fold=%s: %s=%s", fold, primary_metric, scores[primary_metric])

    test_runs = {}
    for fold_name, score_dict in best.items():
        test_qids = folds[fold_name]["predict"]["test"]
        test_runs.update({qid: {} for qid in test_qids})
        if score_dict["path"] is not None:
            test_runs.update(
                {qid: d for qid, d in load_trec_run(score_dict["path"]).items() if qid in test_qids}
            )

    scores = eval_runs(test_runs, benchmark.qrels, metrics, benchmark.relevance_level)
    return {"score": scores, "path": {f: v["path"] for f, v in best.items()}}


def interpolate_runs(run1, run2, qids, alpha):
    """Min-max normalize both runs per query and mix with weight alpha on run1,
    including the degenerate min==max guard."""
    out = {}
    for qid in qids:
        out[qid] = {}
        r1, r2 = run1.get(qid, {}), run2.get(qid, {})

        if len(r1) == 0:
            min1, max1 = 0.0, 1.0
        else:
            min1, max1 = min(r1.values()), max(r1.values())
            if min1 == max1:
                min1 = 0.01 * max1 - 0.01
        if len(r2) == 0:
            min2, max2 = 0.0, 1.0
        else:
            min2, max2 = min(r2.values()), max(r2.values())
            if min2 == max2:
                min2 = 0.01 * max2 - 0.01

        for docid in set(r1) | set(r2):
            s1 = (r1.get(docid, min1) - min1) / (max1 - min1)
            s2 = (r2.get(docid, min2) - min2) / (max2 - min2)
            out[qid][docid] = alpha * s1 + (1 - alpha) * s2
    return out


def interpolated_eval(run1, run2, benchmark, primary_metric, metrics=None):
    """Grid-search the interpolation weight on each fold's dev set, then evaluate the
    interpolated test runs."""
    metrics = [] if not metrics else ([metrics] if isinstance(metrics, str) else list(metrics))
    if primary_metric not in metrics:
        metrics = [primary_metric] + metrics

    test_runs = {}
    alphas = {}
    for fold_name, fold in benchmark.folds.items():
        best_metric = None
        dev_qids = set(fold["predict"]["dev"])
        dev1, dev2 = run1[fold_name]["dev"], run2[fold_name]["dev"]

        for alpha in np.arange(0, 1.001, 0.05):
            interpolated = interpolate_runs(dev1, dev2, dev_qids, alpha)
            scores = eval_runs(interpolated, benchmark.qrels, metrics, benchmark.relevance_level)
            if best_metric is None or scores[primary_metric] > best_metric:
                best_metric = scores[primary_metric]
                alphas[fold_name] = float(alpha)

        test_qids = set(fold["predict"]["test"])
        test1, test2 = run1[fold_name]["test"], run2[fold_name]["test"]
        interpolated_test = interpolate_runs(test1, test2, test_qids, alphas[fold_name])
        for qid in test_qids:
            assert qid not in test_runs
            test_runs[qid] = dict(interpolated_test[qid])

    scores = eval_runs(test_runs, benchmark.qrels, metrics, benchmark.relevance_level)
    return {"score": scores, "alphas": alphas}
