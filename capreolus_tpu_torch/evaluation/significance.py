"""Statistical significance testing between two runs (paired t-test and the
Fisher randomization test), beyond the reference (whose evaluator only reports
point averages, capreolus/evaluator.py).

IR comparisons are PAIRED: both systems answer the same queries, so the tests
operate on per-query metric differences (Smucker, Allan & Carterette, CIKM'07
recommend the randomization test; the paired t-test is the common shorthand).
Everything is from-scratch numpy/stdlib — the t distribution's CDF comes from
the regularized incomplete beta function evaluated with the standard continued
fraction (Lentz's algorithm), so no scipy dependency.

    from capreolus_tpu_torch.evaluation.significance import compare_runs
    report = compare_runs(run_a, run_b, qrels, metrics=["map", "ndcg_cut_10"])
    # {'map': {'mean_a': ..., 'mean_b': ..., 'diff': ..., 'n': 50,
    #          't': 2.31, 't_p': 0.025, 'rand_p': 0.027}, ...}

CLI: ``python -m capreolus_tpu_torch.evaluation.significance A.run B.run
--benchmark nf --metrics map ndcg_cut_10``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


# ------------------------------------------------------------------ t distribution
def _betacf(a: float, b: float, x: float, maxiter: int = 300, eps: float = 3e-14) -> float:
    """Continued fraction for the incomplete beta (Lentz's method)."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    d = 1.0 / (d if abs(d) > tiny else tiny)
    h = d
    for m in range(1, maxiter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + aa / (c if abs(c) > tiny else tiny)
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + aa / (c if abs(c) > tiny else tiny)
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            return h
    return h  # converged enough for p-value purposes


def _betainc_reg(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_front = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
                + a * math.log(x) + b * math.log(1.0 - x))
    front = math.exp(ln_front)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def t_sf_two_sided(t: float, df: float) -> float:
    """Two-sided p-value for a t statistic: P(|T| >= |t|) = I_{df/(df+t^2)}(df/2, 1/2)."""
    if df <= 0:
        return float("nan")
    return _betainc_reg(df / 2.0, 0.5, df / (df + t * t))


# ------------------------------------------------------------------ paired tests
def paired_t_test(a: Sequence[float], b: Sequence[float]) -> Dict[str, float]:
    """Two-sided paired t-test on per-query values (same query order)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, "paired test needs one value per query from EACH run"
    d = a - b
    n = len(d)
    if n < 2:
        return {"t": float("nan"), "p": float("nan"), "df": max(n - 1, 0), "mean_diff": float(d.mean()) if n else 0.0}
    sd = d.std(ddof=1)
    mean = float(d.mean())
    if sd == 0.0:
        # identical per-query values: no evidence of difference (p=1) unless
        # the constant shift itself is nonzero (p->0; t carries the SIGN of
        # the shift so the direction never contradicts mean_diff)
        return {"t": math.copysign(float("inf"), mean) if mean != 0 else 0.0,
                "p": 0.0 if mean != 0 else 1.0, "df": n - 1, "mean_diff": mean}
    t = mean / (sd / math.sqrt(n))
    return {"t": float(t), "p": t_sf_two_sided(t, n - 1), "df": n - 1, "mean_diff": mean}


def randomization_test(a: Sequence[float], b: Sequence[float], iters: int = 100_000,
                       seed: int = 42) -> Dict[str, float]:
    """Fisher sign-flip randomization test (two-sided): under H0 the system
    labels are exchangeable per query, so each difference's sign is flipped
    uniformly; p = fraction of permutations whose |mean difference| >= the
    observed one (add-one smoothed so p is never exactly 0)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    d = a - b
    n = len(d)
    if n == 0:
        return {"p": float("nan"), "mean_diff": 0.0, "iters": 0}
    observed = abs(d.mean())
    rng = np.random.Generator(np.random.PCG64(seed))
    hits = 0
    chunk = max(1, min(iters, 10_000_000 // max(n, 1)))  # bound the sign matrix
    done = 0
    while done < iters:
        k = min(chunk, iters - done)
        signs = rng.integers(0, 2, size=(k, n)) * 2 - 1
        perm_means = np.abs((signs * d[None, :]).mean(axis=1))
        hits += int((perm_means >= observed - 1e-15).sum())
        done += k
    return {"p": (hits + 1) / (iters + 1), "mean_diff": float(d.mean()), "iters": iters}


def per_query_metric(run, qrels, metric: str, relevance_level: int = 1) -> Dict[str, float]:
    """{qid: metric value} via the trec_eval-semantics evaluator."""
    from capreolus_tpu_torch.evaluation.metrics import eval_run

    per_query = eval_run(run, qrels, [metric], relevance_level=relevance_level, average=False)
    return {qid: vals[metric] for qid, vals in per_query.items() if metric in vals}


def compare_runs(run_a, run_b, qrels, metrics: Sequence[str] = ("map",),
                 relevance_level: int = 1, iters: int = 100_000, seed: int = 42):
    """Per-metric paired comparison of two runs over their COMMON evaluated
    queries. Returns {metric: {mean_a, mean_b, diff, n, t, t_p, rand_p}}."""
    from capreolus_tpu_torch.evaluation.metrics import eval_run

    # ONE evaluation pass per run covers every metric (re-ranking the run per
    # metric would multiply the evaluation cost by len(metrics))
    pq_a = eval_run(run_a, qrels, list(metrics), relevance_level=relevance_level, average=False)
    pq_b = eval_run(run_b, qrels, list(metrics), relevance_level=relevance_level, average=False)
    report = {}
    for metric in metrics:
        pa = {q: v[metric] for q, v in pq_a.items() if metric in v}
        pb = {q: v[metric] for q, v in pq_b.items() if metric in v}
        common = sorted(set(pa) & set(pb))
        if len(pa) != len(common) or len(pb) != len(common):
            logger.warning("%s: comparing over %d common queries (run A evaluated %d, "
                           "run B %d)", metric, len(common), len(pa), len(pb))
        a = [pa[q] for q in common]
        b = [pb[q] for q in common]
        t = paired_t_test(a, b)
        r = randomization_test(a, b, iters=iters, seed=seed)
        report[metric] = {
            "mean_a": float(np.mean(a)) if common else 0.0,
            "mean_b": float(np.mean(b)) if common else 0.0,
            "diff": t["mean_diff"], "n": len(common),
            "t": t["t"], "t_p": t["p"], "rand_p": r["p"],
        }
    return report


def main():
    import argparse

    import capreolus_tpu_torch

    capreolus_tpu_torch.load_all_modules()
    from capreolus_tpu_torch.benchmark import Benchmark
    from capreolus_tpu_torch.searcher import Searcher

    p = argparse.ArgumentParser(description="paired significance tests between two TREC runs")
    p.add_argument("run_a")
    p.add_argument("run_b")
    p.add_argument("--benchmark", default="nf", help="benchmark providing the qrels")
    p.add_argument("--metrics", nargs="+", default=["map", "ndcg_cut_10"])
    p.add_argument("--iters", type=int, default=100_000)
    args = p.parse_args()

    benchmark = Benchmark.create(args.benchmark)
    report = compare_runs(Searcher.load_trec_run(args.run_a), Searcher.load_trec_run(args.run_b),
                          benchmark.qrels, metrics=args.metrics, iters=args.iters,
                          relevance_level=benchmark.relevance_level)
    for metric, row in report.items():
        print(f"{metric:>14}: A={row['mean_a']:.4f} B={row['mean_b']:.4f} "
              f"diff={row['diff']:+.4f} (n={row['n']})  "
              f"t={row['t']:+.3f} p={row['t_p']:.4f}  rand_p={row['rand_p']:.4f}")


if __name__ == "__main__":
    main()
