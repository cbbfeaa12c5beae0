#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drives retrieve-then-rerank serving on
one NVIDIA GPU and holds every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # needs one CUDA device; builds the kernels

Phases (each prints a line; any fault exits non-zero, and the last line is
printed only when every phase passed):

1. device: the card, its power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2. build: nvcc builds every kernel of the port from ``capreolus_tpu_torch/csrc``;
3. kernel check: K1 (``knrm_pool``) against ``knrm_pool_plain`` on the card at
   the serving shape and at a small ragged shape, max |err| <= 2e-4, with
   CUDA-event times of both;
4. serving: a seeded synthetic TREC corpus (20k docs of 200-1200 words), the
   port's index and a ``RerankingService(device="cuda")`` with KNRM at its
   published width (random300 embeddings, maxqlen 4, maxdoclen 800, 11 RBF
   kernels, topn 100, frozen kernels and embeddings, so the forward pass runs
   K1) serve 8 queries; the launch counts are read around that run, and the
   same queries served on the CPU must agree;
5. a ``kernels`` JSON line, then the result line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ERR_TOL = 2e-4  # K1 vs its plain version and GPU vs CPU rerank scores: the
# sigma=0.001 exact-match kernel amplifies f32 dot-product rounding
# (the JAX package's own tolerance for its kernel, tests/test_ops.py)
SERVING_DOCS = 20000  # corpus of the serving phase
TIMED_ROUNDS = 25  # timed rounds of 20 back-to-back calls per kernel (median)

# HBM bandwidth (bytes/s) and f32 non-tensor-core peak (FLOP/s) by card name,
# from NVIDIA's data sheets (dense rates, full power)
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name):
    for key, bw, flops in CARD_PEAKS:
        if key in name:
            return bw, flops
    raise SmokeFailure(f"no bandwidth/peak entry for card {name!r}; add it to CARD_PEAKS")


# ---------------------------------------------------------------- corpus
_CONSONANTS = list("bdfgklmnprstvz")
_VOWELS = list("aeiou")


def _word(rng):
    return "".join(rng.choice(_CONSONANTS) + rng.choice(_VOWELS) for _ in range(3))


def build_corpus(num_docs, num_topics, seed, min_len, max_len, bg_vocab=1500):
    """The recipe of the JAX suite's 50k-doc golden corpus (Zipfian background
    words plus per-topic concept words injected at graded intensities), with
    longer documents so that maxdoclen=800 binds. Returns (docs, topics)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab, seen = [], set()
    while len(vocab) < bg_vocab:
        w = _word(rng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    concept = {t: [f"{_word(rng)}{t:02d}x{j}" for j in range(6)] for t in range(num_topics)}
    probs = 1.0 / np.arange(1, bg_vocab + 1, dtype=np.float64) ** 1.1
    probs /= probs.sum()
    vocab_arr = np.asarray(vocab)
    lengths = rng.integers(min_len, max_len, size=num_docs)
    draws = rng.choice(bg_vocab, size=int(lengths.sum()), p=probs)
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    doc_words = [list(vocab_arr[draws[bounds[i]:bounds[i + 1]]]) for i in range(num_docs)]
    pool = rng.permutation(num_docs)
    pos = 0
    for t in range(num_topics):
        for count, lo, hi in ((30, 4, 7), (50, 2, 4), (40, 1, 2)):
            for _ in range(count):
                d = int(pool[pos])
                pos += 1
                k = int(rng.integers(lo, hi))
                words = list(rng.choice(concept[t], size=k, replace=False))
                for w, i in zip(words, rng.integers(0, len(doc_words[d]), size=k)):
                    doc_words[d].insert(int(i), w)
    topics = [" ".join(concept[t][:3]) + (f" {vocab[t]}" if t % 3 == 0 else "") for t in range(num_topics)]
    docs = [(f"G{i:05d}", " ".join(w)) for i, w in enumerate(doc_words)]
    return docs, topics


def write_trec(docs, directory, files=4):
    os.makedirs(directory, exist_ok=True)
    per_file = (len(docs) + files - 1) // files
    for f in range(files):
        with open(os.path.join(directory, f"part{f}.trec"), "wt", encoding="utf-8") as fh:
            for docid, text in docs[f * per_file:(f + 1) * per_file]:
                fh.write(f"<DOC>\n<DOCNO>{docid}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")


# ---------------------------------------------------------------- timing
def cuda_ms(fn, rounds, calls=20):
    """Device time per call (ms): the median over ``rounds`` of CUDA-event time
    around ``calls`` back-to-back calls, divided by ``calls``, after two warm-up
    calls. Timing one call alone would add the host's launch cost to the
    kernel's time (the device idles until the launch arrives); back to back,
    the launches queue up behind the running kernel."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def knrm_case(b, q, d, e, vocab, seed, device):
    """K1's inputs at one shape, built the way the model builds them: pad query
    rows, negative OOV ids in queries and docs, ragged doc lengths (pad tails)."""
    from capreolus_tpu_torch.ops.simmat import knrm_inputs
    from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS

    rng = np.random.Generator(np.random.PCG64(seed))
    emb = rng.standard_normal((vocab, e)).astype(np.float32)
    emb[0] = 0.0
    qt = rng.integers(1, vocab, size=(b, q))
    qt[:, -1] = 0  # one pad query row
    qt[:, 0] = np.where(rng.random(b) < 0.3, -rng.integers(1, 4, size=b), qt[:, 0])  # OOV ids
    dt = rng.integers(1, vocab, size=(b, d))
    dt[rng.random((b, d)) < 0.02] = -1  # OOV ids that meet the query's
    for i, n in enumerate(rng.integers(max(1, d // 4), d + 1, size=b)):
        dt[i, n:] = 0  # ragged pad tail
    return knrm_inputs(torch.from_numpy(emb).to(device), torch.from_numpy(qt).to(device),
                       torch.from_numpy(dt).to(device), KNRM_MUS, KNRM_SIGMAS)


def k1_bound_ms(args, bw, flops):
    """Least time for K1 on these inputs, counted from this run's token ids.

    An embedding row whose id is <= 0 (pad or OOV) is zero by K1's contract, so
    its similarity is fixed by the ids alone (0 at a pad, 0 or 1 at an OOV id):
    the function needs only the embedding rows of ids > 0, plus every id, the
    mus and sigmas, and the [B, K] output written once; those bytes go over the
    HBM rate. The f32 operations go over the f32 peak: 2 per multiply-add of
    the dot products and 6 per kernel value (sub, 2 mul, div, exp, add) at each
    (q, d) pair of two ids > 0, and one kernel value per (query row, k) for
    each of the two constant similarities. Returns (ms, "bytes" or "operations")."""
    q_emb, d_emb, qtok, dtok, mus, sigmas = args
    b, q, e = q_emb.shape
    k = mus.shape[0]
    q_rows = (qtok > 0).sum(dim=1).double()
    d_rows = (dtok > 0).sum(dim=1).double()
    rows = float(q_rows.sum() + d_rows.sum())
    nbytes = (rows * e * q_emb.element_size() + qtok.numel() * qtok.element_size()
              + dtok.numel() * dtok.element_size() + 2 * k * mus.element_size() + b * k * 4)
    pairs = float((q_rows * d_rows).sum())
    ops = (2.0 * e + 6.0 * k) * pairs + 6.0 * k * 2 * b * q
    t_bytes, t_ops = nbytes / bw, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_request(svc, query, top=6):
    """Where one rerank request's time goes: device time by op (torch.profiler,
    CUPTI) against the request's wall time; the rest is host time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.search([query], k=10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    averages = prof.key_averages()
    ops = sorted((e for e in averages if device_us(e) > 0), key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in ops) / 1e3
    print(f"[4 serving] profiled request: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); top device ops: "
          + "; ".join(f"{e.key[:40]} {device_us(e) / 1e3:.3f} ms x{e.count}" for e in ops[:top]))
    host = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)
    host_ms = sum(e.self_cpu_time_total for e in averages) / 1e3
    print(f"[4 serving] profiled request: host time inside torch ops {host_ms:.2f} ms (the rest of the "
          f"wall is Python); top host ops: "
          + "; ".join(f"{e.key[:32]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in host[:top]))


# ---------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} x{torch.cuda.device_count()}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off for matmul and cuDNN")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    from capreolus_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all()
    secs = time.perf_counter() - t0
    print(f"[2 build] {len(build.KERNEL_SOURCES)} kernel source(s) ready in {secs:.1f} s "
          f"(built now: {sorted(reports) or 'none, cached'})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernel_check(bw, flops, rounds):
    from capreolus_tpu_torch.ops.simmat import knrm_pool, knrm_pool_plain

    out = {}
    for label, shape, seed in (("serving", (100, 4, 800, 300), 1), ("small", (3, 5, 37, 20), 2)):
        b, q, d, e = shape
        args = knrm_case(b, q, d, e, vocab=5000, seed=seed, device="cuda")
        got = knrm_pool(*args)
        want = knrm_pool_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
        err = float((got - want).abs().max())
        check(err <= ERR_TOL, f"K1 {label}: max |kernel - plain| = {err:.3g} > {ERR_TOL}")
        ms = cuda_ms(lambda: knrm_pool(*args), rounds)
        plain_ms = cuda_ms(lambda: knrm_pool_plain(*args), rounds)
        bound_ms, bound_by = k1_bound_ms(args, bw, flops)
        out[label] = {"shape": f"B={b} Q={q} D={d} E={e} K={args[4].shape[0]}", "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[3 kernel] knrm_pool {label} {out[label]['shape']}: max|err| {err:.3g}, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by})")
    return out


def phase_serving(workdir, num_docs, ckpt_seed):
    import capreolus_tpu_torch
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.ops.simmat import knrm_pool
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService, RetrievalService

    capreolus_tpu_torch.load_all_modules()
    t0 = time.perf_counter()
    docs, topics = build_corpus(num_docs, num_topics=25, seed=20260819,
                                min_len=200, max_len=1200)
    corpus_dir = os.path.join(workdir, "corpus")
    write_trec(docs, corpus_dir)
    t_corpus = time.perf_counter() - t0

    coll = {"name": "dummy", "path": corpus_dir}
    rr_cfg = {"gradkernels": False, "finetune": False,
              "extractor": {"embeddings": "random300", "maxqlen": 4, "maxdoclen": 800,
                            "index": {"collection": coll}}}
    rng = np.random.Generator(np.random.PCG64(ckpt_seed))
    ckpt = save_params({"params/combine/kernel": (rng.standard_normal((11, 1)) * 0.1).astype(np.float32),
                        "params/combine/bias": np.zeros(1, np.float32)},
                       os.path.join(workdir, "knrm.npz"))

    t0 = time.perf_counter()
    index = Index.create("tpu", {"collection": coll})
    index.create_index()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    reranker = Reranker.create("KNRM", rr_cfg)
    svc = RerankingService(index, reranker, ckpt, topn=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    print(f"[4 serving] set-up: corpus {t_corpus:.1f} s ({num_docs} docs), first-stage index "
          f"{t_index:.1f} s, service {t_service:.1f} s (of which extractor over the corpus "
          f"{svc.extractor_seconds:.1f} s: host tokenization)")

    queries = topics[:8]
    svc.search(topics[8:9], k=10)  # warm-up request: CUDA context, kernel load
    torch.cuda.synchronize()

    knrm_pool.launches = 0
    gpu_results, request_ms, first_ms, rerank_ms = [], [], [], []
    for query in queries:
        t0 = time.perf_counter()
        gpu_results.append(svc.search([query], k=10)[0])
        request_ms.append((time.perf_counter() - t0) * 1e3)
        first_ms.append(svc.last_stage_ms["first_stage"])
        rerank_ms.append(svc.last_stage_ms["rerank"])
    launches = knrm_pool.launches
    print(f"[4 serving] per request (median of {len(queries)}): {np.median(request_ms):.2f} ms total, "
          f"first stage {np.median(first_ms):.2f} ms, rerank {np.median(rerank_ms):.2f} ms "
          f"(both timed inside each request); knrm_pool launches in the run: {launches}")
    check(launches == len(queries), f"knrm_pool launched {launches} times for {len(queries)} "
                                    f"queries (expected one batch of topn=100 per query)")
    profile_request(svc, queries[0])

    # the same queries on the CPU: identical first stage, same reranking
    reranker_cpu = Reranker.create("KNRM", rr_cfg)
    reranker_cpu.extractor.set_state(reranker.extractor.get_state())
    svc_cpu = RerankingService(index, reranker_cpu, ckpt, topn=100, device="cpu")
    for qi, query in enumerate(queries):
        # the first stage alone (RetrievalService's own dispatch/collect: calling
        # RetrievalService.search on the service would dispatch to the rerank stage)
        gpu_first = RetrievalService.search_async(svc, [query], k=svc.topn)()[0]
        cpu_first = RetrievalService.search_async(svc_cpu, [query], k=svc.topn)()[0]
        check([d for d, _ in cpu_first] == [d for d, _ in gpu_first],
              f"query {qi}: first-stage hits differ between GPU and CPU")
        cpu_s, gpu_s = np.array([s for _, s in cpu_first]), np.array([s for _, s in gpu_first])
        rel = float(np.max(np.abs(cpu_s - gpu_s) / cpu_s)) if len(cpu_s) else 0.0
        check(rel <= 1e-6, f"query {qi}: first-stage scores differ between GPU and CPU (max rel {rel:.3g})")
        cpu = svc_cpu.search([query], k=10)[0]
        gpu = gpu_results[qi]
        check(len(cpu) == len(gpu) and len(gpu) > 0, f"query {qi}: {len(gpu)} GPU hits vs {len(cpu)} CPU hits")
        for rank, ((gd, gs), (cd, cs)) in enumerate(zip(gpu, cpu)):
            check(np.isfinite(gs) and abs(gs - cs) <= ERR_TOL,
                  f"query {qi} rank {rank}: GPU score {gs} vs CPU score {cs}")
            # a different doc at a rank is allowed only for a near-tie swap
            check(gd == cd or abs(gs - cs) <= ERR_TOL, f"query {qi} rank {rank}: {gd} vs {cd}")
        cpu_scores = dict(cpu)
        for gd, gs in gpu:
            check(gd not in cpu_scores or abs(cpu_scores[gd] - gs) <= ERR_TOL,
                  f"query {qi}: doc {gd} scores {gs} on the GPU and {cpu_scores.get(gd)} on the CPU")
    print(f"[4 serving] {len(queries)} queries: first stage identical on GPU and CPU; reranked "
          f"top-10 agree within {ERR_TOL} (top hit of query 0: {gpu_results[0][0]})")
    return launches


def main():
    name = phase_device()
    bw, flops = card_peaks(name)
    workdir = tempfile.mkdtemp(prefix="capreolus_tpu_torch_smoke_")
    os.environ["CAPREOLUS_CACHE"] = os.path.join(workdir, "cache")
    os.environ["CAPREOLUS_RESULTS"] = os.path.join(workdir, "results")
    try:
        phase_build()
        checks = phase_kernel_check(bw, flops, TIMED_ROUNDS)
        launches = phase_serving(workdir, SERVING_DOCS, ckpt_seed=3)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    serving = checks["serving"]
    kernels = [{
        "name": "knrm_pool",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/knrm_pool.cu",
        "replaces": "capreolus_tpu/ops/simmat.py:29",
        "tpu": "capreolus_tpu/ops/simmat.py::_knrm_kernel",
        "shape": serving["shape"],
        "launches": launches,
        "max_abs_err": serving["max_abs_err"],
        "max_abs_err_small": checks["small"]["max_abs_err"],
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,  # no single PyTorch call computes KNRM kernel pooling
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
