#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drives retrieve-then-rerank serving on
one NVIDIA GPU, with KNRM and with monoBERT-MaxP at BERT-base width, then
ColBERT late-interaction serving at BERT-base width, and holds every kernel
against its plain PyTorch version.

    python3 chip_smoke.py            # needs one CUDA device; builds the kernels

Phases (each prints a line; any fault exits non-zero, and the last line is
printed only when every phase passed):

1. device: the card, its power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2. build: nvcc builds every kernel of the port from ``capreolus_tpu_torch/csrc``,
   one process per source, all started together;
3. kernel check, with CUDA-event times of each kernel and its plain version:
   K1 (``knrm_pool``) against ``knrm_pool_plain`` at the serving shape and at a
   small ragged shape, max |err| <= 2e-4; K2 (``flash_attention``) against
   ``attention_plain`` at the served shape (B=1600 passages, H=12, L=256, D=64,
   every key unmasked; compared on the first 128 batch rows), at a small ragged
   shape with a fully masked row, and in bf16: max |err| <= 1e-4 at f32 and
   2e-2 in bf16, with ``scaled_dot_product_attention`` timed beside it as the
   library yardstick (never called on the path); K3 (``maxsim``) against
   ``maxsim_scores_plain`` at the served shape (Lq=32, Ld=180, C=20,000,
   dim=128) for 1 and 64 queries on seeded inputs with docs of 64-180 valid
   tokens, and at a small ragged shape with a fully masked doc: -inf docs
   equal, max |err| <= 1e-4, with the bf16 product alone (one
   ``torch.matmul``) timed beside it, since no PyTorch call computes MaxSim;
4. KNRM serving: a seeded synthetic TREC corpus (20k docs of 200-1200 words),
   the port's index and a ``RerankingService(device="cuda")`` with KNRM at its
   published width (random300 embeddings, maxqlen 4, maxdoclen 800, 11 RBF
   kernels, topn 100, frozen kernels and embeddings, so the forward pass runs
   K1) serve 8 queries; the launch counts are read around that run, and the
   same queries served on the CPU must agree;
5. monoBERT serving: the same corpus, fresh caches, BERTMaxP at BERT-base width
   and depth (seeded N(0, 0.02) weights; hash-wordpiece tokenizer) over
   bertpassage at its defaults (maxseqlen 256, 16 passages of 150 tokens,
   stride 100), topn 100: one warm-up request, then 4 served queries with 12
   K2 launches each (one batch of 1600 passages per layer); one profiled
   request; K2 timed on a served request's layer-0 inputs; the GPU scores of
   query 0's two top first-stage candidates against the same reranker on the
   CPU, max |err| <= 1e-3;
6. ColBERT serving: the same corpus, fresh caches, ``ColbertRetrievalService``
   on "cuda" at the searcher's defaults (BERT-base encoder with seeded
   N(0, 0.02) weights and projection to dim 128 from an .npz checkpoint,
   maxqlen 32 with query augmentation, maxdoclen 180, exact resident search):
   set-up split into tokenization, encoding and upload; one warm-up request,
   8 single-query requests and one 64-query batch with their K2 and K3
   launches; one profiled request; K3 timed on the served corpus; query 0
   scored by K3 and by the plain version on the same device corpus (equal
   top-100 ordinals but for near-ties), and its served top 10 against the CPU
   encoder with plain MaxSim, max |err| <= 1e-2;
7. a ``kernels`` JSON line, then the result line.

Every kernel's launch count is set to 0 just before each serving path runs
and read just after it.
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
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # K2 vs its plain version:
# one softmax with f32 sums in another order; bf16 outputs round to 8 bits
BERT_CPU_TOL = 1e-3  # BERT-base scores, GPU vs CPU: 12 layers of f32 matmuls
# summed in other orders on the two devices
SERVING_DOCS = 20000  # corpus of the serving phases
TIMED_ROUNDS = 25  # timed rounds of 20 back-to-back calls per kernel (median)
BERT_QUERIES = 4  # served monoBERT queries after the warm-up request
K2_SHAPE = (1600, 12, 256, 64)  # 100 docs x 16 passages, BERT-base heads, maxseqlen 256
K3_TOL = 1e-4  # K3 vs its plain version: equal bf16 inputs, exact f32 products, the
# sums in another order; L2-normalised embeddings keep a score within Lq = 32
COLBERT_CPU_TOL = 1e-2  # served ColBERT scores vs the CPU encoder + plain MaxSim: the
# JAX suite's tolerance for bf16 MaxSim sums (tests/test_colbert.py); embeddings that
# differ by f32 rounding can round to neighbouring f16 / bf16 values
K3_SHAPE = (32, 180, SERVING_DOCS, 128)  # Lq, Ld, C, dim of the served ColBERT corpus
COLBERT = {"dim": 128, "maxqlen": 32, "maxdoclen": 180, "hits": 1000, "batch": 64,
           "quantize": "none", "shards": 1, "prefilter": 0}  # the searcher's defaults (MS MARCO settings)
COLBERT_QUERIES = 8  # served single-query ColBERT requests after the warm-up request
MASKED_BIAS = -1e9  # bias of a masked doc token, as the searcher uploads it

# HBM bandwidth (bytes/s), f32 non-tensor-core peak and dense bf16 tensor-core
# peak (FLOP/s) by card name, from NVIDIA's data sheets (dense rates, full power)
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),
    ("H200", 4.8e12, 67e12, 989e12),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name):
    """{"bw": bytes/s, torch.float32: FLOP/s, torch.bfloat16: FLOP/s} of the card."""
    for key, bw, f32, bf16 in CARD_PEAKS:
        if key in name:
            return {"bw": bw, torch.float32: f32, torch.bfloat16: bf16}
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
def cuda_ms(fn, rounds=TIMED_ROUNDS, calls=20):
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


def profile_request(svc, query, label, top=6):
    """Where one rerank request's time goes: device time by op (torch.profiler,
    CUPTI) against the request's wall time; the rest is host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.search([query], k=10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    averages = prof.key_averages()
    # the device's own events (kernels, copies, memsets): a host op such as
    # aten::addmm also carries its kernels' time, so counting it too would
    # count that time twice
    ops = sorted((e for e in averages if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                 key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in ops) / 1e3
    print(f"{label} profiled request: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); top device ops: "
          + "; ".join(f"{e.key[:40]} {device_us(e) / 1e3:.3f} ms x{e.count}" for e in ops[:top]))
    host = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)
    host_ms = sum(e.self_cpu_time_total for e in averages) / 1e3
    print(f"{label} profiled request: host time inside torch ops {host_ms:.2f} ms (the rest of the "
          f"wall is Python; a device-to-host copy waits there for the device); top host ops: "
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


def phase_k1_check(peaks):
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
        ms = cuda_ms(lambda: knrm_pool(*args))
        plain_ms = cuda_ms(lambda: knrm_pool_plain(*args))
        bound_ms, bound_by = k1_bound_ms(args, peaks["bw"], peaks[torch.float32])
        out[label] = {"shape": f"B={b} Q={q} D={d} E={e} K={args[4].shape[0]}", "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[3 kernel] knrm_pool {label} {out[label]['shape']}: max|err| {err:.3g}, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by})")
    return out


def k2_bound_ms(q, mask, peaks):
    """Least time for K2 on these inputs, counted from the mask.

    A key that is masked adds nothing to a row that has an unmasked key, so
    the function needs, per batch element, only the k and v rows of its
    unmasked keys (all L of them where every key is masked: the mean of V),
    all of q, the output written once and the mask; those bytes go over the
    HBM rate. It does 4*D operations (two multiply-adds) per (query row,
    needed key) pair, over the peak for the input dtype: the f32 rate outside
    the tensor cores, or the dense bf16 tensor-core rate. Returns (ms, "bytes"
    or "operations")."""
    b, h, l, d = q.shape
    e = q.element_size()
    keys = mask.sum(dim=1).double()
    keys = float(torch.where(keys > 0, keys, float(l)).sum())
    nbytes = 2.0 * b * h * l * d * e + 2.0 * h * d * e * keys + mask.numel() * mask.element_size()
    ops = 4.0 * h * l * d * keys
    t_bytes, t_ops = nbytes / peaks["bw"], ops / peaks[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_time(q, k, v, mask, peaks):
    """K2, its plain version and the library call (SDPA with the same boolean
    mask) at these inputs: CUDA-event ms of each, and the bound."""
    from torch.nn.functional import scaled_dot_product_attention

    from capreolus_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    sdpa_mask = mask[:, None, None, :]
    out = {"ms": cuda_ms(lambda: flash_attention(q, k, v, mask), rounds=5, calls=4),
           "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, mask), rounds=3, calls=2),
           "library_ms": cuda_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask),
                                 rounds=5, calls=4)}
    out["bound_ms"], out["bound_by"] = k2_bound_ms(q, mask, peaks)
    return out


def k2_error(q, k, v, mask, rows=128):
    """max |K2 - plain| over the first ``rows`` batch elements (the plain
    version's [rows, H, L, L] scores stay small), after checking that K2's
    output is finite everywhere."""
    from capreolus_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    got = flash_attention(q, k, v, mask)
    check(bool(torch.isfinite(got).all()), f"K2 {tuple(q.shape)} {q.dtype}: non-finite output")
    want = attention_plain(q[:rows], k[:rows], v[:rows], mask[:rows])
    torch.cuda.synchronize()
    err = float((got[:rows].float() - want.float()).abs().max())
    check(err <= K2_TOL[q.dtype], f"K2 {tuple(q.shape)} {q.dtype}: max |kernel - plain| = {err:.3g} "
                                  f"> {K2_TOL[q.dtype]}")
    return err, got


def phase_k2_check(peaks):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    q, k, v = (torch.randn(K2_SHAPE, generator=gen, device="cuda") for _ in range(3))
    mask = torch.ones(K2_SHAPE[0], K2_SHAPE[2], dtype=torch.bool, device="cuda")
    out = {"shape": "B={} H={} L={} D={}".format(*K2_SHAPE), "max_abs_err": k2_error(q, k, v, mask)[0]}

    # small ragged case: L off the tile size, ragged key counts, one fully masked element
    small = (3, 2, 77, 32)
    qs, ks, vs = (torch.randn(small, generator=gen, device="cuda") for _ in range(3))
    ms = torch.arange(small[2], device="cuda")[None, :] < torch.tensor([[60], [5], [0]], device="cuda")
    out["max_abs_err_small"], got = k2_error(qs, ks, vs, ms)
    mean_v = vs[-1].mean(dim=1, keepdim=True).expand_as(vs[-1])
    check(float((got[-1] - mean_v).abs().max()) <= K2_TOL[torch.float32], "K2: a fully masked row is not mean(V)")

    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    out["max_abs_err_bf16"] = k2_error(qb, kb, vb, mask)[0]
    out.update(k2_time(q, k, v, mask, peaks))
    bf16 = k2_time(qb, kb, vb, mask, peaks)
    out.update({f"{key}_bf16": value for key, value in bf16.items() if key != "plain_ms"})
    print(f"[3 kernel] flash_attention {out['shape']} every key unmasked: max|err| f32 {out['max_abs_err']:.3g} "
          f"(small ragged {out['max_abs_err_small']:.3g}, bf16 {out['max_abs_err_bf16']:.3g}); "
          f"f32 {out['ms']:.3f} ms (plain {out['plain_ms']:.3f}, SDPA {out['library_ms']:.3f}, bound "
          f"{out['bound_ms']:.3f} by {out['bound_by']}); bf16 {out['ms_bf16']:.3f} ms (plain {bf16['plain_ms']:.3f}, "
          f"SDPA {out['library_ms_bf16']:.3f}, bound {out['bound_ms_bf16']:.3f} by {out['bound_by_bf16']})")
    del q, k, v, qb, kb, vb
    torch.cuda.empty_cache()
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

    reset_launch_counts()
    gpu_results, request_ms, first_ms, rerank_ms, features_ms = [], [], [], [], []
    for query in queries:
        t0 = time.perf_counter()
        gpu_results.append(svc.search([query], k=10)[0])
        request_ms.append((time.perf_counter() - t0) * 1e3)
        first_ms.append(svc.last_stage_ms["first_stage"])
        rerank_ms.append(svc.last_stage_ms["rerank"])
        features_ms.append(svc.last_stage_ms["features"])
    launches = knrm_pool.launches
    print(f"[4 serving] per request (median of {len(queries)}): {np.median(request_ms):.2f} ms total, "
          f"first stage {np.median(first_ms):.2f} ms, rerank {np.median(rerank_ms):.2f} ms, of which the "
          f"host's features {np.median(features_ms):.2f} ms (timed inside each request); knrm_pool "
          f"launches in the run: {launches}")
    check(launches == len(queries), f"knrm_pool launched {launches} times for {len(queries)} "
                                    f"queries (expected one batch of topn=100 per query)")
    profile_request(svc, queries[0], "[4 serving]")

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
    return launches, corpus_dir, topics


def seeded_bert_params(config, seed, std=0.02):
    """Flat ``params/...`` arrays of a ``_BertScorer`` at ``config``'s geometry,
    named as the JAX trainer saves them: N(0, std) matrices and embeddings,
    zero biases, LayerNorm scale 1 and bias 0."""
    rng = np.random.Generator(np.random.PCG64(seed))
    h, inter = config.hidden_size, config.intermediate_size
    flat = {}

    def normal(name, *shape):
        flat[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(name, n_in, n_out):
        normal(f"{name}/kernel", n_in, n_out)
        flat[f"{name}/bias"] = np.zeros(n_out, np.float32)

    def layer_norm(name):
        flat[f"{name}/scale"], flat[f"{name}/bias"] = np.ones(h, np.float32), np.zeros(h, np.float32)

    normal("params/bert/word_embeddings", config.vocab_size, h)
    normal("params/bert/position_embeddings", config.max_position, h)
    normal("params/bert/token_type_embeddings", config.type_vocab_size, h)
    layer_norm("params/bert/embeddings_ln")
    for i in range(config.num_layers):
        pre = f"params/bert/layer_{i}"
        for name in ("query", "key", "value", "output"):
            dense(f"{pre}/attention/{name}", h, h)
        layer_norm(f"{pre}/attention_ln")
        dense(f"{pre}/intermediate", h, inter)
        dense(f"{pre}/ffn_output", inter, h)
        layer_norm(f"{pre}/output_ln")
    dense("params/bert/pooler", h, h)
    dense("params/classifier", h, 1)
    return flat


def phase_bert_serving(workdir, corpus_dir, topics, peaks):
    """monoBERT-MaxP serving at BERT-base width; returns (K2 launches in the
    served run, K2 on a served request's layer-0 inputs)."""
    from capreolus_tpu_torch.convert import load_params, save_params
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.serving import RerankingService, RetrievalService

    label = "[5 monobert]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")  # a fresh serving process
    coll = {"name": "dummy", "path": corpus_dir}
    config = get_bert_config("bert-base-uncased")
    t0 = time.perf_counter()
    ckpt = save_params(seeded_bert_params(config, seed=4), os.path.join(workdir, "bert.npz"))
    t_ckpt = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = Index.create("tpu", {"collection": coll})
    index.create_index()
    t_index = time.perf_counter() - t0
    rr_cfg = {"pretrained": "bert-base-uncased", "allowrandominit": True, "extractor": {"index": {"collection": coll}}}
    t0 = time.perf_counter()
    reranker = Reranker.create("BERTMaxP", rr_cfg)
    svc = RerankingService(index, reranker, ckpt, topn=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    ext = reranker.extractor.config
    print(f"{label} set-up: seeded BERT-base checkpoint {t_ckpt:.1f} s ({os.path.getsize(ckpt) / 1e6:.0f} MB), "
          f"first-stage index {t_index:.1f} s, service {t_service:.1f} s (of which the bertpassage extractor's "
          f"own index over the corpus {svc.extractor_seconds:.1f} s; the rest builds the model, loads the "
          f"weights and moves them to the card); bertpassage maxseqlen {ext['maxseqlen']} numpassages "
          f"{ext['numpassages']} passagelen {ext['passagelen']} stride {ext['stride']} maxqlen {ext['maxqlen']}")

    queries = topics[:BERT_QUERIES]
    svc.search(topics[BERT_QUERIES:BERT_QUERIES + 1], k=10)  # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    request_ms, first_ms, rerank_ms, features_ms, results = [], [], [], [], []
    for query in queries:
        t0 = time.perf_counter()
        results.append(svc.search([query], k=10)[0])
        request_ms.append((time.perf_counter() - t0) * 1e3)
        first_ms.append(svc.last_stage_ms["first_stage"])
        rerank_ms.append(svc.last_stage_ms["rerank"])
        features_ms.append(svc.last_stage_ms["features"])
    launches = flash_attention.launches
    print(f"{label} per request (median of {len(queries)}): {np.median(request_ms):.2f} ms total, first stage "
          f"{np.median(first_ms):.2f} ms, rerank {np.median(rerank_ms):.2f} ms, of which the host's features "
          f"{np.median(features_ms):.2f} ms (each request: "
          f"{', '.join(f'{t:.1f}' for t in request_ms)} ms); flash_attention launches in the run: {launches}")
    check(launches == config.num_layers * len(queries),
          f"flash_attention launched {launches} times for {len(queries)} queries (expected one batch of "
          f"topn=100 docs x 16 passages per layer: {config.num_layers} per query)")
    check(all(len(hits) == 10 and all(np.isfinite(s) for _, s in hits) for hits in results),
          "a served request did not return 10 finite scores")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_request(svc, queries[0], label)

    # K2 at the served path's own inputs: layer 0 of query 0's request
    hits = RetrievalService.search_async(svc, [queries[0]], k=svc.topn)()[0]
    docids = [d for d, _ in hits]
    batch = svc.rerank_batch("smoke0", queries[0], docids)
    seq_len = batch["pos_bert_input"].shape[-1]
    with torch.inference_mode():
        bert = svc.reranker.model.bert
        ids, seg, mask = (torch.from_numpy(batch[key].reshape(-1, seq_len)).to(svc.device)
                          for key in ("pos_bert_input", "pos_seg", "pos_mask"))
        mask = mask.bool()
        q, k, v = bert.layer_0.attention.heads(bert.embed(ids, seg))
        served = {"shape": "B={} H={} L={} D={}".format(*q.shape), "max_abs_err": k2_error(q, k, v, mask)[0],
                  "unmasked_key_share": float(mask.float().mean())}
        served.update(k2_time(q, k, v, mask, peaks))
        del q, k, v
    print(f"{label} flash_attention on a served request's layer-0 inputs ({served['shape']}, "
          f"{100 * served['unmasked_key_share']:.1f}% of keys unmasked): max|err| {served['max_abs_err']:.3g}, "
          f"{served['ms']:.3f} ms (plain {served['plain_ms']:.3f}, SDPA {served['library_ms']:.3f}, bound "
          f"{served['bound_ms']:.3f} by {served['bound_by']}); peak device memory of the served run "
          f"{peak_gb:.1f} GB")

    # query 0's two top first-stage candidates: the card against the CPU, same weights and batch
    two = {key: value[:2] for key, value in batch.items() if isinstance(value, np.ndarray)}
    with torch.inference_mode():
        gpu_two = svc.reranker.test(two, svc.device).cpu().numpy()
        served_scores = dict(svc.search([queries[0]], k=svc.topn)[0])
        cpu_reranker = Reranker.create("BERTMaxP", rr_cfg)
        cpu_model = cpu_reranker.build_model()
        cpu_model.load_state_dict(cpu_reranker.state_dict_from_params(load_params(ckpt)))
        t0 = time.perf_counter()
        cpu_two = cpu_reranker.test(two, "cpu").numpy()
        cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu_two - cpu_two).max())
    err_served = max(abs(served_scores[d] - c) for d, c in zip(docids[:2], cpu_two))
    check(err <= BERT_CPU_TOL and err_served <= BERT_CPU_TOL,
          f"BERT-base scores of {docids[:2]}: GPU {gpu_two} (served {[served_scores[d] for d in docids[:2]]}) "
          f"vs CPU {cpu_two}")
    print(f"{label} query 0's top-2 first-stage docs {docids[:2]}: GPU {gpu_two.tolist()} vs CPU "
          f"{cpu_two.tolist()} ({cpu_s:.1f} s on the CPU): max |err| {err:.3g} on the same batch, {err_served:.3g} "
          f"against the served 100-doc request (tolerance {BERT_CPU_TOL}); top hit of query 0: {results[0][0]}")
    return launches, served


# ---------------------------------------------------------------- ColBERT and K3
def k3_bound_ms(q, docs_t, bias_t, valid, peaks):
    """Least time for K3 on these inputs, counted from the mask.

    A masked token never takes part in a max, so the function needs only the
    valid tokens' embeddings (of valid docs), all of q (bf16, as the kernel
    reads it), the whole bias (to know which tokens are valid), the valid
    flags and the [Q, C] f32 output written once; those bytes go over the HBM
    rate. It does 2*dim operations per (query token, valid doc token) pair,
    over the dense bf16 tensor-core peak (the inputs are bf16). Returns (ms,
    "bytes" or "operations")."""
    nq, lq, dim = q.shape
    tokens = float(((bias_t >= 0) & valid[None, :]).sum())
    nbytes = (2.0 * nq * lq * dim + 2.0 * tokens * dim + bias_t.numel() * bias_t.element_size()
              + valid.numel() + 4.0 * nq * bias_t.shape[1])
    ops = 2.0 * nq * lq * dim * tokens
    t_bytes, t_ops = nbytes / peaks["bw"], ops / peaks[torch.bfloat16]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k3_measure(q, docs_t, bias_t, valid, peaks):
    """K3 against its plain version at these inputs: max |err| over the finite
    scores (the -inf docs must match exactly), CUDA-event ms of K3, of the plain
    version and of the bf16 product alone ([Q*Lq, dim] x [dim, C*Ld] in one
    torch.matmul: no single PyTorch call computes MaxSim), and the bound."""
    from capreolus_tpu_torch.ops.maxsim import maxsim, maxsim_scores_plain

    got = maxsim(q, docs_t, bias_t, valid)
    want = maxsim_scores_plain(q, docs_t, bias_t, valid)
    torch.cuda.synchronize()
    label = "K3 Q={} Lq={} Ld={} C={} dim={}".format(*q.shape[:2], *docs_t.shape)
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)), f"{label}: -inf entries differ from plain")
    finite = torch.isfinite(want)
    check(bool(torch.isfinite(got[finite]).all()), f"{label}: non-finite score of a valid doc")
    err = float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0
    check(err <= K3_TOL, f"{label}: max |kernel - plain| = {err:.3g} > {K3_TOL}")
    q2d = q.to(torch.bfloat16).reshape(-1, q.shape[2])
    d2d = docs_t.view(-1, docs_t.shape[2])
    big = q.shape[0] > 1
    out = {"shape": label[3:], "max_abs_err": err,
           "ms": cuda_ms(lambda: maxsim(q, docs_t, bias_t, valid), rounds=5 if big else 25, calls=4 if big else 20),
           "plain_ms": cuda_ms(lambda: maxsim_scores_plain(q, docs_t, bias_t, valid), rounds=3, calls=2),
           "product_gemm_ms": cuda_ms(lambda: torch.matmul(q2d, d2d.T), rounds=5, calls=4)}
    out["bound_ms"], out["bound_by"] = k3_bound_ms(q, docs_t, bias_t, valid, peaks)
    out["valid_token_share"] = float(((bias_t >= 0) & valid[None, :]).float().mean())
    return out


def k3_line(label, r):
    return (f"{label} {r['shape']}: max|err| {r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
            f"bf16 product GEMM alone {r['product_gemm_ms']:.3f}, bound {r['bound_ms']:.4f} by {r['bound_by']}; "
            f"{100 * r['valid_token_share']:.1f}% of tokens valid)")


def phase_k3_check(peaks):
    """K3 at the served shape on seeded inputs (L2-normalised embeddings,
    docs of 64-180 valid tokens and 2% pad docs), for one query and for a
    batch of 64, and at a small ragged shape with a fully masked doc."""
    from capreolus_tpu_torch.ops.maxsim import maxsim, maxsim_scores_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    lq, ld, c, dim = K3_SHAPE

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    docs_t = unit(ld, c, dim).to(torch.bfloat16)
    lengths = torch.randint(64, ld + 1, (c,), generator=gen, device="cuda")
    lengths[torch.rand(c, generator=gen, device="cuda") < 0.02] = 0
    mask = torch.arange(ld, device="cuda")[:, None] < lengths[None, :]
    bias_t = torch.where(mask, 0.0, MASKED_BIAS).float().contiguous()
    valid = mask.any(dim=0).contiguous()
    out = {}
    for nq in (1, 64):
        out[f"q{nq}"] = k3_measure(unit(nq, lq, dim), docs_t, bias_t, valid, peaks)
        print(k3_line("[3 kernel] maxsim", out[f"q{nq}"]))
    del docs_t, bias_t, mask
    torch.cuda.empty_cache()

    # small ragged case: 3 queries of 5 tokens, 11 docs of 7 tokens, dim 24, doc 4 fully masked
    q, docs = unit(3, 5, 24), unit(7, 11, 24).to(torch.bfloat16)
    small_mask = torch.rand(7, 11, generator=gen, device="cuda") > 0.3
    small_mask[:, 4] = False
    small_mask[0, [0, 1, 2, 3, 5, 6, 7, 8, 9, 10]] = True
    bias_s = torch.where(small_mask, 0.0, MASKED_BIAS).float().contiguous()
    valid_s = small_mask.any(dim=0).contiguous()
    got, want = maxsim(q, docs, bias_s, valid_s), maxsim_scores_plain(q, docs, bias_s, valid_s)
    torch.cuda.synchronize()
    check(bool(torch.isneginf(got[:, 4]).all()) and torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "K3 small: the fully masked doc is not -inf in kernel and plain alike")
    finite = torch.isfinite(want)
    out["max_abs_err_small"] = float((got[finite] - want[finite]).abs().max())
    check(out["max_abs_err_small"] <= K3_TOL, f"K3 small: max |kernel - plain| = {out['max_abs_err_small']:.3g}")
    print(f"[3 kernel] maxsim small Q=3 Lq=5 Ld=7 C=11 dim=24, doc 4 fully masked: -inf matches, max|err| "
          f"{out['max_abs_err_small']:.3g} (tolerance {K3_TOL})")
    return out


def reset_launch_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.maxsim import maxsim
    from capreolus_tpu_torch.ops.simmat import knrm_pool

    knrm_pool.launches = flash_attention.launches = maxsim.launches = 0


def colbert_params(config, dim, seed):
    """Flat ``params/...`` of a ColBERTModel at ``config``'s geometry: the
    encoder as ``seeded_bert_params`` draws it and the [hidden, dim]
    projection, N(0, 0.02)."""
    flat = {k: v for k, v in seeded_bert_params(config, seed).items() if not k.startswith("params/classifier")}
    rng = np.random.Generator(np.random.PCG64(seed + 1))
    flat["params/linear/kernel"] = rng.standard_normal((config.hidden_size, dim), dtype=np.float32) * np.float32(0.02)
    return flat


def phase_colbert_serving(workdir, corpus_dir, topics, peaks):
    """ColBERT serving at BERT-base width over the seeded corpus; returns
    (launches of K2 and K3 in the served run, K3 on the served corpus)."""
    from capreolus_tpu_torch.convert import bert_state_dict, load_params, save_params
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.maxsim import maxsim, maxsim_scores_plain
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.reranker.colbert import ColBERTModel
    from capreolus_tpu_torch.searcher import Searcher
    from capreolus_tpu_torch.searcher.late_interaction import topk_lower_ordinal_first
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    label = "[6 colbert]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_colbert")  # a fresh serving process
    config = get_bert_config("bert-base-uncased")
    t0 = time.perf_counter()
    ckpt = str(save_params(colbert_params(config, COLBERT["dim"], seed=7), os.path.join(workdir, "colbert.npz")))
    t_ckpt = time.perf_counter() - t0
    searcher = Searcher.create("colbert", {**COLBERT, "pretrained": "bert-base-uncased", "allowrandominit": True,
                                           "checkpointfile": ckpt,
                                           "index": {"collection": {"name": "dummy", "path": corpus_dir}}})
    t0 = time.perf_counter()
    searcher.index.create_index()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = ColbertRetrievalService(searcher, max_k=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    corpus = svc._corpus
    corpus_gb = sum(t.numel() * t.element_size() for t in corpus) / 1e9
    setup = searcher.setup_seconds
    print(f"{label} set-up: seeded checkpoint {t_ckpt:.1f} s, index {t_index:.1f} s, service {t_service:.1f} s, "
          f"of which corpus tokenization {setup['tokenize']:.1f} s, encoding {setup['encode']:.1f} s (K2 in every "
          f"layer), upload {setup['upload']:.2f} s; resident corpus {corpus_gb:.3f} GB on the card "
          f"(docs_t {tuple(corpus[0].shape)} bf16, bias, valid); config {COLBERT}")

    queries = topics[:COLBERT_QUERIES]
    batch = [topics[i % len(topics)] + " " + topics[(7 * i + 3) % len(topics)].split()[0] for i in range(64)]
    svc.search(topics[COLBERT_QUERIES:COLBERT_QUERIES + 1], k=10)  # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    request_ms, results = [], []
    for query in queries:
        t0 = time.perf_counter()
        results.append(svc.search([query], k=10)[0])
        request_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    batch_results = svc.search(batch, k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": flash_attention.launches, "maxsim": maxsim.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} per request (median of {len(queries)}): {np.median(request_ms):.2f} ms (spread "
          f"{min(request_ms):.2f}-{max(request_ms):.2f}: {', '.join(f'{t:.2f}' for t in request_ms)}); one 64-query "
          f"batch {batch_ms:.2f} ms; peak device memory of the served run {peak_gb:.2f} GB; launches in the run: "
          f"maxsim {launches['maxsim']}, flash_attention {launches['flash_attention']}")
    check(launches["maxsim"] == len(queries) + 1, f"maxsim launched {launches['maxsim']} times for "
                                                  f"{len(queries)} requests and one batch (one per query batch)")
    check(launches["flash_attention"] == config.num_layers * (len(queries) + 1),
          f"flash_attention launched {launches['flash_attention']} times (expected {config.num_layers} per "
          f"query batch)")
    check(all(len(hits) == 10 and all(np.isfinite(s) for _, s in hits) for hits in results + batch_results),
          "a served request did not return 10 finite scores")
    profile_request(svc, queries[0], label)

    # K3 on the served corpus: query 0 alone and the 64-query batch
    q0 = searcher.encode_queries(searcher._tokenize(queries[:1], COLBERT["maxqlen"]))
    q64 = searcher.encode_queries(searcher._tokenize(batch, COLBERT["maxqlen"]))
    served = {"q1": k3_measure(q0, *corpus, peaks), "q64": k3_measure(q64, *corpus, peaks)}
    for key in ("q1", "q64"):
        print(k3_line(f"{label} maxsim on the served corpus,", served[key]))

    # query 0 against the plain version on the same device corpus: equal top-100
    # ordinals, except where two docs' plain scores tie within the tolerance
    full_k, full_p = maxsim(q0, *corpus), maxsim_scores_plain(q0, *corpus)
    (kv, ko), (pv, po) = topk_lower_ordinal_first(full_k, 100), topk_lower_ordinal_first(full_p, 100)
    full_p, kv, ko, pv, po = (x[0].cpu().numpy() for x in (full_p, kv, ko, pv, po))
    top_err = float(np.abs(kv - pv).max())
    check(top_err <= K3_TOL, f"query 0: top-100 scores of K3 and plain differ by {top_err}")
    swapped = ko != po
    check(bool(np.all(np.abs(full_p[ko[swapped]] - full_p[po[swapped]]) <= K3_TOL)),
          "query 0: K3's top-100 ordinals differ from plain's beyond near-ties")
    swaps = int(swapped.sum())
    served_hits = dict(results[0])
    check([searcher.index.data.docid_strings[int(o)] for o in ko[:10]] == [d for d, _ in results[0]],
          "query 0: the served top 10 is not K3's top 10")

    # query 0's top 10 on the CPU: the port's encoder and plain MaxSim, same checkpoint
    cpu_model = ColBERTModel(config, dim=COLBERT["dim"])
    cpu_model.load_state_dict(bert_state_dict(load_params(ckpt)))
    cpu_model.eval()
    docids = [d for d, _ in results[0]]
    t0 = time.perf_counter()
    with torch.inference_mode():
        cq, _ = cpu_model.encode_query(torch.from_numpy(searcher._tokenize(queries[:1], COLBERT["maxqlen"])))
        texts = [searcher.index.get_doc(d) for d in docids]
        emb, dmask = cpu_model.encode_doc(torch.from_numpy(searcher._tokenize(texts, COLBERT["maxdoclen"])))
    emb16 = emb.numpy().astype(np.float16)  # the searcher's f16 cache, then bf16 as it uploads
    docs_cpu = torch.from_numpy(np.ascontiguousarray(emb16.swapaxes(0, 1))).to(torch.bfloat16)
    mask_cpu = dmask.T.contiguous() > 0
    cpu_scores = maxsim_scores_plain(cq, docs_cpu, torch.where(mask_cpu, 0.0, MASKED_BIAS).float(),
                                     mask_cpu.any(dim=0))[0].numpy()
    cpu_s = time.perf_counter() - t0
    err_cpu = float(max(abs(served_hits[d] - float(s)) for d, s in zip(docids, cpu_scores)))
    check(err_cpu <= COLBERT_CPU_TOL, f"query 0's top 10: served {[served_hits[d] for d in docids]} vs CPU "
                                      f"{cpu_scores.tolist()}")
    print(f"{label} query 0: K3 and plain agree on the device corpus (top-100 max |err| {top_err:.3g}, "
          f"{swaps} ordinals swapped at near-ties); served top 10 vs the CPU encoder + plain MaxSim: max |err| "
          f"{err_cpu:.3g} (tolerance {COLBERT_CPU_TOL}; {cpu_s:.1f} s on the CPU); top hit {results[0][0]}")
    served["max_abs_err_cpu"] = err_cpu
    served["request_ms"] = float(np.median(request_ms))
    del svc, corpus, q0, q64
    torch.cuda.empty_cache()
    return launches, served


def main():
    name = phase_device()
    peaks = card_peaks(name)
    workdir = tempfile.mkdtemp(prefix="capreolus_tpu_torch_smoke_")
    os.environ["CAPREOLUS_CACHE"] = os.path.join(workdir, "cache")
    os.environ["CAPREOLUS_RESULTS"] = os.path.join(workdir, "results")
    try:
        phase_build()
        k1 = phase_k1_check(peaks)
        k2 = phase_k2_check(peaks)
        k3 = phase_k3_check(peaks)
        k1_launches, corpus_dir, topics = phase_serving(workdir, SERVING_DOCS, ckpt_seed=3)
        k2_launches, k2_served = phase_bert_serving(workdir, corpus_dir, topics, peaks)
        colbert_launches, k3_served = phase_colbert_serving(workdir, corpus_dir, topics, peaks)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    serving = k1["serving"]
    k3_fields = ("shape", "max_abs_err", "ms", "plain_ms", "product_gemm_ms", "bound_ms", "bound_by",
                 "valid_token_share")
    kernels = [{
        "name": "knrm_pool",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/knrm_pool.cu",
        "replaces": "capreolus_tpu/ops/simmat.py:29",
        "tpu": "capreolus_tpu/ops/simmat.py::_knrm_kernel",
        "shape": serving["shape"],
        "launches": k1_launches,
        "max_abs_err": serving["max_abs_err"],
        "max_abs_err_small": k1["small"]["max_abs_err"],
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,  # no single PyTorch call computes KNRM kernel pooling
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/flash_attention.cu",
        "replaces": "capreolus_tpu/ops/flash_attention.py:47",
        "tpu": "capreolus_tpu/ops/flash_attention.py::_flash_kernel",
        "shape": k2_served["shape"] + " f32, layer-0 inputs of a served request",
        "launches": k2_launches + colbert_launches["flash_attention"],  # monoBERT's run, then ColBERT's
        "launches_monobert": k2_launches,
        "launches_colbert": colbert_launches["flash_attention"],
        "max_abs_err": k2_served["max_abs_err"],
        "max_abs_err_small": k2["max_abs_err_small"],
        "max_abs_err_bf16": k2["max_abs_err_bf16"],
        "unmasked_key_share": k2_served["unmasked_key_share"],
        "ms": k2_served["ms"],
        "plain_ms": k2_served["plain_ms"],
        "bound_ms": k2_served["bound_ms"],
        "bound_by": k2_served["bound_by"],
        "library_ms": k2_served["library_ms"],  # scaled_dot_product_attention, same boolean mask
        "every_key_unmasked": {key: k2[key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "ms_bf16", "library_ms_bf16", "bound_ms_bf16", "bound_by_bf16")},
    }, {
        "name": "maxsim",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/maxsim.cu",
        "replaces": "capreolus_tpu/ops/maxsim.py:34",
        "tpu": "capreolus_tpu/ops/maxsim.py::_maxsim_kernel",
        "shape": k3_served["q1"]["shape"] + ", one served query over the served corpus",
        "launches": colbert_launches["maxsim"],
        "max_abs_err": k3_served["q1"]["max_abs_err"],
        "max_abs_err_small": k3["max_abs_err_small"],
        "max_abs_err_cpu_top10": k3_served["max_abs_err_cpu"],
        "ms": k3_served["q1"]["ms"],
        "plain_ms": k3_served["q1"]["plain_ms"],
        "bound_ms": k3_served["q1"]["bound_ms"],
        "bound_by": k3_served["q1"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes MaxSim
        "product_gemm_ms": k3_served["q1"]["product_gemm_ms"],  # the bf16 [Q*Lq, dim] x [dim, C*Ld] product alone
        "batch_64": {key: k3_served["q64"][key] for key in k3_fields},
        "synthetic": {nq: {key: k3[nq][key] for key in k3_fields} for nq in ("q1", "q64")},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
