#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drives retrieve-then-rerank serving on
one NVIDIA GPU, with KNRM and with monoBERT-MaxP at BERT-base width (f32, then
int8), then ColBERT late-interaction serving at BERT-base width (a bf16 corpus,
then int8 and int4 corpora), and holds every kernel against its plain PyTorch
version.

    python3 chip_smoke.py            # needs one CUDA device; builds the kernels

Phases (each prints a line; any fault exits non-zero, and the last line is
printed only when every phase passed):

1. device: the card, its power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2. build: nvcc builds every kernel of the port from ``capreolus_tpu_torch/csrc``,
   one process per source, all started together;
3. kernel check, with CUDA-event times of each kernel and its plain version:
   K1 (``knrm_pool``) against ``knrm_pool_plain`` at the serving shape, at a
   small ragged shape and at one with D off its split and an all-pad batch
   element, max |err| <= 2e-4, a repeated call bit-identical, timed back to
   back and, as a note on the wrapper's host work, from a CUDA graph; K2 (``flash_attention``) against
   ``attention_plain`` on the encoder's strided head views ([B, H, L, D] views
   of [B, L, H * D] rows) at the served shape (B=1600 passages, H=12, L=256,
   D=64, every key unmasked; compared on the first 128 batch rows), at
   ColBERT's L=32 and 180 with ragged key counts, and at a small ragged shape
   with a fully masked row, each in f32 and bf16: max |err| <= 1e-4 at f32 and
   2e-2 in bf16, its output written [B, L, H, D]; timed in both dtypes beside
   ``scaled_dot_product_attention`` on the same views (the library yardstick,
   never called on the path), the plain version and the bound (f32 at three
   TF32 products per product over the TF32 tensor-core rate, with the CUDA
   cores' f32 figure beside it); K3 (``maxsim``) against
   ``maxsim_scores_plain`` at the served shape (Lq=32, Ld=180, C=20,000,
   dim=128) for 1 and 64 queries on seeded inputs with docs of 64-180 valid
   tokens, and at three ragged shapes (a small one; one across the row tile,
   the doc tile, the Ld split and the cluster; queries of 200 tokens at dim
   20) with a fully masked doc and one whose only valid token is its last:
   -inf docs equal, max |err| <= 1e-4, a repeated call bit-identical, with the
   launch plan printed and the bf16 product alone (one ``torch.matmul``)
   timed beside it, since no PyTorch call computes MaxSim;
   X1 (``int8_matmul``, wgmma fed by TMA) at the served int8 shapes (monoBERT's
   [409,600 x 768] x [768 -> 768], [768 -> 3072] and [409,600 x 3072] x
   [3072 -> 768]; ColBERT's products as the quantized engine chunks the served
   corpus, for one query [32 x 128] x [3,600,000 -> 128] and for 64 queries
   [2,048 x 128] x [65,520 -> 128] and its last chunk [61,920 -> 128]): the
   int32 epilogue at both tile widths exactly against ``int8_matmul_plain`` on
   the first 8,192 rows (all rows of ColBERT's), at the BERT shapes the f32
   epilogue bit-identical to ``int8_linear_plain`` and, at the up-projection,
   the int8-gelu epilogue's codes within one step of ``int8_linear_gelu_plain``
   at a share of at most 1e-4 (the count printed); at small ragged shapes (-128,
   a misaligned operand, K off 16, M = 32, M and N off the tile) every epilogue
   with the same checks, the zero-padded copies counted; each epilogue timed
   at both tile widths beside its bound and its plain version, and
   ``torch._int_mm`` timed as the library yardstick of the product (never
   called on the path); Q1
   (``quantize_per_token``) exactly against ``quantize_per_token_plain`` at
   the served [409,600 x 768] and at ragged shapes, timed beside its bound;
   then the weight, GELU and ColBERT query scales (and their codes) computed
   on the card must equal the CPU's bit for bit;
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
   request, whose copy kernels are counted: fewer than one per layer, so no
   head split or merge copy is left; K2 timed on a served request's layer-0
   head views, as served in f32 and cast to bf16; the GPU scores of
   query 0's two top first-stage candidates against the same reranker on the
   CPU, max |err| <= 1e-3;
5b. monoBERT int8 serving: the same corpus, caches and checkpoint with
   ``quantize=int8``: one warm-up request, which calibrates the GELU scales on
   its batch, then the 4 queries with 72 X1 launches (q, k, v, output,
   intermediate, ffn_output in 12 layers: 60 in the f32 epilogue, 12 in the
   int8-gelu one), 36 Q1 launches (three per layer), no zero-padded copy and
   12 K2 launches each, and the run's peak device memory; one profiled
   request, with the copy check of phase 5; query 0's two top candidates on
   the GPU against the port's int8 path on the CPU with the same stats, layer
   by layer from the
   card's input to each layer (max |err| <= 5e-2: a code on a rounding
   boundary can flip by one step between devices) and the head from the card's
   last layer (<= 1e-3); the end-to-end GPU-vs-CPU gap, the card's own gap
   when its embeddings move by 1e-7, and the int8-vs-f32 score gap and top-10
   overlap of query 0 are reported;
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
6b. ColBERT int8 / int4 serving: the same doc-embedding cache with
   ``quantize=int8``: set-up (quantization, upload), one warm-up request, the 8
   single queries and the 64-query batch with their X1 launches (all in the
   int32 epilogue) and K2 launches; one profiled request; query 0's top 10
   against the CPU encoder with the port's int8 scoring of those docs, max
   |err| <= 1e-2; then ``quantize=int4`` with
   ``rescore`` 200: query 0's top 10 equals the ``quantize=none`` top 10 of
   phase 6 but for near-ties (two docs that trade places score within 1e-2 of
   each other in both lists);
7. the seconds each phase took, a ``kernels`` JSON line, then the result line.

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

X1_BERT_SERVED = (  # (label, M, K, N) of the int8 products of a served monoBERT request
    ("qkv_out", 409600, 768, 768),       # 1600 passages x 256 tokens: q, k, v and output projections
    ("intermediate", 409600, 768, 3072),  # the FFN up-projection
    ("ffn_output", 409600, 3072, 768),    # the FFN down-projection
)
X1_CHECK_ROWS = 8192  # rows of each served product compared with the plain version
INT8_LAYER_TOL = 5e-2  # an int8 BERT-base layer, GPU vs CPU from the same input: a code
# on a rounding boundary can flip by one step between the devices; a 1e-7 move of the
# input moved such a layer's output by 9.5e-3 where the f32 layer's moved by 1.4e-6
# (tests/test_torch_int8.py::test_int8_layer_is_a_step_function_of_its_input); a wiring
# fault moves outputs by their own size, about 1 after LayerNorm
X1_PER_REQUEST = 72  # q, k, v, output, intermediate, ffn_output in each of 12 layers
X1_MODES_PER_REQUEST = {"int32": 0, "f32": 60, "int8_gelu": 12}  # the up-projections in the GELU epilogue
Q1_PER_REQUEST = 36  # the input of q/k/v, of the output projection and of the up-projection, per layer
GELU_FLIP_SHARE = 1e-4  # int8-gelu codes that may differ by one step from the plain version's:
# the kernel's tanhf and torch's can round apart where a value sits on a code boundary
PR4_INT8_PEAK_GB = 18.2  # peak device memory of a served int8 monoBERT run before the fused epilogues
COLBERT_RESCORE = 200  # the searcher's default int4 rescore depth

# HBM bandwidth (bytes/s), f32 non-tensor-core peak, dense bf16 tensor-core
# peak (FLOP/s), dense int8 tensor-core peak (OP/s) and dense TF32
# tensor-core peak (FLOP/s) by card name, from NVIDIA's data sheets (dense
# rates, full power)
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12, 1513e12, 378e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12, 1671e12, 418e12),
    ("H100", 3.35e12, 67e12, 989e12, 1979e12, 495e12),
    ("H200", 4.8e12, 67e12, 989e12, 1979e12, 495e12),
)
K2_TF32_PRODUCTS = 3  # K2's f32 path computes each product as three TF32 products (split TF32)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name):
    """{"bw": bytes/s, torch.float32: FLOP/s, torch.bfloat16: FLOP/s, torch.int8:
    OP/s, "tf32": FLOP/s} of the card."""
    for key, bw, f32, bf16, int8, tf32 in CARD_PEAKS:
        if key in name:
            return {"bw": bw, torch.float32: f32, torch.bfloat16: bf16, torch.int8: int8, "tf32": tf32}
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


def graph_ms(fn, rounds=TIMED_ROUNDS, calls=20):
    """Device time per call (ms) with the host out of the way: ``calls`` calls
    captured once in a CUDA graph and replayed between CUDA events, the median
    over ``rounds``, after two warm-up calls. For a kernel that takes less
    time than its wrapper's host work, where back-to-back launches
    (``cuda_ms``) would time the host."""
    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
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
    CUPTI) against the request's wall time; the rest is host time. Returns
    {"wall_ms", "busy_ms", "copy_kernels", "copy_ms", "clones"}: the device's
    copy kernels (torch's ``direct_copy_kernel_cuda``, run by ``copy_``,
    ``contiguous`` and ``reshape`` of a strided tensor, and casts) and the host's
    ``aten::clone`` calls, so a caller can check which copies a request makes."""
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
    copies = [e for e in ops if "copy_kernel" in e.key]
    summary = {"wall_ms": wall_ms, "busy_ms": busy_ms, "copy_kernels": sum(e.count for e in copies),
               "copy_ms": sum(device_us(e) for e in copies) / 1e3,
               "clones": sum(e.count for e in averages if e.key == "aten::clone")}
    print(f"{label} profiled request: device copy kernels {summary['copy_kernels']} ({summary['copy_ms']:.3f} ms), "
          f"host aten::clone calls {summary['clones']}")
    return summary


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
    """K1 against its plain version at the serving shape, a small ragged shape
    and a ragged one whose D is off the plan's split and whose batch element 2
    is all pad; each repeated call must give the same bits."""
    from capreolus_tpu_torch.ops.simmat import knrm_plan, knrm_pool, knrm_pool_plain

    out = {}
    for label, shape, seed in (("serving", (100, 4, 800, 300), 1), ("small", (3, 5, 37, 20), 2),
                               ("all_pad_row", (5, 4, 803, 300), 3)):
        t0 = time.perf_counter()
        b, q, d, e = shape
        args = knrm_case(b, q, d, e, vocab=5000, seed=seed, device="cuda")
        if label == "all_pad_row":
            args[1][2] = 0.0  # a batch element whose doc positions are all pad, as knrm_inputs zeroes them
            args[3][2] = 0
        got = knrm_pool(*args)
        want = knrm_pool_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
        err = float((got - want).abs().max())
        check(err <= ERR_TOL, f"K1 {label}: max |kernel - plain| = {err:.3g} > {ERR_TOL}")
        check(torch.equal(knrm_pool(*args), got), f"K1 {label}: a repeated call gave other bits")
        out[label] = {"shape": f"B={b} Q={q} D={d} E={e} K={args[4].shape[0]}", "max_abs_err": err,
                      "splits": knrm_plan(d)}
        if label == "small" or label == "all_pad_row":
            out[label]["seconds"] = time.perf_counter() - t0
            print(f"[3 kernel] knrm_pool {label} {out[label]['shape']}, {out[label]['splits']} blocks per batch "
                  f"element: max|err| {err:.3g}, repeat bit-identical ({out[label]['seconds']:.2f} s)")
            continue
        ms = cuda_ms(lambda: knrm_pool(*args))
        # K1 takes about as much device time as its wrapper takes on the host: a CUDA graph's replay
        # shows the device time alone, as a note beside the back-to-back time that every kernel reports
        t_graph = time.perf_counter()
        ms_graph = graph_ms(lambda: knrm_pool(*args))
        t_graph = time.perf_counter() - t_graph
        plain_ms = cuda_ms(lambda: knrm_pool_plain(*args))
        bound_ms, bound_by = k1_bound_ms(args, peaks["bw"], peaks[torch.float32])
        out[label].update(ms=ms, graph_ms=ms_graph, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          seconds=time.perf_counter() - t0)
        print(f"[3 kernel] knrm_pool {label} {out[label]['shape']}, {out[label]['splits']} blocks per batch element: "
              f"max|err| {err:.3g}, repeat bit-identical, {ms:.4f} ms launched back to back ({ms_graph:.4f} ms "
              f"replayed from a CUDA graph; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}) "
              f"({out[label]['seconds']:.2f} s, {t_graph:.2f} s of it the graph's timing)")
    return out


def k2_bound_ms(q, mask, peaks):
    """Least time for K2 on these inputs, counted from the mask.

    A key that is masked adds nothing to a row that has an unmasked key, so
    the function needs, per batch element, only the k and v rows of its
    unmasked keys (all L of them where every key is masked: the mean of V),
    all of q, the output written once and the mask; those bytes go over the
    HBM rate. It does 4*D operations (two multiply-adds) per (query row,
    needed key) pair: in bf16 over the dense bf16 tensor-core rate; in f32 as
    the kernel does them, three TF32 products for each (split TF32), over the
    dense TF32 tensor-core rate. Returns (ms, "bytes" or "operations",
    cuda_core_ms): the last is the f32 bound at the CUDA cores' f32 rate (the
    bound of a CUDA-core design, for comparison), None in bf16."""
    b, h, l, d = q.shape
    e = q.element_size()
    keys = mask.sum(dim=1).double()
    keys = float(torch.where(keys > 0, keys, float(l)).sum())
    nbytes = 2.0 * b * h * l * d * e + 2.0 * h * d * e * keys + mask.numel() * mask.element_size()
    ops = 4.0 * h * l * d * keys
    t_bytes = nbytes / peaks["bw"]
    if q.dtype == torch.float32:
        t_ops = K2_TF32_PRODUCTS * ops / peaks["tf32"]
        cuda_core_ms = max(t_bytes, ops / peaks[torch.float32]) * 1e3
    else:
        t_ops, cuda_core_ms = ops / peaks[q.dtype], None
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), cuda_core_ms


def k2_time(q, k, v, mask, peaks):
    """K2, its plain version and the library call (SDPA with the same boolean
    mask, on the same views) at these inputs: CUDA-event ms of each, and the
    bound (with the CUDA-core figure beside it in f32)."""
    from torch.nn.functional import scaled_dot_product_attention

    from capreolus_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    sdpa_mask = mask[:, None, None, :]
    out = {"ms": cuda_ms(lambda: flash_attention(q, k, v, mask), rounds=5, calls=4),
           "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, mask), rounds=3, calls=2),
           "library_ms": cuda_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask),
                                 rounds=5, calls=4)}
    out["bound_ms"], out["bound_by"], out["bound_ms_cuda_core"] = k2_bound_ms(q, mask, peaks)
    return out


def k2_line(r):
    """K2's time beside SDPA, the plain version and the bound(s)."""
    line = (f"{r['ms']:.3f} ms (SDPA {r['library_ms']:.3f}, plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} "
            f"by {r['bound_by']}")
    if r["bound_ms_cuda_core"] is not None:
        line += f"; at the CUDA cores' f32 rate {r['bound_ms_cuda_core']:.3f}"
    return line + ")"


def k2_error(q, k, v, mask, rows=128):
    """max |K2 - plain| over the first ``rows`` batch elements (the plain
    version's [rows, H, L, L] scores stay small), after checking that K2's
    output is finite everywhere and written [B, L, H, D]."""
    from capreolus_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    got = flash_attention(q, k, v, mask)
    check(bool(torch.isfinite(got).all()), f"K2 {tuple(q.shape)} {q.dtype}: non-finite output")
    check(got.transpose(1, 2).is_contiguous(), f"K2 {tuple(q.shape)}: the output is not written [B, L, H, D]")
    want = attention_plain(q[:rows], k[:rows], v[:rows], mask[:rows])
    torch.cuda.synchronize()
    err = float((got[:rows].float() - want.float()).abs().max())
    check(err <= K2_TOL[q.dtype], f"K2 {tuple(q.shape)} {q.dtype}: max |kernel - plain| = {err:.3g} "
                                  f"> {K2_TOL[q.dtype]}")
    return err, got


def k2_heads(shape, gen, dtype=torch.float32):
    """q, k, v as the encoder hands them to K2: [B, H, L, D] views of
    [B, L, H * D] projection rows."""
    b, h, l, d = shape
    return [torch.randn(b, l, h * d, generator=gen, device="cuda").to(dtype).view(b, l, h, d).transpose(1, 2)
            for _ in range(3)]


def phase_k2_check(peaks):
    """K2 on the encoder's strided head views: at the served shape with every
    key unmasked in f32 and bf16 (timed beside SDPA, the plain version and the
    bound), at ColBERT's L = 32 and 180 with ragged key counts, and at a small
    ragged shape with a fully masked element (the mean of V), in both dtypes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    q, k, v = k2_heads(K2_SHAPE, gen)
    check(not q.is_contiguous() and q.stride(3) == 1, "K2's phase-3 inputs are not the encoder's head views")
    mask = torch.ones(K2_SHAPE[0], K2_SHAPE[2], dtype=torch.bool, device="cuda")
    out = {"shape": "B={} H={} L={} D={}".format(*K2_SHAPE), "layout": "heads: [B, L, H, D] rows, strided",
           "max_abs_err": k2_error(q, k, v, mask)[0]}
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))  # the same strides in bf16
    out["max_abs_err_bf16"] = k2_error(qb, kb, vb, mask)[0]

    # small ragged case: L off the tile size, ragged key counts, one fully masked element
    small = (3, 2, 77, 32)
    ms = torch.arange(small[2], device="cuda")[None, :] < torch.tensor([[60], [5], [0]], device="cuda")
    for dtype, key in ((torch.float32, "max_abs_err_small"), (torch.bfloat16, "max_abs_err_small_bf16")):
        qs, ks, vs = k2_heads(small, gen, dtype)
        out[key], got = k2_error(qs, ks, vs, ms)
        mean_v = vs[-1].float().mean(dim=1, keepdim=True).expand_as(vs[-1])
        check(float((got[-1].float() - mean_v).abs().max()) <= K2_TOL[dtype],
              f"K2 {dtype}: a fully masked row is not mean(V)")
    # ColBERT's lengths: 32-token queries, 180-token docs, ragged key counts
    for l in (COLBERT["maxqlen"], COLBERT["maxdoclen"]):
        shape = (64, 12, l, 64)
        lens = torch.randint(1, l + 1, (shape[0], 1), generator=gen, device="cuda")
        ml = torch.arange(l, device="cuda")[None, :] < lens
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            out[f"max_abs_err_l{l}{suffix}"] = k2_error(*k2_heads(shape, gen, dtype), ml)[0]

    out.update(k2_time(q, k, v, mask, peaks))
    bf16 = k2_time(qb, kb, vb, mask, peaks)
    out.update({f"{key}_bf16": value for key, value in bf16.items() if key != "bound_ms_cuda_core"})
    print(f"[3 kernel] flash_attention {out['shape']} on head views, every key unmasked: max|err| f32 "
          f"{out['max_abs_err']:.3g}, bf16 {out['max_abs_err_bf16']:.3g} (small ragged {out['max_abs_err_small']:.3g} "
          f"/ {out['max_abs_err_small_bf16']:.3g}; L=32 {out['max_abs_err_l32']:.3g} / {out['max_abs_err_l32_bf16']:.3g}; "
          f"L=180 {out['max_abs_err_l180']:.3g} / {out['max_abs_err_l180_bf16']:.3g}); f32 {k2_line(out)}; "
          f"bf16 {k2_line(bf16)}")
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
        check(all(np.isfinite(s) for _, s in gpu), f"query {qi}: a GPU score is not finite: {gpu}")
        for rank, ((_, gs), (_, cs)) in enumerate(zip(gpu, cpu)):
            check(abs(gs - cs) <= ERR_TOL, f"query {qi} rank {rank}: GPU score {gs} vs CPU score {cs}")
        # a different doc at a rank is allowed only for a near-tie swap
        faults = ranking_faults(gpu, cpu, ERR_TOL)
        check(not faults, f"query {qi}: GPU vs CPU reranked top 10: {faults}")
    print(f"[4 serving] {len(queries)} queries: first stage identical on GPU and CPU; reranked "
          f"top-10 agree within {ERR_TOL} (top hit of query 0: {gpu_results[0][0]})")
    return launches, corpus_dir, topics


def check_no_head_copies(profiled, num_layers, label):
    """A served BERT request makes no per-layer copy: K2 reads the heads as
    views of the projections and writes [B, L, H, D], so neither the head
    split nor the merge copies (done by copies, they cost four copy kernels
    per layer). The request's few copies (casts of its inputs) stay below one
    per layer."""
    check(profiled["copy_kernels"] < num_layers,
          f"{label}: {profiled['copy_kernels']} copy kernels in one request of {num_layers} layers: a per-layer "
          f"head split or merge copy is back")


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
    served run, K2 on a served request's layer-0 inputs, what the int8 phase
    reuses: the checkpoint, query 0's served scores of all topn docs and the
    served top 10s)."""
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
    profiled = profile_request(svc, queries[0], label)
    check_no_head_copies(profiled, config.num_layers, label)

    # K2 at the served path's own inputs: layer 0 of query 0's request, the
    # encoder's head views as they are, then the same views in bf16
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
        check(not q.is_contiguous(), f"{label}: the encoder's heads are no longer views of its projections")
        served = {"shape": "B={} H={} L={} D={}".format(*q.shape), "layout": "heads: [B, L, H, D] rows, strided",
                  "max_abs_err": k2_error(q, k, v, mask)[0], "unmasked_key_share": float(mask.float().mean())}
        served.update(k2_time(q, k, v, mask, peaks))
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        bf16 = {"max_abs_err": k2_error(qb, kb, vb, mask)[0], **k2_time(qb, kb, vb, mask, peaks)}
        served.update({f"{key}_bf16": value for key, value in bf16.items() if key != "bound_ms_cuda_core"})
        del q, k, v, qb, kb, vb
    served["profiled"] = profiled
    print(f"{label} flash_attention on a served request's layer-0 head views ({served['shape']}, "
          f"{100 * served['unmasked_key_share']:.1f}% of keys unmasked): max|err| {served['max_abs_err']:.3g}, "
          f"f32 {k2_line(served)}; in bf16 max|err| {bf16['max_abs_err']:.3g}, {k2_line(bf16)}; peak device memory "
          f"of the served run {peak_gb:.1f} GB")

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
    return launches, served, {"ckpt": ckpt, "scores0": served_scores, "results": results}


def phase_bert_int8_serving(workdir, corpus_dir, topics, f32):
    """monoBERT-MaxP with quantize=int8 over phase 5's corpus, caches and
    checkpoint; returns the launches of X1 (by epilogue mode), Q1 and K2 in
    the served run."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul
    from capreolus_tpu_torch.ops.quantization import quantize_per_token
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService, RetrievalService

    label = "[5b monobert int8]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")  # phase 5's index and extractor caches
    coll = {"name": "dummy", "path": corpus_dir}
    rr_cfg = {"pretrained": "bert-base-uncased", "allowrandominit": True, "quantize": "int8",
              "extractor": {"index": {"collection": coll}}}
    t0 = time.perf_counter()
    index = Index.create("tpu", {"collection": coll})
    index.create_index()
    reranker = Reranker.create("BERTMaxP", rr_cfg)
    svc = RerankingService(index, reranker, f32["ckpt"], topn=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    queries = topics[:BERT_QUERIES]
    check(svc._calibrate_pending, "the int8 service has stats before its first request")
    t0 = time.perf_counter()
    svc.search(topics[BERT_QUERIES:BERT_QUERIES + 1], k=10)  # warm-up request: calibrates on its batch
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(not svc._calibrate_pending, "the first request did not calibrate the int8 scales")
    model = svc.reranker.model
    amax = torch.stack([getattr(model.bert, f"layer_{i}").gelu_amax for i in range(model.config.num_layers)])
    check(bool((amax > 0).all()) and bool(torch.isfinite(amax).all()), "calibrated gelu_amax has zero or non-finite")
    print(f"{label} set-up: service {t_service:.1f} s (phase 5's caches); warm-up request with calibration "
          f"{warm_ms:.1f} ms; gelu_amax over 12 layers {float(amax.min()):.3f}-{float(amax.max()):.3f}")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    request_ms, rerank_ms, features_ms, results = [], [], [], []
    for query in queries:
        t0 = time.perf_counter()
        results.append(svc.search([query], k=10)[0])
        request_ms.append((time.perf_counter() - t0) * 1e3)
        rerank_ms.append(svc.last_stage_ms["rerank"])
        features_ms.append(svc.last_stage_ms["features"])
    launches = {"int8_matmul": int8_matmul.launches, "flash_attention": flash_attention.launches,
                "int8_matmul_modes": dict(int8_matmul.mode_launches), "quantize_per_token": quantize_per_token.launches,
                "pad_copies": int8_matmul.pad_copies}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} per request (median of {len(queries)}): {np.median(request_ms):.2f} ms total, rerank "
          f"{np.median(rerank_ms):.2f} ms, of which the host's features {np.median(features_ms):.2f} ms (each "
          f"request: {', '.join(f'{t:.1f}' for t in request_ms)} ms); peak device memory of the served run "
          f"{peak_gb:.2f} GB ({PR4_INT8_PEAK_GB} GB before the fused epilogues); launches in the run: int8_matmul "
          f"{launches['int8_matmul']} (by epilogue {launches['int8_matmul_modes']}), quantize_per_token "
          f"{launches['quantize_per_token']}, flash_attention {launches['flash_attention']}; zero-padded copies "
          f"{launches['pad_copies']}")
    check(launches["int8_matmul"] == X1_PER_REQUEST * len(queries),
          f"int8_matmul launched {launches['int8_matmul']} times for {len(queries)} queries (expected "
          f"{X1_PER_REQUEST} per query)")
    want_modes = {mode: n * len(queries) for mode, n in X1_MODES_PER_REQUEST.items()}
    check(launches["int8_matmul_modes"] == want_modes,
          f"int8_matmul epilogue modes {launches['int8_matmul_modes']}, expected {want_modes}")
    check(launches["quantize_per_token"] == Q1_PER_REQUEST * len(queries),
          f"quantize_per_token launched {launches['quantize_per_token']} times for {len(queries)} queries "
          f"(expected {Q1_PER_REQUEST} per query)")
    check(launches["pad_copies"] == 0, f"{launches['pad_copies']} zero-padded operand copies on the served path")
    check(launches["flash_attention"] == model.config.num_layers * len(queries),
          f"flash_attention launched {launches['flash_attention']} times in the int8 run")
    check(all(len(hits) == 10 and all(np.isfinite(s) for _, s in hits) for hits in results),
          "a served int8 request did not return 10 finite scores")
    profiled = profile_request(svc, queries[0], label)
    check_no_head_copies(profiled, model.config.num_layers, label)

    # int8 against f32 on the same request: every reranked doc's score, and the top 10
    int8_scores = dict(svc.search([queries[0]], k=svc.topn)[0])
    gap = max(abs(int8_scores[d] - s) for d, s in f32["scores0"].items())
    overlap = len({d for d, _ in results[0]} & {d for d, _ in f32["results"][0]})
    spread = max(f32["scores0"].values()) - min(f32["scores0"].values())

    # query 0's two top first-stage candidates, the card against the CPU with the same weights and
    # stats. int8 makes each layer a step function of its input: where the two devices' f32
    # LayerNorm, softmax and GELU round apart, a code on a rounding boundary flips by one step, and
    # over 12 layers the flips add up (measured below: the card's own scores move about as much when
    # the embeddings move by 1e-7). So the CPU runs each layer from the card's input to that layer.
    hits = RetrievalService.search_async(svc, [queries[0]], k=svc.topn)()[0]
    docids = [d for d, _ in hits[:2]]
    batch = svc.rerank_batch("smoke_int8", queries[0], docids)
    cpu_reranker = Reranker.create("BERTMaxP", rr_cfg)
    cpu_model = cpu_reranker.build_model().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    seq_len = batch["pos_bert_input"].shape[-1]
    ids, seg, mask = (torch.from_numpy(batch[key].reshape(-1, seq_len)) for key in ("pos_bert_input", "pos_seg",
                                                                                    "pos_mask"))
    doc_mask = torch.from_numpy(batch["pos_mask"])

    def doc_scores(scorer, rr, hidden):
        raw = scorer.classifier(torch.tanh(scorer.bert.pooler(hidden[:, 0])).float())[:, 0]
        return rr._head_scores(raw.reshape(doc_mask.shape[:2]), doc_mask.to(hidden.device))

    def run_layers(hidden, keys):
        for i in range(model.config.num_layers):
            hidden = getattr(model.bert, f"layer_{i}")(hidden, keys)
        return hidden

    t0 = time.perf_counter()
    layer_err = []
    with torch.inference_mode():
        gpu_two = svc.reranker.test(batch, svc.device).cpu().numpy()
        keys = mask.bool().cuda()
        hidden0 = model.bert.embed(ids.cuda(), seg.cuda())
        hidden = hidden0
        for i in range(model.config.num_layers):
            out = getattr(model.bert, f"layer_{i}")(hidden, keys)
            want = getattr(cpu_model.bert, f"layer_{i}")(hidden.cpu(), keys.cpu())
            layer_err.append(float((out.cpu() - want).abs().max()))
            hidden = out
        head_two = doc_scores(cpu_model, cpu_reranker, hidden.cpu()).numpy()
        cpu_two = cpu_reranker.test(batch, "cpu").numpy()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        moved = hidden0 * (1 + 1e-7 * torch.randn(hidden0.shape, generator=gen, device="cuda"))
        moved_two = doc_scores(model, svc.reranker, run_layers(moved, keys)).cpu().numpy()
    cpu_s = time.perf_counter() - t0
    err_head = float(np.abs(gpu_two - head_two).max())
    err_e2e = float(np.abs(gpu_two - cpu_two).max())
    moved_err = float(np.abs(gpu_two - moved_two).max())
    check(max(layer_err) <= INT8_LAYER_TOL, f"int8 BERT-base layers, GPU vs CPU from the same input: max |err| "
                                            f"per layer {layer_err}")
    check(err_head <= BERT_CPU_TOL, f"int8 BERT-base scores of {docids} from the card's last hidden states: GPU "
                                    f"{gpu_two} vs CPU head {head_two}")
    print(f"{label} query 0's top-2 first-stage docs {docids}, GPU vs CPU ({cpu_s:.1f} s with the CPU): each layer "
          f"from the card's input, max |err| {max(layer_err):.3g} (per layer {', '.join(f'{x:.2g}' for x in layer_err)};"
          f" tolerance {INT8_LAYER_TOL}); scores from the card's last layer {err_head:.3g} (tolerance {BERT_CPU_TOL}); end to end GPU {gpu_two.tolist()} "
          f"vs CPU {cpu_two.tolist()}: {err_e2e:.3g}, and the card's scores with the embeddings moved by 1e-7: "
          f"{moved_err:.3g} (reported, not pinned)")
    print(f"{label} int8 vs f32 on query 0's {len(f32['scores0'])} docs: max |gap| {gap:.4g} (f32 scores spread over "
          f"{spread:.4g}), top-10 overlap {overlap}/10")
    del svc, model, cpu_model, hidden, hidden0, moved
    torch.cuda.empty_cache()
    return launches, {"request_ms": float(np.median(request_ms)), "max_abs_err_layer": max(layer_err),
                      "max_abs_err_head": err_head, "max_abs_err_end_to_end": err_e2e,
                      "end_to_end_moved_1e-7": moved_err, "int8_f32_gap": gap, "top10_overlap_f32": overlap,
                      "peak_gb": peak_gb, "profiled": profiled}


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
    check(torch.equal(maxsim(q, docs_t, bias_t, valid), got), f"{label}: a repeated call gave other bits")
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)), f"{label}: -inf entries differ from plain")
    finite = torch.isfinite(want)
    check(bool(torch.isfinite(got[finite]).all()), f"{label}: non-finite score of a valid doc")
    err = float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0
    check(err <= K3_TOL, f"{label}: max |kernel - plain| = {err:.3g} > {K3_TOL}")
    q2d = q.to(torch.bfloat16).reshape(-1, q.shape[2])
    d2d = docs_t.view(-1, docs_t.shape[2])
    big = q.shape[0] > 1
    out = {"shape": label[3:], "max_abs_err": err, "plan": k3_plan(q, docs_t),
           "ms": cuda_ms(lambda: maxsim(q, docs_t, bias_t, valid), rounds=5 if big else 25, calls=4 if big else 20),
           "plain_ms": cuda_ms(lambda: maxsim_scores_plain(q, docs_t, bias_t, valid), rounds=3, calls=2),
           "product_gemm_ms": cuda_ms(lambda: torch.matmul(q2d, d2d.T), rounds=5, calls=4)}
    out["bound_ms"], out["bound_by"] = k3_bound_ms(q, docs_t, bias_t, valid, peaks)
    out["valid_token_share"] = float(((bias_t >= 0) & valid[None, :]).float().mean())
    return out


def k3_plan(q, docs_t):
    """K3's launch plan for these inputs on this card (ops/maxsim.py::maxsim_plan)."""
    from capreolus_tpu_torch.ops.maxsim import maxsim_plan

    return maxsim_plan(q.shape[0], q.shape[1], docs_t.shape[0], docs_t.shape[1],
                       sms=torch.cuda.get_device_properties(0).multi_processor_count)


def k3_line(label, r):
    plan = r["plan"]
    return (f"{label} {r['shape']}: {plan['blocks']} blocks of {plan['warpgroups']} warpgroup(s), "
            f"{plan['splits']} Ld split(s); max|err| {r['max_abs_err']:.3g}, repeat bit-identical, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
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

    # ragged cases: the small one (3 queries of 5 tokens, 11 docs of 7 tokens, dim 24, doc 4 fully masked);
    # one across the row tile (65 rows), the doc tile (C = 2,011), the Ld split (Ld = 181) and a cluster of
    # 8, at dim 128; queries of 200 tokens (64-row chunks, two passes) at dim 20 (plain loads)
    for label, (nq, lq, ld, c, dim) in (("small", (3, 5, 7, 11, 24)), ("edges", (5, 13, 181, 2011, 128)),
                                         ("chunked", (2, 200, 9, 131, 20))):
        t0 = time.perf_counter()
        q, docs = unit(nq, lq, dim), unit(ld, c, dim).to(torch.bfloat16)
        small_mask = torch.rand(ld, c, generator=gen, device="cuda") > 0.3
        small_mask[:, 4] = False  # a fully masked doc
        small_mask[:, 5] = False
        small_mask[ld - 1, 5] = True  # a doc whose only valid token is its last
        small_mask[0, [0, 1, 2, 3, 6, 7, 8, 9, 10]] = True
        bias_s = torch.where(small_mask, 0.0, MASKED_BIAS).float().contiguous()
        valid_s = small_mask.any(dim=0).contiguous()
        got, want = maxsim(q, docs, bias_s, valid_s), maxsim_scores_plain(q, docs, bias_s, valid_s)
        torch.cuda.synchronize()
        check(bool(torch.isneginf(got[:, 4]).all()) and torch.equal(torch.isneginf(got), torch.isneginf(want)),
              f"K3 {label}: the fully masked doc is not -inf in kernel and plain alike")
        check(torch.equal(maxsim(q, docs, bias_s, valid_s), got), f"K3 {label}: a repeated call gave other bits")
        finite = torch.isfinite(want)
        err = float((got[finite] - want[finite]).abs().max())
        check(err <= K3_TOL, f"K3 {label}: max |kernel - plain| = {err:.3g}")
        plan = k3_plan(q, docs)
        out["max_abs_err_small" if label == "small" else f"max_abs_err_{label}"] = err
        print(f"[3 kernel] maxsim {label} Q={nq} Lq={lq} Ld={ld} C={c} dim={dim} ({plan['blocks']} blocks of "
              f"{plan['warpgroups']} warpgroup(s), {plan['splits']} Ld split(s), {plan['passes']} pass(es)), doc 4 "
              f"fully masked, doc 5 only its last token: -inf matches, repeat bit-identical, max|err| {err:.3g} "
              f"(tolerance {K3_TOL}) ({time.perf_counter() - t0:.2f} s)")
    return out


# ---------------------------------------------------------------- X1 (int8 GEMM)
X1_EPILOGUE_OPS = {"int32": 0, "f32": 3, "int8_gelu": 12}  # f32 operations per output: the
# dequantization's two products and sum; for int8-gelu those, 8 of the tanh GELU and the division
X1_OUT_BYTES = {"int32": 4, "f32": 4, "int8_gelu": 1}


def x1_bound_ms(m, k, n, peaks, mode="int32"):
    """Least time for X1 at [M, K] x [N, K]^T in an epilogue mode: each int8
    input read once, the output written once (4 bytes in int32 and f32 mode, 1
    in int8-gelu) and the epilogue's vectors read once (x_scales [M], w_scales
    and bias [N], and out_scales [N] in int8-gelu) over the HBM rate; 2*M*N*K
    operations over the dense int8 tensor-core peak, and the epilogue's f32
    operations over the f32 peak. Returns (ms, "bytes" or "operations")."""
    vectors = {"int32": 0, "f32": 4.0 * m + 8.0 * n, "int8_gelu": 4.0 * m + 12.0 * n}[mode]
    t_bytes = (m * k + n * k + X1_OUT_BYTES[mode] * m * n + vectors) / peaks["bw"]
    t_ops = max(2.0 * m * n * k / peaks[torch.int8], X1_EPILOGUE_OPS[mode] * m * n / peaks[torch.float32])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def x1_vectors(m, n, gen):
    """x_scales [M], w_scales, bias and GELU out_scales [N] at the magnitudes of
    a served BERT-base layer: int32 products of about 1e5 dequantize to a few
    units, and the GELU codes spread over the int8 range."""
    return {"x_scales": torch.rand(m, generator=gen, device="cuda") * 0.04 + 0.01,
            "w_scales": torch.rand(n, generator=gen, device="cuda") * 8e-4 + 2e-4,
            "bias": torch.randn(n, generator=gen, device="cuda") * 0.1,
            "out_scales": (torch.rand(n, generator=gen, device="cuda") * 8 + 2) / 127}


def gelu_flips(got, want):
    """(largest code difference, codes that differ) between two int8 tensors."""
    diff = (got.int() - want.int()).abs()
    return int(diff.max()), int((diff > 0).sum())


def x1_served_shapes():
    """(label, M, K, N) of every int8 product on the served paths: monoBERT's,
    and ColBERT's as the quantized engine chunks the served corpus
    (``quantized_chunk_docs``) for one query and for a 64-query batch, a last,
    shorter chunk included where the docs do not fill it."""
    from capreolus_tpu_torch.searcher.late_interaction import quantized_chunk_docs

    lq, ld, dim = COLBERT["maxqlen"], COLBERT["maxdoclen"], COLBERT["dim"]
    shapes = list(X1_BERT_SERVED)
    for nq in (1, 64):
        step = min(quantized_chunk_docs(nq, lq, ld), SERVING_DOCS)
        shapes.append((f"colbert_q{nq}", nq * lq, dim, step * ld))
        if SERVING_DOCS % step:
            shapes.append((f"colbert_q{nq}_last", nq * lq, dim, SERVING_DOCS % step * ld))
    return shapes


def phase_x1_check(peaks):
    """X1 at the served shapes on seeded int8 codes over the full range: the
    int32 epilogue exactly against the plain version on the first
    X1_CHECK_ROWS rows (all rows of the ColBERT products) at both tile widths;
    at the BERT shapes the f32 epilogue bit-identical and, at the
    up-projection, the int8-gelu codes within one step; every epilogue at small
    ragged shapes. Returns {label: numbers}."""
    from capreolus_tpu_torch.ops.int8_matmul import (TILE_N, int8_linear, int8_linear_gelu, int8_linear_gelu_plain,
                                                     int8_linear_plain, int8_matmul, int8_matmul_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    out = {}
    for label, m, k, n in x1_served_shapes():
        a, w = codes(m, k), codes(n, k)
        a[0], w[0] = -128, -128
        rows = min(m, X1_CHECK_ROWS)
        want = int8_matmul_plain(a[:rows], w)
        for tile_n in (128, 256):
            got = int8_matmul(a, w, tile_n=tile_n)
            exact = torch.equal(got[:rows], want)
            torch.cuda.synchronize()
            check(exact, f"X1 {label} [{m} x {k}] x [{n} x {k}]^T, tile {tile_n}: int32 differs from plain on the "
                         f"first {rows} rows")
            check(int(got[0, 0]) == 128 * 128 * k, f"X1 {label}: the -128 x -128 row sums to {int(got[0, 0])}")
            del got
        del want
        wt = w.t()  # torch._int_mm takes [K, N]: w's transposed view, the layout cuBLASLt's IMMA prefers
        r = {"shape": f"M={m} K={k} N={n}", "max_abs_err": 0, "tile_n": TILE_N["int32"],
             "ms_tile_128": cuda_ms(lambda: int8_matmul(a, w, tile_n=128), rounds=5, calls=4),
             "ms_tile_256": cuda_ms(lambda: int8_matmul(a, w, tile_n=256), rounds=5, calls=4),
             "plain_ms": cuda_ms(lambda: int8_matmul_plain(a, w), rounds=3, calls=1),
             "library_ms": cuda_ms(lambda: torch._int_mm(a, wt), rounds=5, calls=4)}
        r["ms"] = r[f"ms_tile_{TILE_N['int32']}"]
        r["bound_ms"], r["bound_by"] = x1_bound_ms(m, k, n, peaks)
        print(f"[3 kernel] int8_matmul int32 {label} {r['shape']}: exact on {rows} rows at both tiles; {r['ms']:.4f} ms "
              f"(tile 128 {r['ms_tile_128']:.4f}, 256 {r['ms_tile_256']:.4f}; plain {r['plain_ms']:.3f}, "
              f"torch._int_mm {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']})")
        if label in {served[0] for served in X1_BERT_SERVED}:
            vec = x1_vectors(m, n, gen)
            f32_args = (a, w, vec["w_scales"], vec["bias"], vec["x_scales"])
            got = int8_linear(*f32_args)
            same = torch.equal(got[:rows], int8_linear_plain(a[:rows], *f32_args[1:4], vec["x_scales"][:rows]))
            torch.cuda.synchronize()
            check(same, f"X1 {label}: the f32 epilogue is not bit-identical to plain on the first {rows} rows")
            del got
            f32 = {"max_abs_err": 0.0, "tile_n": TILE_N["f32"],
                   "plain_ms": cuda_ms(lambda: int8_linear_plain(*f32_args), rounds=3, calls=1),
                   "library_ms": None}  # no single PyTorch call computes the fused dequantization
            for tile_n in (128, 256):
                f32[f"ms_tile_{tile_n}"] = cuda_ms(lambda: int8_linear(*f32_args, tile_n=tile_n), rounds=5, calls=4)
            f32["ms"] = f32[f"ms_tile_{TILE_N['f32']}"]
            f32["bound_ms"], f32["bound_by"] = x1_bound_ms(m, k, n, peaks, "f32")
            r["f32"] = f32
            line = (f"[3 kernel] int8_matmul f32 epilogue {label}: bit-identical on {rows} rows; {f32['ms']:.4f} ms "
                    f"(tile 128 {f32['ms_tile_128']:.4f}, 256 {f32['ms_tile_256']:.4f}; plain {f32['plain_ms']:.3f}, "
                    f"bound {f32['bound_ms']:.4f} by {f32['bound_by']})")
            if label == "intermediate":
                gelu_args = (a, w, vec["w_scales"], vec["bias"], vec["out_scales"], vec["x_scales"], "tanh")
                got = int8_linear_gelu(*gelu_args)
                step, flips = gelu_flips(got[:rows], int8_linear_gelu_plain(a[:rows], *gelu_args[1:5],
                                                                            vec["x_scales"][:rows], "tanh"))
                check(step <= 1 and flips <= GELU_FLIP_SHARE * rows * n,
                      f"X1 {label}: int8-gelu codes differ from plain by up to {step} in {flips} of {rows * n}")
                del got
                gelu = {"max_code_step": step, "codes_differing": flips, "codes_compared": rows * n,
                        "tile_n": TILE_N["int8_gelu"],
                        "plain_ms": cuda_ms(lambda: int8_linear_gelu_plain(*gelu_args), rounds=3, calls=1),
                        "library_ms": None}  # no single PyTorch call computes GELU's requantization
                for tile_n in (128, 256):
                    gelu[f"ms_tile_{tile_n}"] = cuda_ms(lambda: int8_linear_gelu(*gelu_args, tile_n=tile_n),
                                                        rounds=5, calls=4)
                gelu["ms"] = gelu[f"ms_tile_{TILE_N['int8_gelu']}"]
                gelu["bound_ms"], gelu["bound_by"] = x1_bound_ms(m, k, n, peaks, "int8_gelu")
                r["int8_gelu"] = gelu
                line += (f"; int8-gelu (tanh) epilogue: {flips} of {rows * n} codes differ by one step, "
                         f"{gelu['ms']:.4f} ms (tile 128 {gelu['ms_tile_128']:.4f}, 256 {gelu['ms_tile_256']:.4f}; "
                         f"plain {gelu['plain_ms']:.3f}, bound {gelu['bound_ms']:.4f} by {gelu['bound_by']})")
            print(line)
            del vec, f32_args
        out[label] = r
        del a, w, wt
        torch.cuda.empty_cache()

    # small ragged shapes: every epilogue, both tiles, both GELU forms
    pads = 0
    for m, k, n, misaligned in ((37, 45, 29, False), (130, 64, 257, True), (5, 300, 7, False), (32, 128, 300, False),
                                (129, 3072, 200, False), (1, 16, 1, False)):
        a, w = codes(m, k), codes(n, k)
        a[0, ::2], w[0] = -128, -128
        if misaligned:  # an operand one byte off a 16-byte boundary takes a zero-padded copy
            shifted = torch.empty(a.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(a.shape)
            a = shifted.copy_(a)
        vec = x1_vectors(m, n, gen)
        before = int8_matmul.pad_copies
        for tile_n in (128, 256):
            check(torch.equal(int8_matmul(a, w, tile_n=tile_n), int8_matmul_plain(a, w)),
                  f"X1 small [{m} x {k}] x [{n} x {k}]^T, tile {tile_n}: int32 differs from plain")
            for xs in (vec["x_scales"], None):
                args = (a, w, vec["w_scales"], vec["bias"], xs)
                check(torch.equal(int8_linear(*args, tile_n=tile_n), int8_linear_plain(*args)),
                      f"X1 small [{m} x {k}] x [{n} x {k}]^T, tile {tile_n}: f32 differs from plain")
            for approximate in ("tanh", "none"):
                args = (a, w, vec["w_scales"], vec["bias"], vec["out_scales"], vec["x_scales"], approximate)
                step, _ = gelu_flips(int8_linear_gelu(*args, tile_n=tile_n), int8_linear_gelu_plain(*args))
                check(step <= 1, f"X1 small [{m} x {k}] x [{n} x {k}]^T: {approximate} GELU codes {step} steps off")
        copies = int8_matmul.pad_copies - before
        want_copies = 2 * 2 * 5 * (k % 16 != 0) + 2 * 5 * (misaligned and k % 16 == 0)
        check(copies == want_copies, f"X1 small [{m} x {k}]: {copies} zero-padded copies, expected {want_copies}")
        pads += copies
        torch.cuda.synchronize()
    print(f"[3 kernel] int8_matmul small ragged shapes [37 x 45] x [29 x 45]^T, [130 x 64] x [257 x 64]^T "
          f"(misaligned), [5 x 300] x [7 x 300]^T, [32 x 128] x [300 x 128]^T, [129 x 3072] x [200 x 3072]^T, "
          f"[1 x 16] x [1 x 16]^T, with -128, both tiles: int32 exact, f32 bit-identical with and without x_scales, "
          f"tanh and erf GELU codes within one step; {pads} zero-padded copies, as expected")
    return out


def q1_bound_ms(m, k, peaks):
    """Least time for Q1 at [M, K]: the f32 input read once, the int8 codes and
    the f32 scales written once, over the HBM rate; 4 f32 operations per value
    (abs, max, division, rounding) over the f32 peak. Returns (ms, "bytes" or
    "operations")."""
    t_bytes = (5.0 * m * k + 4.0 * m) / peaks["bw"]
    t_ops = 4.0 * m * k / peaks[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_q1_check(peaks):
    """Q1 exactly against its plain version at the served [409,600 x 768]
    (N(0, 9) values, an all-zero token) and at ragged shapes (K off 4, K above
    the register path's 1024, a 3-D input)."""
    from capreolus_tpu_torch.ops.quantization import quantize_per_token, quantize_per_token_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    for shape in ((37, 45), (5, 3000), (3, 1028), (2, 16, 64), (1, 1)):
        x = torch.randn(shape, generator=gen, device="cuda") * 3
        (q, s), (wq, ws) = quantize_per_token(x), quantize_per_token_plain(x)
        check(torch.equal(q, wq) and torch.equal(s, ws), f"Q1 {shape}: differs from plain")
    m, k = X1_BERT_SERVED[0][1], X1_BERT_SERVED[0][2]
    x = torch.randn(m, k, generator=gen, device="cuda") * 3
    x[1] = 0.0
    (q, s), (wq, ws) = quantize_per_token(x), quantize_per_token_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(q, wq) and torch.equal(s, ws), f"Q1 [{m} x {k}]: differs from plain")
    out = {"shape": f"M={m} K={k}", "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: quantize_per_token(x), rounds=5, calls=4),
           "plain_ms": cuda_ms(lambda: quantize_per_token_plain(x), rounds=3, calls=2),
           "library_ms": None}  # no single PyTorch call computes per-token quantization
    out["bound_ms"], out["bound_by"] = q1_bound_ms(m, k, peaks)
    print(f"[3 kernel] quantize_per_token {out['shape']}: codes and scales exact (and at 5 ragged shapes); "
          f"{out['ms']:.4f} ms (plain {out['plain_ms']:.3f}, bound {out['bound_ms']:.4f} by {out['bound_by']})")
    del x, q, s, wq, ws
    torch.cuda.empty_cache()
    return out


def phase_scales_check():
    """The int8 scales besides Q1's, computed on the card and on the CPU from
    the same values: the weight scales (``Int8Linear.quantize_weight``, with
    and without folded GELU scales) of a BERT-base projection and FFN
    down-projection, the GELU scales (``BertLayer.gelu_scales``) and the
    ColBERT query scales (``quantize_rows_torch``) of a 64-query batch must be
    equal bit for bit, as must the codes: each divides by a tensor of 127s."""
    import dataclasses

    from capreolus_tpu_torch.ops.quantization import quantize_rows_torch
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.reranker.bert.encoder import BertLayer

    config = dataclasses.replace(get_bert_config("bert-base-uncased"), num_layers=1, quantize="int8")
    rng = np.random.Generator(np.random.PCG64(11))
    cpu = BertLayer(config)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.from_numpy((rng.standard_normal(tuple(p.shape)) * 0.02).astype(np.float32)))
    amax = torch.from_numpy(rng.random(config.intermediate_size).astype(np.float32) * 10)
    amax[::7] = 0.0  # uncalibrated channels take amax 8
    cpu.gelu_amax = amax  # requantizes ffn_output with the GELU scales folded in
    gpu = BertLayer(config).cuda()
    gpu.load_state_dict(cpu.state_dict())
    gpu.gelu_amax = amax.cuda()
    for layer in (cpu, gpu):
        layer.attention.query.quantize_weight()
    pairs = {"weight": (gpu.attention.query, cpu.attention.query), "weight_folded": (gpu.ffn_output, cpu.ffn_output)}
    differing = {name: int((g.weight_scale.cpu() != c.weight_scale).sum()) + int((g.weight_q.cpu() != c.weight_q).sum())
                 for name, (g, c) in pairs.items()}
    differing["gelu"] = int((gpu.gelu_scales().cpu() != cpu.gelu_scales()).sum())
    queries = torch.from_numpy(rng.standard_normal((64, COLBERT["maxqlen"], COLBERT["dim"])).astype(np.float32))
    (codes, scales), (gcodes, gscales) = quantize_rows_torch(queries), quantize_rows_torch(queries.cuda())
    differing["colbert_query"] = int((gscales.cpu() != scales).sum()) + int((gcodes.cpu() != codes).sum())
    check(not any(differing.values()), f"int8 scales or codes differ between the card and the CPU: {differing}")
    print(f"[3 scales] weight ({tuple(cpu.attention.query.weight.shape)}, and ffn_output with folded GELU scales), GELU "
          f"({config.intermediate_size} channels) and ColBERT query (64 x {COLBERT['maxqlen']} x {COLBERT['dim']}) "
          f"scales and codes: card equals CPU bit for bit")
    return differing


def reset_launch_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul
    from capreolus_tpu_torch.ops.maxsim import maxsim
    from capreolus_tpu_torch.ops.quantization import quantize_per_token
    from capreolus_tpu_torch.ops.simmat import knrm_pool

    knrm_pool.launches = flash_attention.launches = maxsim.launches = int8_matmul.launches = 0
    quantize_per_token.launches = int8_matmul.pad_copies = 0
    int8_matmul.mode_launches = dict.fromkeys(int8_matmul.mode_launches, 0)


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
    return launches, served, {"ckpt": ckpt, "top10": results[0], "batch": batch}


def colbert_x1_launches(n_queries, n_docs):
    """X1 launches of one quantized query batch: one per chunk of docs."""
    from capreolus_tpu_torch.searcher.late_interaction import quantized_chunk_docs

    return -(-n_docs // quantized_chunk_docs(n_queries, COLBERT["maxqlen"], COLBERT["maxdoclen"]))


def ranking_faults(a_hits, b_hits, tol):
    """Where two (docid, score) rankings of the same query part beyond
    near-ties, as messages (none when they agree): each doc in both lists
    scores within ``tol`` in both, and where the lists hold different docs at a
    rank, the two docs tie within ``tol`` in each list (a doc missing from the
    other list, past its cut, takes its own score there)."""
    a_of, b_of = dict(a_hits), dict(b_hits)
    faults = [f"{d}: {a_of[d]} vs {b_of[d]}" for d in a_of if d in b_of and abs(a_of[d] - b_of[d]) > tol]
    for rank, ((da, sa), (db, sb)) in enumerate(zip(a_hits, b_hits)):
        if da != db and (abs(b_of.get(da, sa) - sb) > tol or abs(a_of.get(db, sb) - sa) > tol):
            faults.append(f"rank {rank}: {da} {sa} vs {db} {sb}, not a near-tie")
    return faults


def phase_colbert_int8_serving(workdir, corpus_dir, topics, none):
    """ColBERT over phase 6's doc-embedding cache with quantize=int8, then one
    int4 + rescore query; returns the X1 launches of each run and numbers."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.reranker.colbert import ColBERTModel
    from capreolus_tpu_torch.convert import bert_state_dict, load_params
    from capreolus_tpu_torch.searcher import Searcher
    from capreolus_tpu_torch.searcher.late_interaction import quantized_maxsim_scores
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    label = "[6b colbert int8]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_colbert")  # phase 6's doc-embedding cache
    config = get_bert_config("bert-base-uncased")
    cfg = {**COLBERT, "pretrained": "bert-base-uncased", "allowrandominit": True, "checkpointfile": none["ckpt"],
           "index": {"collection": {"name": "dummy", "path": corpus_dir}}}
    searcher = Searcher.create("colbert", {**cfg, "quantize": "int8"})
    t0 = time.perf_counter()
    svc = ColbertRetrievalService(searcher, max_k=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    corpus = svc._corpus
    n_docs = corpus[0].shape[0]
    check(n_docs == SERVING_DOCS, f"the int8 corpus holds {n_docs} docs; phase 3 checked X1 at {SERVING_DOCS}")
    corpus_gb = sum(t.numel() * t.element_size() for t in corpus) / 1e9
    setup = searcher.setup_seconds
    print(f"{label} set-up: service {t_service:.1f} s, of which encoding {setup['encode']:.1f} s (0: phase 6's "
          f"cache), quantization on the host {setup['quantize']:.1f} s, upload {setup['upload']:.2f} s; resident "
          f"corpus {corpus_gb:.3f} GB (codes {tuple(corpus[0].shape)} int8, mask, per-doc scales)")

    queries = topics[:COLBERT_QUERIES]
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
    batch_results = svc.search(none["batch"], k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = {"int8_matmul": int8_matmul.launches, "flash_attention": flash_attention.launches}
    int32_launches = int8_matmul.mode_launches["int32"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = len(queries) * colbert_x1_launches(1, n_docs) + colbert_x1_launches(len(none["batch"]), n_docs)
    print(f"{label} per request (median of {len(queries)}): {np.median(request_ms):.2f} ms (spread "
          f"{min(request_ms):.2f}-{max(request_ms):.2f}); one {len(none['batch'])}-query batch {batch_ms:.2f} ms; "
          f"peak device memory of the served run {peak_gb:.2f} GB; launches in the run: int8_matmul "
          f"{launches['int8_matmul']} (one per chunk of docs), flash_attention {launches['flash_attention']}")
    check(launches["int8_matmul"] == want, f"int8_matmul launched {launches['int8_matmul']} times, expected {want}")
    check(int32_launches == want, f"only {int32_launches} of the ColBERT int8 X1 launches ran the int32 epilogue")
    check(launches["flash_attention"] == config.num_layers * (len(queries) + 1),
          f"flash_attention launched {launches['flash_attention']} times in the int8 ColBERT run")
    check(all(len(hits) == 10 and all(np.isfinite(s) for _, s in hits) for hits in results + batch_results),
          "a served int8 ColBERT request did not return 10 finite scores")
    profile_request(svc, queries[0], label)

    # query 0's top 10 against the CPU: the port's encoder and int8 scoring of those docs
    ordinal = {d: i for i, d in enumerate(searcher.index.data.docid_strings)}
    docids = [d for d, _ in results[0]]
    rows = torch.tensor([ordinal[d] for d in docids], device="cuda")
    cpu_model = ColBERTModel(config, dim=COLBERT["dim"])
    cpu_model.load_state_dict(bert_state_dict(load_params(none["ckpt"])))
    with torch.inference_mode():
        cq, _ = cpu_model.eval().encode_query(torch.from_numpy(searcher._tokenize(queries[:1], COLBERT["maxqlen"])))
    cpu_scores = quantized_maxsim_scores(cq, *(t[rows].cpu() for t in corpus))[0].numpy()
    served = dict(results[0])
    err_cpu = float(max(abs(served[d] - float(s)) for d, s in zip(docids, cpu_scores)))
    check(err_cpu <= COLBERT_CPU_TOL, f"int8 query 0's top 10: served {[served[d] for d in docids]} vs CPU "
                                      f"{cpu_scores.tolist()}")
    overlap = len(set(docids) & {d for d, _ in none["top10"]})
    print(f"{label} query 0's served top 10 vs the CPU encoder + int8 scoring: max |err| {err_cpu:.3g} (tolerance "
          f"{COLBERT_CPU_TOL}); top-10 overlap with quantize=none {overlap}/10")
    del svc, corpus, rows
    torch.cuda.empty_cache()

    # int4 with rescore: the packed engine's candidates re-scored at full precision
    searcher4 = Searcher.create("colbert", {**cfg, "quantize": "int4", "rescore": COLBERT_RESCORE})
    t0 = time.perf_counter()
    svc4 = ColbertRetrievalService(searcher4, max_k=100, device="cuda")
    torch.cuda.synchronize()
    t_service4 = time.perf_counter() - t0
    corpus4_gb = sum(t.numel() * t.element_size() for t in svc4._corpus) / 1e9
    svc4.search(queries[1:2], k=10)  # warm-up request
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    top4 = svc4.search(queries[:1], k=10)[0]
    torch.cuda.synchronize()
    int4_ms = (time.perf_counter() - t0) * 1e3
    launches["int8_matmul_int4"] = int8_matmul.launches
    check(launches["int8_matmul_int4"] == colbert_x1_launches(1, n_docs) == int8_matmul.mode_launches["int32"],
          f"int4: int8_matmul launched {launches['int8_matmul_int4']} times for one query "
          f"({int8_matmul.mode_launches['int32']} in the int32 epilogue)")
    check(len(top4) == 10, f"int4 + rescore returned {len(top4)} hits")
    faults = ranking_faults(top4, none["top10"], COLBERT_CPU_TOL)
    check(not faults, f"int4 + rescore top 10 vs quantize=none: {faults}")
    swaps = sum(d4 != dn for (d4, _), (dn, _) in zip(top4, none["top10"]))
    err4 = max(abs(s4 - sn) for (_, s4), (_, sn) in zip(top4, none["top10"]))
    print(f"{label} int4 + rescore {COLBERT_RESCORE}: service {t_service4:.1f} s (quantization "
          f"{searcher4.setup_seconds['quantize']:.1f} s), corpus {corpus4_gb:.3f} GB; query 0 {int4_ms:.2f} ms with "
          f"{launches['int8_matmul_int4']} int8_matmul launch(es); its top 10 vs quantize=none: {swaps} rank(s) hold "
          f"another doc at a near-tie, max |score diff| {err4:.3g} (tolerance {COLBERT_CPU_TOL})")
    del svc4
    torch.cuda.empty_cache()
    return launches, {"request_ms": float(np.median(request_ms)), "batch_ms": batch_ms, "max_abs_err_cpu": err_cpu,
                      "top10_overlap_none": overlap, "int4_rescore_ms": int4_ms, "int4_swaps": swaps}


def main():
    t_start = time.perf_counter()
    name = phase_device()
    peaks = card_peaks(name)
    workdir = tempfile.mkdtemp(prefix="capreolus_tpu_torch_smoke_")
    os.environ["CAPREOLUS_CACHE"] = os.path.join(workdir, "cache")
    os.environ["CAPREOLUS_RESULTS"] = os.path.join(workdir, "results")
    seconds = {}

    def timed(phase, *args, **kwargs):
        t0 = time.perf_counter()
        result = phase(*args, **kwargs)
        seconds[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 1)
        return result

    try:
        timed(phase_build)
        k1 = timed(phase_k1_check, peaks)
        k2 = timed(phase_k2_check, peaks)
        k3 = timed(phase_k3_check, peaks)
        x1 = timed(phase_x1_check, peaks)
        q1 = timed(phase_q1_check, peaks)
        q1["scales_differing_from_cpu"] = timed(phase_scales_check)
        k1_launches, corpus_dir, topics = timed(phase_serving, workdir, SERVING_DOCS, ckpt_seed=3)
        k2_launches, k2_served, f32 = timed(phase_bert_serving, workdir, corpus_dir, topics, peaks)
        bert_int8_launches, bert_int8 = timed(phase_bert_int8_serving, workdir, corpus_dir, topics, f32)
        colbert_launches, k3_served, none = timed(phase_colbert_serving, workdir, corpus_dir, topics, peaks)
        colbert_int8_launches, colbert_int8 = timed(phase_colbert_int8_serving, workdir, corpus_dir, topics, none)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    serving = k1["serving"]
    k3_fields = ("shape", "plan", "max_abs_err", "ms", "plain_ms", "product_gemm_ms", "bound_ms", "bound_by",
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
        "max_abs_err_all_pad_row": k1["all_pad_row"]["max_abs_err"],
        "blocks_per_batch_element": serving["splits"],
        "ms": serving["ms"],
        "graph_ms": serving["graph_ms"],  # 20 calls replayed from a CUDA graph: the device time without the host's
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
        # the runs of monoBERT f32 and int8, then ColBERT's over the bf16 and int8 corpora
        "launches": (k2_launches + bert_int8_launches["flash_attention"] + colbert_launches["flash_attention"]
                     + colbert_int8_launches["flash_attention"]),
        "launches_monobert": k2_launches,
        "launches_monobert_int8": bert_int8_launches["flash_attention"],
        "launches_colbert": colbert_launches["flash_attention"],
        "launches_colbert_int8": colbert_int8_launches["flash_attention"],
        "layout": k2_served["layout"],
        "max_abs_err": k2_served["max_abs_err"],
        "max_abs_err_small": k2["max_abs_err_small"],
        "max_abs_err_bf16": k2["max_abs_err_bf16"],
        "unmasked_key_share": k2_served["unmasked_key_share"],
        "ms": k2_served["ms"],
        "plain_ms": k2_served["plain_ms"],
        # f32 products as three TF32 products each, over the TF32 tensor-core rate; the CUDA cores' figure beside it
        "bound_ms": k2_served["bound_ms"],
        "bound_by": k2_served["bound_by"],
        "bound_ms_cuda_core": k2_served["bound_ms_cuda_core"],
        "library_ms": k2_served["library_ms"],  # scaled_dot_product_attention, same boolean mask
        "served_bf16": {key[:-5]: value for key, value in k2_served.items() if key.endswith("_bf16")},
        "copies_monobert": {key: k2_served["profiled"][key] for key in ("copy_kernels", "copy_ms", "clones")},
        "copies_monobert_int8": {key: bert_int8["profiled"][key] for key in ("copy_kernels", "copy_ms", "clones")},
        "every_key_unmasked": {key: value for key, value in k2.items() if key != "max_abs_err_small"},
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
        "max_abs_err_edges": k3["max_abs_err_edges"],
        "max_abs_err_chunked": k3["max_abs_err_chunked"],
        "max_abs_err_cpu_top10": k3_served["max_abs_err_cpu"],
        "plan": k3_served["q1"]["plan"],
        "ms": k3_served["q1"]["ms"],
        "plain_ms": k3_served["q1"]["plain_ms"],
        "bound_ms": k3_served["q1"]["bound_ms"],
        "bound_by": k3_served["q1"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes MaxSim
        "product_gemm_ms": k3_served["q1"]["product_gemm_ms"],  # the bf16 [Q*Lq, dim] x [dim, C*Ld] product alone
        "batch_64": {key: k3_served["q64"][key] for key in k3_fields},
        "synthetic": {nq: {key: k3[nq][key] for key in k3_fields} for nq in ("q1", "q64")},
    }, {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "scripts/exp_pallas_int8.py:46, scripts/exp_pallas_int8b.py:32",
        "tpu": "scripts/exp_pallas_int8.py::matmul_kernel (X1), scripts/exp_pallas_int8b.py::matmul_kernel (X2)",
        "shape": x1["intermediate"]["shape"] + ", the served FFN up-projection, int32 epilogue",
        # monoBERT int8's run, then ColBERT's int8 run and its int4 + rescore query
        "launches": (bert_int8_launches["int8_matmul"] + colbert_int8_launches["int8_matmul"]
                     + colbert_int8_launches["int8_matmul_int4"]),
        "launches_monobert_int8": bert_int8_launches["int8_matmul"],
        "launches_monobert_int8_by_mode": bert_int8_launches["int8_matmul_modes"],
        "pad_copies_monobert_int8": bert_int8_launches["pad_copies"],
        "launches_colbert_int8": colbert_int8_launches["int8_matmul"],
        "launches_colbert_int4": colbert_int8_launches["int8_matmul_int4"],
        "max_abs_err": max(r["max_abs_err"] for r in x1.values()),
        "ms": x1["intermediate"]["ms"],
        "plain_ms": x1["intermediate"]["plain_ms"],
        "bound_ms": x1["intermediate"]["bound_ms"],
        "bound_by": x1["intermediate"]["bound_by"],
        "library_ms": x1["intermediate"]["library_ms"],  # torch._int_mm (cuBLASLt), same codes
        # each epilogue at the BERT shapes: f32 at all three, int8-gelu at the up-projection; library_ms
        # is null there (no PyTorch call fuses them), torch._int_mm's time of the product is in served_shapes
        "modes": {"f32": {label: x1[label]["f32"] for label, *_ in X1_BERT_SERVED},
                  "int8_gelu": {"intermediate": x1["intermediate"]["int8_gelu"]}},
        "served_shapes": {label: {key: value for key, value in r.items() if key not in ("f32", "int8_gelu")}
                          for label, r in x1.items()},
        "monobert_int8": bert_int8,
        "colbert_int8": colbert_int8,
    }, {
        "name": "quantize_per_token",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/quantize_per_token.cu",
        # no TPU kernel: the JAX encoder's per-token quantization, which XLA fuses into the int8 dot
        "replaces": "capreolus_tpu/reranker/bert/encoder.py:139 (_quantize_per_token, no pl.pallas_call)",
        "shape": q1["shape"] + ", the served BERT-base hidden states",
        "launches": bert_int8_launches["quantize_per_token"],
        "max_abs_err": q1["max_abs_err"],
        "ms": q1["ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes per-token quantization
    }]
    print(f"[7 done] every phase passed in {time.perf_counter() - t_start:.1f} s; seconds by phase: "
          f"{json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
