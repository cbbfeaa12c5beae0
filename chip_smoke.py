#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drives retrieve-then-rerank serving on
one NVIDIA GPU, with KNRM and with monoBERT-MaxP at BERT-base width (f32, then
int8), then ColBERT late-interaction serving at BERT-base width (a bf16 corpus,
then int8 and int4 corpora), then the rank task's sparse searchers over the
50k-doc golden corpus, then trains KNRM and monoBERT-MaxP through the rerank
task, and holds every kernel against its plain PyTorch version.

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
8. the rank task (after 6b): the JAX suite's 50k-doc golden corpus
   (``tests/test_e2e_golden.py::_build_corpus``, as ``golden_corpus``) with its
   qrels, registered as the port's ``e2e_golden`` collection and benchmark;
   both indexes built (plain and with positions, timed); the port's
   ``rank.searcheval`` on "cuda" for BM25, BM25Grid (its default 100-point
   grid), QLDirichlet, BM25RM3, SDM and fusion (RRF of BM25 and QLDirichlet)
   at 1000 hits: PARITY.md's five pins (MAP, nDCG@20) within 2e-3, BM25Grid's
   (0.9, 0.4) run equal to BM25's (docids, scores within 1e-6 relative), a
   repeated BM25 search bit-identical; the same searches on the CPU: the exact
   searchers' docids identical and their raw scores within 1e-6 relative, RM3,
   SDM and fusion equal but for near-ties (within 1e-5 relative), every
   metric of DEFAULT_METRICS within 1e-4; the CLI on the card in a process of
   its own (``python -m capreolus_tpu_torch rank.searcheval with
   benchmark.name=dummy searcher.name=BM25``, map 1.0); BM25Grid's engine calls
   and peak device memory; each search's seconds on the card and the CPU; one
   profiled BM25 search of the 25 topics (device busy share, top device ops).
   The sparse path launches none of the port's kernels, which is checked;
9. training (after 8): 9a, the rerank golden of the JAX suite
   (``tests/test_e2e_rerank_golden.py``, as ``rerank_golden_corpus``) through
   the port's ``rerank.traineval`` on "cuda": tiny-BERT MaxP and KNRM (over
   trainer seeds 42-49) each more than 0.2 test MAP above the first stage, and
   within 0.1 of their pins (1.0; KNRM's mean over the seeds, 0.7977), no K2
   launch inside a training step; step 1 on the card against the CPU from one
   init and one batch (loss and gradients within 1e-4 relative) for KNRM with
   trainable kernels and embeddings, a frozen KNRM (K1 once per forward in the
   step) and tiny BERT with dropout off (no K2 in the step); K1 against its
   plain version on the frozen KNRM's step-1 batch, and K2 against its plain
   version at every layer of tiny BERT's first prediction batch. 9b, full width
   over phase 4's corpus and indexes, its 25 topics graded by the recipe in one
   fold of 15 / 5 / 5, threshold 100: KNRM at its published width with frozen
   kernels and embeddings (K1 in every step) and monoBERT-MaxP at BERT-base
   width and depth (seeded N(0, 0.02) weights, bertpassage defaults, batch 32,
   itersize 256, 2 iterations, dropout 0.1), each with its seconds per
   iteration, samples per second, validation seconds, peak device memory and
   one profiled training step (device busy share, top ops); the launches of K1
   and K2 in training steps (K2: 0; K1: one per forward) and in predictions;
   K1 against its plain version on KNRM's training batch (B 32, both sides)
   and first prediction batch, K2 at every layer of monoBERT-MaxP's first
   prediction batch; then ``dev.best`` and ``extractor_state.pkl`` served by
   ``RerankingService`` on "cuda", query 0's scores within 1e-5 of the
   trainer's own test prediction;
7. the seconds each phase took, a ``kernels`` JSON line (each kernel also with
   ``launches_training`` and ``launches_training_predict``, phase 9's
   launches in training steps and in the trainer's predictions, and K1 and
   K2 with ``max_abs_err_training``, their largest error on phase 9's own
   batches), then the result line.

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
GOLDEN_DOCS, GOLDEN_TOPICS, GOLDEN_SEED = 50_000, 25, 20260819  # tests/test_e2e_golden.py's corpus
GOLDEN_PINS = {  # MAP / nDCG@20 of PARITY.md's e2e golden through rank.searcheval
    "BM25": {"map": 0.8736, "ndcg_cut_20": 0.9287},
    "QLDirichlet": {"map": 0.8745, "ndcg_cut_20": 0.9348},
    "BM25RM3": {"map": 0.9753, "ndcg_cut_20": 0.9689},
    "SDM": {"map": 0.8731, "ndcg_cut_20": 0.9326},
    "fusion": {"map": 0.8741, "ndcg_cut_20": 0.9316},
}
GOLDEN_TOL = 2e-3  # the JAX suite's pin tolerance: f32 sums vs its f64 referee swap same-grade neighbours
SPARSE_RTOL = 1e-6  # exact sparse scores, card vs CPU and BM25Grid's (0.9, 0.4) point vs BM25: f32
# formulas whose single ops may round apart by an ulp on the two devices
FEEDBACK_RTOL = 1e-5  # RM3, SDM and fusion, card vs CPU: stage-1 scores an ulp apart move the
# expansion weights and window sums in their last bits, so near-ties may trade places
METRIC_TOL = 1e-4  # every DEFAULT_METRICS value, card vs CPU
# device bytes per accumulator element that one engine call may add over the
# resident index (searcher/tpu.py's ACC_BUDGET_ELEMENTS comment): 40 for the f32
# accumulator and the stable sort's buffers, and the scores gathered per slot,
# which grow with the queries' postings (0.64 on the 50k golden)
ACC_CALL_BYTES_PER_ELEMENT = 44

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
    longer documents so that maxdoclen=800 binds. Returns (docs, topics, qrels):
    qrels grade the injected documents as ``golden_corpus`` does (2, 1, 0 for
    4-6, 2-3 and 1 concept words), under qids "100", "101", ... in topic order."""
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
    qrels = {str(100 + t): {} for t in range(num_topics)}
    for t in range(num_topics):
        for grade, count, lo, hi in ((2, 30, 4, 7), (1, 50, 2, 4), (0, 40, 1, 2)):
            for _ in range(count):
                d = int(pool[pos])
                pos += 1
                k = int(rng.integers(lo, hi))
                words = list(rng.choice(concept[t], size=k, replace=False))
                for w, i in zip(words, rng.integers(0, len(doc_words[d]), size=k)):
                    doc_words[d].insert(int(i), w)
                qrels[str(100 + t)][f"G{d:05d}"] = grade
    topics = [" ".join(concept[t][:3]) + (f" {vocab[t]}" if t % 3 == 0 else "") for t in range(num_topics)]
    docs = [(f"G{i:05d}", " ".join(w)) for i, w in enumerate(doc_words)]
    return docs, topics, qrels


def golden_corpus(num_docs=GOLDEN_DOCS, num_topics=GOLDEN_TOPICS, seed=GOLDEN_SEED, bg_vocab=1500):
    """The JAX suite's golden corpus (``tests/test_e2e_golden.py::_build_corpus``,
    the same draws in the same order): Zipfian background words plus per-topic
    concept words injected at graded intensities (grade 2: 4-6 concept words,
    grade 1: 2-3, judged non-relevant: exactly 1). At the defaults it IS that
    corpus. Returns (docs [(docid, text)], topics {qid: text}, qrels
    {qid: {docid: grade}})."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = []
    seen = set()
    while len(vocab) < bg_vocab:
        w = _word(rng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    concept = {t: [f"{_word(rng)}{t:02d}x{j}" for j in range(6)] for t in range(num_topics)}

    ranks = np.arange(1, bg_vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks**1.1)
    probs /= probs.sum()
    vocab_arr = np.asarray(vocab)

    doc_words = []
    for _ in range(num_docs):
        length = int(rng.integers(25, 60))
        doc_words.append(list(vocab_arr[rng.choice(bg_vocab, size=length, p=probs)]))

    qrels = {str(100 + t): {} for t in range(num_topics)}
    pool = rng.permutation(num_docs)
    pos = 0
    for t in range(num_topics):
        qid = str(100 + t)
        for grade, count, lo, hi in ((2, 30, 4, 7), (1, 50, 2, 4), (0, 40, 1, 2)):
            for _ in range(count):
                d = int(pool[pos])
                pos += 1
                k = int(rng.integers(lo, hi))
                words = list(rng.choice(concept[t], size=k, replace=False))
                insert_at = rng.integers(0, len(doc_words[d]), size=k)
                for w, i in zip(words, insert_at):
                    doc_words[d].insert(int(i), w)
                qrels[qid][f"G{d:05d}"] = grade

    topics = {str(100 + t): " ".join(concept[t][:3]) for t in range(num_topics)}
    # a few queries carry a common background word too (scoring noise + ties)
    for t in (0, 7, 19):
        if t < num_topics:
            topics[str(100 + t)] += f" {vocab[t]}"
    docs = [(f"G{i:05d}", " ".join(w)) for i, w in enumerate(doc_words)]
    return docs, topics, qrels


def write_golden(docs, topics, qrels, base):
    """The golden corpus as the JAX suite writes it: four TREC files under
    ``base/corpus``, ``base/qrels.txt`` and ``base/topics.tsv``. Returns
    (corpus_dir, qrel_fn, topic_fn)."""
    corpus_dir = os.path.join(base, "corpus")
    write_trec(docs, corpus_dir)
    return (corpus_dir,) + write_qrels_topics(topics, qrels, base)


def write_qrels_topics(topics, qrels, base):
    """``base/qrels.txt`` and ``base/topics.tsv`` as the JAX suite writes them.
    Returns (qrel_fn, topic_fn)."""
    os.makedirs(base, exist_ok=True)
    qrel_fn, topic_fn = os.path.join(base, "qrels.txt"), os.path.join(base, "topics.tsv")
    with open(qrel_fn, "wt", encoding="utf-8") as fh:
        for qid in sorted(qrels):
            for docid, rel in sorted(qrels[qid].items()):
                fh.write(f"{qid} 0 {docid} {rel}\n")
    with open(topic_fn, "wt", encoding="utf-8") as fh:
        for qid in sorted(topics):
            fh.write(f"{qid}\t{topics[qid]}\n")
    return qrel_fn, topic_fn


def register_golden(corpus_dir, qrel_fn, topic_fn, qids, name="e2e_golden", split=None, collection=None):
    """Register the port's collection and benchmark ``name`` over files written
    by ``write_golden``: one fold whose train, dev and test sets are every
    topic, as in the JAX suite, or ``split`` (train, dev, test) topics of
    ``qids`` in order. ``collection`` (a collection config, e.g. ``{"name":
    "dummy", "path": ...}``) puts the benchmark over that collection instead
    of a new one, so its indexes are the ones already built for it."""
    import capreolus_tpu_torch

    capreolus_tpu_torch.load_all_modules()
    from capreolus_tpu_torch.benchmark import Benchmark
    from capreolus_tpu_torch.collection import Collection
    from capreolus_tpu_torch.core import Dependency

    if collection is None:
        @Collection.register
        class GoldenCollection(Collection):
            module_name = name
            collection_type = "trec"
            _path = corpus_dir

        collection = {"name": name}
    coll_dep = Dependency(key="collection", module="collection", name=collection["name"],
                          default_config_overrides={k: v for k, v in collection.items() if k != "name"})

    @Benchmark.register
    class GoldenBenchmark(Benchmark):
        module_name = name
        dependencies = [coll_dep]
        query_type = "title"
        topic_format = "tsv"
        qrel_file = qrel_fn
        topic_file = topic_fn

        @property
        def folds(self):
            if split is None:
                return {"s1": {"train_qids": list(qids), "predict": {"dev": list(qids), "test": list(qids)}}}
            train, dev = split[0], split[0] + split[1]
            return {"s1": {"train_qids": list(qids[:train]),
                           "predict": {"dev": list(qids[train:dev]), "test": list(qids[dev:dev + split[2]])}}}


RERANK_GOLDEN = {  # tests/test_e2e_rerank_golden.py's corpus and pins
    "topics": 20, "split": (12, 4, 4), "cands": 40, "rel": 10, "bg_docs": 1000, "bg_vocab": 400,
    "base_len": 30, "seed": 20260820,
    "pins": {"first_stage": 0.3329, "KNRM": 0.7977, "BERTMaxP": 1.0},
}
RERANK_PIN_TOL = 0.1  # the JAX suite's tolerance for the rerank pins (init seeds and the candidate shuffle)
RERANK_GAIN = 0.2  # how far above the first stage each trained reranker's test MAP must sit
RERANK_GOLDEN_CONFIGS = {  # the rerankers of tests/test_e2e_rerank_golden.py, as the rerank task takes them
    "KNRM": {"name": "KNRM", "finetune": True,
             "extractor": {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 64},
             "trainer": {"niters": 4, "itersize": 256, "batch": 16, "lr": 0.05, "bertlr": 0.05,
                         "validatefreq": 1}},
    "BERTMaxP": {"name": "BERTMaxP", "pretrained": "tiny", "allowrandominit": True,
                 "extractor": {"maxseqlen": 96, "maxqlen": 8, "numpassages": 1, "passagelen": 80, "stride": 40},
                 "trainer": {"niters": 4, "itersize": 256, "batch": 16, "lr": 1e-3, "bertlr": 1e-3,
                             "validatefreq": 1}},
}


def rerank_golden_corpus(seed=RERANK_GOLDEN["seed"]):
    """The JAX suite's rerank golden (``tests/test_e2e_rerank_golden.py::
    build_rerank_corpus``, the same draws in the same order): per topic 40
    candidates with identical concept-term tf and length, so BM25 ties and
    orders them by docid; the 10 relevant carry global marker words, the rest
    junk words, and every query a token ("findrel") no document holds. Returns
    (docs, topics, qrels) as ``golden_corpus`` does."""
    g = RERANK_GOLDEN
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab, seen = [], set()
    while len(vocab) < g["bg_vocab"]:
        w = _word(rng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    ranks = np.arange(1, g["bg_vocab"] + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    vocab_arr = np.asarray(vocab)

    def bg_words(n):
        return list(vocab_arr[rng.choice(g["bg_vocab"], size=n, p=probs)])

    concept = {t: [f"{_word(rng)}c{t:02d}a", f"{_word(rng)}c{t:02d}b"] for t in range(g["topics"])}
    markers, junk = ["relmarka", "relmarkb", "relmarkc"], [f"junkw{i}" for i in range(12)]
    docs, qrels, topics = [], {}, {}

    def add_doc(words):
        docid = f"R{len(docs):05d}"
        docs.append((docid, " ".join(words)))
        return docid

    for _ in range(g["bg_docs"]):
        add_doc(bg_words(int(rng.integers(25, 45))))
    for t in range(g["topics"]):
        qid = str(200 + t)
        qrels[qid] = {}
        topics[qid] = " ".join(concept[t] + ["findrel"])
        flags = np.zeros(g["cands"], dtype=bool)
        flags[:g["rel"]] = True
        rng.shuffle(flags)
        for rel in flags:
            words = bg_words(g["base_len"])
            inject = [concept[t][0]] * 2 + [concept[t][1]] * 2
            inject += list(rng.choice(markers, size=6)) if rel else list(rng.choice(junk, size=6))
            for w in inject:
                words.insert(int(rng.integers(0, len(words) + 1)), w)
            qrels[qid][add_doc(words)] = 1 if rel else 0
    return docs, topics, qrels


def setup_rerank_golden(base, name="rerank_golden"):
    """Write the rerank golden under ``base`` and register it as the port's
    collection and benchmark ``name`` (the JAX suite's 12 / 4 / 4 fold).
    Returns (topics, qrels)."""
    docs, topics, qrels = rerank_golden_corpus()
    qids = sorted(topics)
    register_golden(*write_golden(docs, topics, qrels, base), qids, name=name, split=RERANK_GOLDEN["split"])
    return topics, qrels


def rerank_task(reranker_cfg, device, name="rerank_golden", collection=None, threshold=RERANK_GOLDEN["cands"]):
    """The port's rerank task over benchmark ``name`` (BM25 first stage,
    ``threshold`` = ``testthreshold``) on ``device``."""
    from capreolus_tpu_torch.task import Task

    task = Task.create("rerank", {
        "benchmark": {"name": name},
        "rank": {"searcher": {"name": "BM25", "index": {"collection": collection or {"name": name}}}},
        "reranker": json.loads(json.dumps(reranker_cfg)), "threshold": threshold, "testthreshold": threshold})
    task.device = device
    return task


def rerank_golden_run(reranker_cfg, device, name="rerank_golden"):
    """The port's rerank task on the golden, as the JAX suite drives it
    (``threshold`` = ``testthreshold`` = 40). Returns (task, the first stage's
    best run, the predictions {"dev", "test"})."""
    task = rerank_task(reranker_cfg, device, name)
    first_stage = task._best_search_run()
    return task, first_stage, task.rerank_run(first_stage, task.get_results_path())


def golden_map(run, qrels, qids):
    """MAP of ``run`` over ``qids``."""
    from capreolus_tpu_torch.evaluation import eval_runs

    return eval_runs({q: dict(run[q]) for q in qids}, {q: qrels[q] for q in qids}, ["map"])["map"]


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
    """Where one rerank request's time goes (``profile_call`` of one
    ``svc.search([query], k=10)``)."""
    return profile_call(lambda: svc.search([query], k=10), label, top)


def profile_call(fn, label, top=6, what="request"):
    """Where one call's time goes: device time by op (torch.profiler, CUPTI)
    against the call's wall time; the rest is host time. Returns
    {"wall_ms", "busy_ms", "top_ops", "copy_kernels", "copy_ms", "clones"}: the
    device's copy kernels (torch's ``direct_copy_kernel_cuda``, run by
    ``copy_``, ``contiguous`` and ``reshape`` of a strided tensor, and casts)
    and the host's ``aten::clone`` calls, so a caller can check which copies a
    request makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    top_ops = [f"{e.key[:40]} {device_us(e) / 1e3:.3f} ms x{e.count}" for e in ops[:top]]
    print(f"{label} profiled {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); top device ops: " + "; ".join(top_ops))
    host = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)
    host_ms = sum(e.self_cpu_time_total for e in averages) / 1e3
    print(f"{label} profiled {what}: host time inside torch ops {host_ms:.2f} ms (the rest of the "
          f"wall is Python; a device-to-host copy waits there for the device); top host ops: "
          + "; ".join(f"{e.key[:32]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in host[:top]))
    copies = [e for e in ops if "copy_kernel" in e.key]
    summary = {"wall_ms": wall_ms, "busy_ms": busy_ms, "top_ops": top_ops, "copy_kernels": sum(e.count for e in copies),
               "copy_ms": sum(device_us(e) for e in copies) / 1e3,
               "clones": sum(e.count for e in averages if e.key == "aten::clone")}
    print(f"{label} profiled {what}: device copy kernels {summary['copy_kernels']} ({summary['copy_ms']:.3f} ms), "
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
    docs, topics, qrels = build_corpus(num_docs, num_topics=25, seed=20260819,
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
    return launches, corpus_dir, topics, qrels


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


def launch_counts():
    """{kernel: launches since the last reset} of every port kernel."""
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul
    from capreolus_tpu_torch.ops.maxsim import maxsim
    from capreolus_tpu_torch.ops.quantization import quantize_per_token
    from capreolus_tpu_torch.ops.simmat import knrm_pool

    return {"knrm_pool": knrm_pool.launches, "flash_attention": flash_attention.launches,
            "maxsim": maxsim.launches, "int8_matmul": int8_matmul.launches,
            "quantize_per_token": quantize_per_token.launches}


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

RANK_SEARCHERS = {  # phase 8's searchers, as the rank task's config names them
    "BM25": {"name": "BM25"},
    "BM25Grid": {"name": "BM25Grid"},  # its default 10 x 10 grid, k1 and b from 0.1 to 1.0
    "QLDirichlet": {"name": "QLDirichlet"},
    "BM25RM3": {"name": "BM25RM3"},
    "SDM": {"name": "SDM"},
    "fusion": {"name": "fusion", "searcher1": {"name": "BM25"}, "searcher2": {"name": "QLDirichlet"}},
}


def rank_search(config, device, results_base):
    """The port's rank task over the golden benchmark on ``device``:
    (task, search seconds, cross-validated metrics, {run-file name: run})."""
    import contextlib
    import io

    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.task import Task
    from capreolus_tpu_torch.utils.trec import load_trec_run

    constants["RESULTS_BASE_PATH"] = results_base
    task = Task.create("rank", {"benchmark": {"name": "e2e_golden"}, "searcher": config})
    task.device = device
    t0 = time.perf_counter()
    out = task.search()
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):  # evaluate() prints its dict
        scores = task.evaluate()["score"]
    runs = {p.name: load_trec_run(p) for p in sorted(out.iterdir()) if p.is_file() and p.name != "done"}
    return task, secs, scores, runs


def engine_rows(searcher, topic_fn, device):
    """The searcher's raw engine output over the topics on ``device``, split
    as its search splits it: (scores [G, Q, hits] f32, ordinals) numpy."""
    from capreolus_tpu_torch.searcher.scoring import grid_points
    from capreolus_tpu_torch.searcher.tpu import _load_topics_tsv

    searcher.device = device
    engine = searcher.get_engine()
    terms = [searcher.query_weights(text, engine) for _, text in _load_topics_tsv(topic_fn)]
    fixed, grid = searcher.grid_params()
    points = grid_points(grid)
    g = len(next(iter(points.values()))) if points else 1
    hits = min(int(searcher.config["hits"]), engine.dindex.num_docs)
    scores, ords = np.zeros((g, len(terms), hits), np.float32), np.zeros((g, len(terms), hits), np.int32)
    for q0, g0, sc, od in searcher._engine_calls(engine, terms, searcher.model, fixed, points, hits):
        scores[g0:g0 + sc.shape[0], q0:q0 + sc.shape[1]] = sc.cpu().numpy()
        ords[g0:g0 + od.shape[0], q0:q0 + od.shape[1]] = od.cpu().numpy()
    return scores, ords


def one_call_bytes(searcher, topic_fn):
    """Device bytes that one of the searcher's engine calls at the accumulator
    budget adds at its peak, over the resident index: (bytes, elements
    G*Q*(N+1)). The call takes as many topics as the budget allows at the
    searcher's whole grid (all topics where they fit)."""
    from capreolus_tpu_torch.searcher.scoring import grid_points
    from capreolus_tpu_torch.searcher.tpu import ACC_BUDGET_ELEMENTS, _load_topics_tsv

    searcher.device = "cuda"
    engine = searcher.get_engine()
    fixed, grid = searcher.grid_params()
    points = grid_points(grid)
    g, rows = len(next(iter(points.values()))), engine.dindex.num_docs + 1
    topics = _load_topics_tsv(topic_fn)
    q = max(1, min(len(topics), ACC_BUDGET_ELEMENTS // (g * rows)))
    terms = [searcher.query_weights(text, engine) for _, text in topics[:q]]
    hits = min(int(searcher.config["hits"]), engine.dindex.num_docs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = engine.search_points(terms, model=searcher.model, params=fixed, points=points, topk=hits,
                               materialize=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak, g * q * rows


def run_faults(a_runs, b_runs, rtol, atol=0.0, near_ties=True):
    """Where two sets of run files part, as messages: the same files and
    queries, and per query the same number of hits with the scores at each
    rank within ``rtol`` of the first run's top score plus ``atol``; the same
    docids at each rank, or with ``near_ties`` two docs may trade places where
    they score within that tolerance of each other in both runs
    (``ranking_faults``)."""
    if sorted(a_runs) != sorted(b_runs):
        return [f"run files {sorted(a_runs)} vs {sorted(b_runs)}"]
    faults = []
    for name, a_run in a_runs.items():
        b_run = b_runs[name]
        if list(a_run) != list(b_run):
            faults.append(f"{name}: queries differ")
            continue
        for qid, a_docs in a_run.items():
            a_hits, b_hits = list(a_docs.items()), list(b_run[qid].items())
            tol = rtol * max([abs(v) for _, v in a_hits[:1]] + [0.0]) + atol
            bad = [] if len(a_hits) == len(b_hits) else [f"{len(a_hits)} vs {len(b_hits)} hits"]
            if not near_ties and [d for d, _ in a_hits] != [d for d, _ in b_hits]:
                bad.append("docids differ")
            bad += [f"rank {r}: {sa} vs {sb}" for r, ((_, sa), (_, sb)) in enumerate(zip(a_hits, b_hits))
                    if abs(sa - sb) > tol]
            bad += ranking_faults(a_hits, b_hits, tol)
            faults += [f"{name} {qid}: {m}" for m in bad[:3]]
    return faults


def phase_rank_task(workdir):
    """The rank task on the card over the JAX suite's 50k-doc golden corpus:
    index builds, the six searchers against PARITY.md's pins and against the
    CPU, BM25Grid's split and memory, a repeated BM25 search, the CLI, and one
    profiled BM25 search."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.evaluation import DEFAULT_METRICS
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.searcher.tpu import ACC_BUDGET_ELEMENTS

    label = "[8 rank task]"
    t0 = time.perf_counter()
    docs, topics, qrels = golden_corpus()
    corpus_dir, qrel_fn, topic_fn = write_golden(docs, topics, qrels, os.path.join(workdir, "golden"))
    register_golden(corpus_dir, qrel_fn, topic_fn, sorted(topics))
    print(f"{label} golden corpus: {len(docs)} docs, {len(topics)} topics, "
          f"{sum(len(q) for q in qrels.values())} judgements; made in {time.perf_counter() - t0:.1f} s")
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rank")
    builds = {}
    for positions in (False, True):
        index = Index.create("tpu", {"storepositions": positions, "collection": {"name": "e2e_golden"}})
        t0 = time.perf_counter()
        index.create_index()
        builds["positions" if positions else "plain"] = round(time.perf_counter() - t0, 2)
    print(f"{label} index build seconds: plain {builds['plain']}, with positions {builds['positions']}")

    reset_launch_counts()
    results, secs, metrics, runs, card_searchers = {}, {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        for name, config in RANK_SEARCHERS.items():
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            task, secs[name, device], metrics[name, device], runs[name, device] = rank_search(
                config, device, os.path.join(workdir, f"results_{device}"))
            if name == "BM25Grid":
                results[f"grid_engine_calls_{device}"] = task.searcher.engine_calls
                if device == "cuda":
                    results["grid_peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
            if device == "cuda":
                card_searchers[name] = task.searcher
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"{label} the sparse path launched a port kernel: {launched}")

    for name in RANK_SEARCHERS:
        for device in ("cuda", "cpu"):
            score = metrics[name, device]
            for metric, want in GOLDEN_PINS.get(name, {}).items():
                check(abs(score[metric] - want) <= GOLDEN_TOL,
                      f"{label} {name} on {device}: {metric} {score[metric]:.4f}, pinned {want} +- {GOLDEN_TOL}")
        gaps = {m: abs(metrics[name, "cuda"][m] - metrics[name, "cpu"][m]) for m in DEFAULT_METRICS}
        check(max(gaps.values()) <= METRIC_TOL, f"{label} {name}: metrics card vs CPU differ: {gaps}")
        print(f"{label} {name}: search {secs[name, 'cuda']:.2f} s on the card, {secs[name, 'cpu']:.2f} s on the CPU; "
              f"map {metrics[name, 'cuda']['map']:.4f} ndcg_cut_20 {metrics[name, 'cuda']['ndcg_cut_20']:.4f}; "
              f"{len(runs[name, 'cuda'])} run file(s); max metric gap card vs CPU {max(gaps.values()):.2e}")

    # BM25Grid's (k1=0.9, b=0.4) run against BM25's
    grid_run = runs["BM25Grid", "cuda"]["searcher_BM25Grid_b-0.4_k1-0.9"]
    bm25_run = runs["BM25", "cuda"]["searcher_BM25_b-0.4_k1-0.9"]
    faults = run_faults({"run": grid_run}, {"run": bm25_run}, SPARSE_RTOL, atol=1e-6, near_ties=False)
    check(not faults, f"{label} BM25Grid (0.9, 0.4) vs BM25: {faults[:5]}")
    # card against CPU: the exact searchers' run files docid for docid, their raw scores
    # within SPARSE_RTOL; the feedback searchers and fusion equal but for near-ties
    for name in ("BM25", "BM25Grid", "QLDirichlet"):
        faults = run_faults(runs[name, "cuda"], runs[name, "cpu"], SPARSE_RTOL, atol=1e-6, near_ties=False)
        check(not faults, f"{label} {name} card vs CPU: {faults[:5]}")
    for name in ("BM25", "BM25Grid", "QLDirichlet"):
        searcher = card_searchers[name]
        (gs, go), (cs, co) = engine_rows(searcher, topic_fn, "cuda"), engine_rows(searcher, topic_fn, "cpu")
        scored = gs > 0
        check(np.array_equal(go[scored], co[scored]), f"{label} {name}: ordinals differ card vs CPU")
        rel = float(np.max(np.abs(gs - cs) / np.maximum(np.abs(cs), 1e-30), initial=0.0))
        check(rel <= SPARSE_RTOL, f"{label} {name}: scores card vs CPU differ by {rel:.2e} relative")
        results[f"{name}_score_rel_err"] = rel
    for name in ("BM25RM3", "SDM", "fusion"):
        faults = run_faults(runs[name, "cuda"], runs[name, "cpu"], FEEDBACK_RTOL, atol=1e-6)
        check(not faults, f"{label} {name} card vs CPU beyond near-ties: {faults[:5]}")
    # a repeated BM25 search gives the same bits
    bm25_searcher = card_searchers["BM25"]
    first, again = engine_rows(bm25_searcher, topic_fn, "cuda"), engine_rows(bm25_searcher, topic_fn, "cuda")
    check(np.array_equal(first[0].view(np.uint32), again[0].view(np.uint32)) and np.array_equal(first[1], again[1]),
          f"{label} a repeated BM25 search on the card changed bits")
    call_bytes, call_elements = one_call_bytes(card_searchers["BM25Grid"], topic_fn)
    results["call_bytes_per_element"] = round(call_bytes / call_elements, 2)
    check(results["call_bytes_per_element"] <= ACC_CALL_BYTES_PER_ELEMENT,
          f"{label} one BM25Grid engine call held {results['call_bytes_per_element']} bytes per accumulator element, "
          f"more than the {ACC_CALL_BYTES_PER_ELEMENT} that searcher/tpu.py states")
    print(f"{label} BM25Grid: {results['grid_engine_calls_cuda']} engine calls for 1 query batch of "
          f"{len(topics)} (budget {ACC_BUDGET_ELEMENTS} accumulator elements), peak device memory {results['grid_peak_gb']} GB; "
          f"one call of {call_elements} elements adds {call_bytes / 1e9:.3f} GB at its peak, "
          f"{results['call_bytes_per_element']} bytes per element; "
          f"card vs CPU max relative score error BM25 {results['BM25_score_rel_err']:.2e}, BM25Grid "
          f"{results['BM25Grid_score_rel_err']:.2e}, QLDirichlet {results['QLDirichlet_score_rel_err']:.2e}; "
          f"a repeated BM25 search bit-identical")

    # the CLI, in a process of its own, on the card
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root, "CAPREOLUS_CACHE": os.path.join(workdir, "cache_cli"),
           "CAPREOLUS_RESULTS": os.path.join(workdir, "results_cli")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "capreolus_tpu_torch", "rank.searcheval", "with",
                           "benchmark.name=dummy", "searcher.name=BM25"],
                          capture_output=True, text=True, timeout=600, env=env, cwd=root)
    check(proc.returncode == 0, f"{label} the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    import ast

    cli = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    check(cli.get("map") == 1.0, f"{label} the CLI printed {cli}")
    print(f"{label} CLI rank.searcheval on dummy (card): exit 0, map {cli['map']}, {time.perf_counter() - t0:.1f} s")

    # one profiled BM25 search of the 25 topics on the card, into a fresh directory
    bm25_searcher.device = "cuda"
    prof_dir = os.path.join(workdir, "profiled_search")
    profiled = profile_call(lambda: bm25_searcher.query_from_file(topic_fn, prof_dir), f"{label} BM25",
                            top=8, what=f"search of {len(topics)} topics")
    results.update(builds=builds, seconds={f"{n}_{d}": round(v, 3) for (n, d), v in secs.items()},
                   map={n: metrics[n, "cuda"]["map"] for n in RANK_SEARCHERS},
                   ndcg_cut_20={n: metrics[n, "cuda"]["ndcg_cut_20"] for n in RANK_SEARCHERS},
                   profiled_bm25={k: profiled[k] for k in ("wall_ms", "busy_ms", "top_ops")})
    print(f"{label} summary {json.dumps(results)}")
    return results


# ---------------------------------------------------------------- phase 9: training
TRAIN_SPLIT = (15, 5, 5)  # train / dev / test topics of the 20k serving corpus's 25
TRAIN_THRESHOLD = 100  # threshold = testthreshold of the full-width training runs
STEP_RTOL = 1e-4  # step 1's loss, and each gradient tensor against its largest entry, card vs CPU from
# one init and one batch: f32 sums in other orders (K1's pooled features sit within 2e-4 of the
# plain path's on log sums of up to ~10, so a frozen KNRM's combine gradients move by ~2e-5)
GRAD_NOISE_FLOOR = 1e-3  # share of the model's largest gradient entry below which a tensor's own
# largest entry is not its scale (a gradient that is 0 but for rounding)
SERVED_DEV_BEST_TOL = 1e-5  # a dev.best served on the card against the trainer's own test prediction of
# the same docs in one batch of the same size (the same kernels on the same inputs)
TRAINER_FULL = {"batch": 32, "itersize": 256, "niters": 2, "validatefreq": 1, "evalbatch": TRAIN_THRESHOLD}
KNRM_TRAIN = {"name": "KNRM", "gradkernels": False, "finetune": False,  # frozen: K1 in every step
              "extractor": {"embeddings": "random300", "maxqlen": 4, "maxdoclen": 800}, "trainer": TRAINER_FULL}
BERT_TRAIN = {"name": "BERTMaxP", "pretrained": "bert-base-uncased", "allowrandominit": True,
              "hidden_dropout_prob": 0.1, "trainer": TRAINER_FULL}  # bertpassage at its defaults
KNRM_SEEDS = range(42, 50)  # the golden KNRM's trainer seeds, whose mean test MAP is held to the pin
BERT_LAYERS = 12


def count_stages(trainer, reranker):
    """Wrap the trainer's ``train_step``, ``predict`` and ``train`` and the
    reranker's ``test`` (instance attributes over the methods) so that every
    kernel's launches inside training steps and inside predictions add up
    apart, with the seconds of ``train`` and of its predictions (synchronized),
    the number of prediction forwards and the first prediction batch."""
    totals = {"train": dict.fromkeys(launch_counts(), 0), "predict": dict.fromkeys(launch_counts(), 0),
              "seconds": {"train": 0.0, "predict": 0.0, "validation": 0.0, "checkpoint": 0.0}, "forwards": 0,
              "steps": 0}
    step, predict, train, test = trainer.train_step, trainer.predict, trainer.train, reranker.test
    save = trainer.save_checkpoint

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        out = save(*args, **kwargs)
        totals["seconds"]["checkpoint"] += time.perf_counter() - t0
        return out

    def counted(stage, fn):
        def wrapper(*args, **kwargs):
            before = launch_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if stage == "predict":
                torch.cuda.synchronize()
                totals["seconds"]["predict"] += time.perf_counter() - t0
            else:
                totals["steps"] += 1
                totals["seconds"].setdefault("first_step", t0)
            for key, n in launch_counts().items():
                totals[stage][key] += n - before[key]
            return out
        return wrapper

    def timed_train(*args, **kwargs):
        t0, p0 = time.perf_counter(), totals["seconds"]["predict"]
        out = train(*args, **kwargs)
        torch.cuda.synchronize()
        end = time.perf_counter()
        totals["seconds"]["train"] += end - t0
        # from the first step on: the model's init and the first batch's samples are set-up
        totals["seconds"]["setup"] = totals["seconds"].pop("first_step") - t0
        totals["seconds"]["validation"] += totals["seconds"]["predict"] - p0
        return out

    def counted_test(batch, *args, **kwargs):
        totals["forwards"] += 1
        totals.setdefault("first_predict_batch", batch)  # its kernels are held against their plain versions
        return test(batch, *args, **kwargs)

    trainer.train_step, trainer.predict, trainer.train = counted("train", step), counted("predict", predict), timed_train
    trainer.save_checkpoint = timed_save
    reranker.test = counted_test
    return totals


def add_launches(into, stages):
    for stage in ("train", "predict"):
        for key, n in stages[stage].items():
            into[stage][key] = into[stage].get(key, 0) + n


def training_batch(task, batch):
    """One [1, batch, ...] training batch of ``task``'s sampler, after the
    first stage and the extractor's preprocess (the start of ``rerank_run``)."""
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    first_stage = task._best_search_run()
    task.reranker.extractor.preprocess(qids=list(first_stage), docids={d for r in first_stage.values() for d in r},
                                       topics=task.benchmark.topics[task.benchmark.query_type])
    train_qids = set(task.benchmark.folds[task.config["fold"]]["train_qids"])
    task.sampler.prepare({q: r for q, r in first_stage.items() if q in train_qids}, task.benchmark.qrels,
                         task.reranker.extractor, relevance_level=task.benchmark.relevance_level)
    it = iter(task.sampler)
    collated = collate([next(it) for _ in range(batch)], ARRAY_KEYS)
    return {k: v[None] for k, v in collated.items()}


def hold_k1(model, batch, sides, label, held):
    """K1 against ``knrm_pool_plain`` on a frozen KNRM's own batch (one
    micro-batch, [B, ...]): the query against each doc side in ``sides``, as
    the model hands them to K1. These launches come after the path's counts
    are read."""
    from capreolus_tpu_torch.ops.simmat import knrm_inputs, knrm_pool_plain, knrm_simmat_pool

    err, shapes = 0.0, []
    with torch.no_grad():
        query = torch.from_numpy(np.asarray(batch["query"])).cuda()
        for side in sides:
            docs = torch.from_numpy(np.asarray(batch[side])).cuda()
            got = knrm_simmat_pool(model.embedding, query, docs, model.mus, model.sigmas)
            want = knrm_pool_plain(*knrm_inputs(model.embedding, query, docs, model.mus, model.sigmas))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"K1 on {label}: non-finite output")
            err = max(err, float((got - want).abs().max()))
            shapes.append(f"{side} B={docs.shape[0]} Q={query.shape[1]} D={docs.shape[1]} E={model.embedding.shape[1]}")
    print(f"[9 K1] {label}: {', '.join(shapes)}: max |kernel - plain| {err:.3g} (tolerance {ERR_TOL})")
    check(err <= ERR_TOL, f"K1 on {label}: max |kernel - plain| = {err:.3g} > {ERR_TOL}")
    held["knrm_pool"] = max(held.get("knrm_pool", 0.0), err)
    return err


def hold_k2(reranker, batch, label, held):
    """K2 against ``attention_plain`` at every layer of one prediction forward
    of the trained BERT reranker on ``batch``: each layer's q, k, v and mask as
    it hands them to K2, taken by a pre-hook on its attention (``k2_error``).
    These launches come after the path's counts are read."""
    from capreolus_tpu_torch.reranker.bert.encoder import BertSelfAttention

    errs, shapes = [], set()

    def hold(module, args):
        hidden, mask = args[0], args[1]
        q, k, v = module.heads(hidden)
        errs.append(k2_error(q, k, v, mask)[0])
        shapes.add(tuple(q.shape))

    hooks = [m.register_forward_pre_hook(hold) for m in reranker.model.modules() if isinstance(m, BertSelfAttention)]
    try:
        with torch.no_grad():
            reranker.test(batch, torch.device("cuda"))
    finally:
        for h in hooks:
            h.remove()
    check(len(errs) == len(hooks) > 0, f"K2 on {label}: {len(errs)} layers held of {len(hooks)}")
    print(f"[9 K2] {label}: {len(errs)} layers at {sorted(shapes)}: max |kernel - plain| {max(errs):.3g} over "
          f"the first 128 sequences (tolerance {K2_TOL[torch.float32]})")
    held["flash_attention"] = max(held.get("flash_attention", 0.0), max(errs))
    return max(errs)


def step_parity(task, batch, label, exclude=None):
    """Step 1 from one init (``init_params`` on the CPU) and one batch: the
    loss and every gradient on the card against the CPU's, with the card's
    kernel launches in that step. ``exclude`` ({parameter: [indices]}) leaves
    ill-conditioned gradient entries out."""
    reranker, trainer = task.reranker, task.reranker.trainer
    model = reranker.init_params(trainer.config["seed"])
    trainer.make_optimizer(reranker, model)  # freezes what the trainer freezes
    micro = {k: v[0] for k, v in batch.items()}

    def grads(device):
        model.to(device)
        model.zero_grad(set_to_none=True)
        before = launch_counts()
        loss = trainer.compute_loss(reranker, micro, torch.device(device), dropout_seed=trainer.step_seed(0, 0))
        loss.backward()
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        return float(loss.detach()), {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                             if p.grad is not None}, launched

    cpu_loss, cpu_grads, _ = grads("cpu")
    card_loss, card_grads, launched = grads("cuda")
    check(set(card_grads) == set(cpu_grads), f"{label}: the card computes gradients for other parameters")
    loss_err = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-12)
    # a tensor's errors against its largest entry, or against GRAD_NOISE_FLOOR of the model's largest
    # entry where that is larger: the attention key bias's gradient is 0 but for rounding
    # (softmax is invariant to it), so its own largest entry is noise
    floor = GRAD_NOISE_FLOOR * max(float(g.abs().max()) for g in cpu_grads.values())
    grad_err, worst = 0.0, None
    for name, g in cpu_grads.items():
        diff = (card_grads[name] - g).abs()
        for index in (exclude or {}).get(name, []):
            diff[index] = 0.0
        err = float(diff.max()) / max(float(g.abs().max()), floor, 1e-30)
        if err >= grad_err:
            grad_err, worst = err, name
    print(f"[9a parity] {label}: step-1 loss {card_loss:.6f} on the card, {cpu_loss:.6f} on the CPU (rel err "
          f"{loss_err:.3g}); largest gradient error {grad_err:.3g} of its tensor's largest entry ({worst}) over "
          f"{len(cpu_grads)} tensors (tolerance {STEP_RTOL}); card launches in the step: "
          f"{ {k: n for k, n in launched.items() if n} }")
    check(loss_err <= STEP_RTOL and grad_err <= STEP_RTOL, f"{label}: step 1 on the card differs from the CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "launches": launched}


def phase_train_golden(workdir, launches, held):
    """9a: the rerank pins through the port's rerank.traineval on the card,
    step 1 on the card against the CPU, and K1 and K2 against their plain
    versions on the batches of the path."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker.common import KNRM_SIGMAS

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rerank_golden")
    constants["RESULTS_BASE_PATH"] = os.path.join(workdir, "results_rerank_golden")
    t0 = time.perf_counter()
    topics, qrels = setup_rerank_golden(os.path.join(workdir, "rerank_golden"))
    qids = sorted(topics)
    split = RERANK_GOLDEN["split"]
    dev_q, test_q = qids[split[0]:split[0] + split[1]], qids[split[0] + split[1]:]
    out = {}
    reset_launch_counts()
    for name in ("BERTMaxP", "KNRM"):
        seeds = KNRM_SEEDS if name == "KNRM" else [None]
        maps = []
        for seed in seeds:
            cfg = json.loads(json.dumps(RERANK_GOLDEN_CONFIGS[name]))
            if seed is not None:
                cfg["trainer"]["seed"] = seed
            task = rerank_task(cfg, "cuda")
            stages = count_stages(task.reranker.trainer, task.reranker)
            first = task._best_search_run()
            preds = task.rerank_run(first, task.get_results_path())
            add_launches(launches, stages)
            fs_map, test_map = golden_map(first, qrels, test_q), golden_map(preds["test"], qrels, test_q)
            check(all(np.isfinite(v) for r in preds["test"].values() for v in r.values()),
                  f"{name}: a test score is not finite")
            check(test_map > fs_map + RERANK_GAIN, f"{name} (seed {seed}): test MAP {test_map:.4f} is not "
                                                 f"{RERANK_GAIN} above the first stage's {fs_map:.4f}")
            maps.append(test_map)
        pin = RERANK_GOLDEN["pins"][name]
        mean = float(np.mean(maps))
        out[name] = {"first_stage_map": fs_map, "test_map": maps[0], "pin": pin}
        if name == "KNRM":
            out[name].update(seeds={s: round(m, 4) for s, m in zip(seeds, maps)}, mean_test_map=mean)
        print(f"[9a golden] {name} on the card: first stage {fs_map:.4f} -> test MAP "
              + (f"{maps[0]:.4f} at seed {seeds[0]}; over seeds {list(seeds)}: "
                 f"{[round(m, 4) for m in maps]}, mean {mean:.4f}" if name == "KNRM" else f"{mean:.4f}")
              + f" (pin {pin} within {RERANK_PIN_TOL}); dev MAP {golden_map(preds['dev'], qrels, dev_q):.4f}")
        check(abs(mean - pin) <= RERANK_PIN_TOL, f"{name}: test MAP {mean:.4f} is not within {RERANK_PIN_TOL} of {pin}")
        check(stages["train"]["flash_attention"] == 0, f"{name}: K2 launched inside a training step")
        if name == "BERTMaxP":
            out[name]["k2_max_abs_err"] = hold_k2(task.reranker, stages["first_predict_batch"],
                                                  "tiny BERT-MaxP's first prediction batch", held)
    exact = [KNRM_SIGMAS.index(0.001)]
    knrm = rerank_task(RERANK_GOLDEN_CONFIGS["KNRM"], "cuda")
    out["parity_knrm"] = step_parity(knrm, training_batch(knrm, 16), "KNRM (finetune, gradkernels)",
                                     exclude={"mus": exact, "sigmas": exact})
    frozen = rerank_task(dict(RERANK_GOLDEN_CONFIGS["KNRM"], finetune=False, gradkernels=False), "cuda")
    frozen_batch = training_batch(frozen, 16)
    out["parity_knrm_frozen"] = step_parity(frozen, frozen_batch, "KNRM (frozen: K1 in the step)")
    out["parity_knrm_frozen"]["k1_max_abs_err"] = hold_k1(frozen.reranker.model, {k: v[0] for k, v in frozen_batch.items()},
                                                          ("posdoc", "negdoc"), "the frozen KNRM's step-1 batch", held)
    check(out["parity_knrm_frozen"]["launches"]["knrm_pool"] == 2,
          "a frozen KNRM's training step did not launch K1 once per forward (pos, neg)")
    bert = rerank_task(dict(RERANK_GOLDEN_CONFIGS["BERTMaxP"], hidden_dropout_prob=0.0), "cuda")
    out["parity_bert"] = step_parity(bert, training_batch(bert, 16), "tiny BERT-MaxP (dropout off)")
    check(out["parity_bert"]["launches"]["flash_attention"] == 0, "K2 launched inside a BERT training step")
    print(f"[9a golden] done in {time.perf_counter() - t0:.1f} s")
    return out


def seeded_init(reranker, std=0.02):
    """Make ``reranker.init_params`` draw ``seeded_bert_params`` (N(0, std)
    matrices and embeddings) at its model's geometry, seeded by the trainer seed."""
    port_init = reranker.init_params

    def init(seed):
        model = port_init(seed)
        model.load_state_dict(reranker.state_dict_from_params(seeded_bert_params(model.config, seed, std)))
        return model

    reranker.init_params = init


def phase_training(workdir, corpus_dir, topics, qrels, launches, held):
    """9b: KNRM (frozen kernels and embeddings, K1 in every step) and
    monoBERT-MaxP at BERT-base width and depth trained by the port's rerank
    task on the card over phase 4's corpus, then the dev.best served."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService

    capreolus_tpu_torch.load_all_modules()
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")  # phase 4's indexes
    constants["RESULTS_BASE_PATH"] = os.path.join(workdir, "results_training")
    coll = {"name": "dummy", "path": corpus_dir}
    qids = [str(100 + t) for t in range(len(topics))]
    topic_of = dict(zip(qids, topics))
    register_golden(corpus_dir, *write_qrels_topics(topic_of, qrels, os.path.join(workdir, "training")), qids,
                    name="serving20k", split=TRAIN_SPLIT, collection=coll)
    test_q = qids[sum(TRAIN_SPLIT[:2]):]
    out = {}
    for label, cfg in (("knrm", KNRM_TRAIN), ("monobert", BERT_TRAIN)):
        t0 = time.perf_counter()
        task = rerank_task(cfg, "cuda", name="serving20k", collection=coll, threshold=TRAIN_THRESHOLD)
        reranker, trainer = task.reranker, task.reranker.trainer
        if label == "monobert":
            seeded_init(reranker)
        stages = count_stages(trainer, reranker)
        first = task._best_search_run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        preds = task.rerank_run(first, task.get_results_path())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        add_launches(launches, stages)
        c = trainer.config
        steps = c["niters"] * trainer.steps_per_iter
        check(stages["steps"] == steps, f"{label}: {stages['steps']} training steps, expected {steps}")
        sec = stages["seconds"]
        per_iter = (sec["train"] - sec["setup"] - sec["validation"] - sec["checkpoint"]) / c["niters"]
        per_validation = sec["validation"] / (c["niters"] // c["validatefreq"])
        k1, k2 = stages["train"]["knrm_pool"], stages["train"]["flash_attention"]
        k1_pred, k2_pred = stages["predict"]["knrm_pool"], stages["predict"]["flash_attention"]
        check(k2 == 0, f"{label}: K2 launched {k2} times inside training steps")
        if label == "knrm":
            check(k1 == 2 * steps, f"knrm: K1 launched {k1} times in {steps} training steps (one per forward: 2 per step)")
            check(k1_pred == stages["forwards"], f"knrm: K1 launched {k1_pred} times in {stages['forwards']} predictions")
        else:
            check(k1 == 0 and k2_pred == BERT_LAYERS * stages["forwards"],
                  f"monobert: K2 launched {k2_pred} times in {stages['forwards']} prediction forwards "
                  f"(expected {BERT_LAYERS} each)")
        scores = [v for r in preds["test"].values() for v in r.values()]
        want = sum(min(TRAIN_THRESHOLD, len(first.get(q, {}))) for q in test_q)
        check(len(scores) == want and all(np.isfinite(scores)),
              f"{label}: {len(scores)} test scores for {want} candidates, or one not finite")
        test_map = golden_map(preds["test"], qrels, test_q)
        results = task.get_results_path()
        for name in ("dev.best.params", "dev.best.done", "info/loss.txt", "pred/test/best", "extractor_state.pkl"):
            check((results / name).exists(), f"{label}: the trainer wrote no {name}")
        print(f"[9b {label}] {steps} steps of {c['batch']} samples: {per_iter:.2f} s per iteration of "
              f"{c['itersize']} samples ({c['itersize'] / per_iter:.1f} samples/s; train() wall from its first "
              f"step, less its validations and dev.best writes, {sec['checkpoint']:.2f} s in all; set-up before "
              f"the first step {sec['setup']:.2f} s), validation {per_validation:.2f} s "
              f"({stages['forwards']} prediction forwards of {c['evalbatch']} docs in all, {sec['predict']:.2f} s), "
              f"peak device memory {peak_gb:.2f} GB; launches in training steps: K1 {k1}, K2 {k2}; in "
              f"predictions: K1 {k1_pred}, K2 {k2_pred}; test MAP {test_map:.4f} (random init, 2 iterations)")

        # one more training step, profiled (the run's test predictions are already written)
        batch = training_batch(task, c["batch"])
        before = launch_counts()
        profiled = profile_call(lambda: trainer.train_step(reranker, trainer._model, trainer._optimizer, batch,
                                                           steps, trainer.step_seed(c["niters"], 0)),
                                f"[9b {label}]", what="training step")
        check(launch_counts()["flash_attention"] == before["flash_attention"], f"{label}: K2 in the profiled step")
        # the path's kernels against their plain versions on its own batches
        if label == "knrm":
            k_err = max(hold_k1(trainer._model, {k: v[0] for k, v in batch.items()}, ("posdoc", "negdoc"),
                                "the full-width KNRM's training batch", held),
                        hold_k1(trainer._model, stages["first_predict_batch"], ("posdoc",),
                                "the full-width KNRM's first prediction batch", held))
        else:
            k_err = hold_k2(reranker, stages["first_predict_batch"], "monoBERT-MaxP's first prediction batch", held)

        # dev.best served: the trainer's own test prediction of the first test query's docs
        q0 = test_q[0]
        docids = list(preds["test"][q0])
        serve_cfg = {k: v for k, v in cfg.items() if k not in ("name", "trainer")}
        serve_cfg["extractor"] = dict(serve_cfg.get("extractor", {}), index={"collection": coll})
        svc = RerankingService(Index.create("tpu", {"collection": coll}), Reranker.create(cfg["name"], serve_cfg),
                               results / "dev.best", TRAIN_THRESHOLD, str(results / "extractor_state.pkl"),
                               device="cuda")
        with torch.inference_mode():
            served = svc.reranker.test(svc.rerank_batch(q0, topic_of[q0], docids), svc.device).cpu().numpy()
        err = float(np.max(np.abs(served - np.array([preds["test"][q0][d] for d in docids]))))
        print(f"[9b {label}] dev.best served by RerankingService(checkpoint_path, extractor_state_path) on the "
              f"card: query {q0}'s {len(docids)} docs within {err:.3g} of the trainer's test prediction "
              f"(tolerance {SERVED_DEV_BEST_TOL}); phase {time.perf_counter() - t0:.1f} s")
        check(err <= SERVED_DEV_BEST_TOL, f"{label}: the served dev.best differs from the trainer's prediction")
        out[label] = {"seconds_per_iter": per_iter, "samples_per_s": c["itersize"] / per_iter,
                      "checkpoint_s": sec["checkpoint"], "train_s": sec["train"], "setup_s": sec["setup"],
                      "validation_s": per_validation, "peak_gb": peak_gb, "test_map": test_map,
                      "busy_share": profiled["busy_ms"] / profiled["wall_ms"], "step_wall_ms": profiled["wall_ms"],
                      "top_ops": profiled["top_ops"][:4], "launches_training": {"knrm_pool": k1, "flash_attention": k2},
                      "launches_training_predict": {"knrm_pool": k1_pred, "flash_attention": k2_pred},
                      "served_max_abs_err": err, "kernel_max_abs_err": k_err}
        del task, reranker, trainer, svc
        torch.cuda.empty_cache()
    return out


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
        k1_launches, corpus_dir, topics, qrels = timed(phase_serving, workdir, SERVING_DOCS, ckpt_seed=3)
        k2_launches, k2_served, f32 = timed(phase_bert_serving, workdir, corpus_dir, topics, peaks)
        bert_int8_launches, bert_int8 = timed(phase_bert_int8_serving, workdir, corpus_dir, topics, f32)
        colbert_launches, k3_served, none = timed(phase_colbert_serving, workdir, corpus_dir, topics, peaks)
        colbert_int8_launches, colbert_int8 = timed(phase_colbert_int8_serving, workdir, corpus_dir, topics, none)
        timed(phase_rank_task, workdir)
        training_launches, training_held = {"train": {}, "predict": {}}, {}
        golden = timed(phase_train_golden, workdir, training_launches, training_held)
        training = timed(phase_training, workdir, corpus_dir, topics, qrels, training_launches, training_held)
        print("[9 training] summary " + json.dumps({"golden": golden, "full_width": training}, default=str))
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
    for entry in kernels:  # phase 9: launches inside training steps, and inside the trainer's predictions
        entry["launches_training"] = training_launches["train"].get(entry["name"], 0)
        entry["launches_training_predict"] = training_launches["predict"].get(entry["name"], 0)
        if entry["name"] in training_held:  # against the plain version on phase 9's own batches
            entry["max_abs_err_training"] = training_held[entry["name"]]
    print(f"[7 done] every phase passed in {time.perf_counter() - t_start:.1f} s; seconds by phase: "
          f"{json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
