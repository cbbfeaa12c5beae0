#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drives retrieve-then-rerank serving on
one NVIDIA GPU, with KNRM and with monoBERT-MaxP at BERT-base width (f32, then
int8), then ColBERT late-interaction serving at BERT-base width (a bf16 corpus,
then int8 and int4 corpora), then the rank task's sparse searchers over the
50k-doc golden corpus, then trains KNRM and monoBERT-MaxP through the rerank
task, then times the sparse engine at bench.py's 200k-doc shape, then runs a
Robust04-shaped experiment through ``rank.searcheval``, then serves PARADE,
CEDR-KNRM, Birch and MoE-BERT and trains them through their tasks, then trains
LoRA BERT-MaxP, CEDR-KNRM and KNRM under ``trainer.amp`` and the ColBERT
reranker and serves what they wrote, then serves and trains the reranker zoo,
then serves dense and learned-sparse retrieval and trains its rerankers,
then drives the ColBERT options, snippets, the HTTP front end and NRT
refresh, then serves doc-sharded BM25, dense and ColBERT over 4 shards on the
card with device metrics and a sharded checkpoint, then trains BERT-MaxP
over a mesh of four devices, then runs the rank task over ``irds.*``
benchmarks, and holds every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # needs one CUDA device; builds the kernels
    python3 chip_smoke.py --only 18  # the build and phase 18 alone
    python3 chip_smoke.py --only 19  # phase 19 alone

Phases (each prints a line; any fault exits non-zero, and the last line is
printed only when every phase passed):

1. device: the card, its power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2b. native (before 2): ``native_status()`` must show the port's three C++ host
   helpers (``native/analyzer.cpp``, ``trec_reader.cpp``, ``pruner.cpp``)
   built by g++ and loaded (g++'s version and each library's build seconds
   printed); no phase may fall back to the numpy and Python paths; then
   phase 4's card-free set-up starts in a process of its own;
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
   the int8 ColBERT engine's MaxSim epilogue (``maxsim_epilogue``) bit for bit
   against ``maxsim_epilogue_plain`` at the served 64-query chunk [2,048 x
   65,520], at prefilter's one query over 1,000 docs and at ragged shapes,
   timed beside its bound (one launch per X1 launch of the engine in phases
   6b, 16a and 17d);
   then the weight, GELU and ColBERT query scales (and their codes) computed
   on the card must equal the CPU's bit for bit;
4. KNRM serving: a seeded synthetic TREC corpus (20k docs of 200-1200 words),
   the port's index (the corpus, the index and the extractor's state over the
   corpus built and timed by the set-up process beside phases 2-3, read back
   from the cache here) and a ``RerankingService(device="cuda")`` with KNRM at its
   published width (random300 embeddings, maxqlen 4, maxdoclen 800, 11 RBF
   kernels, topn 100, frozen kernels and embeddings, so the forward pass runs
   K1) serve 8 queries; the launch counts are read around that run, and the
   same queries served on the CPU must agree;
5. monoBERT serving: the same corpus, caches of its own (phase 4's two
   indexes of the corpus copied in: phase 4 built and timed them), BERTMaxP at BERT-base width
   and depth (seeded N(0, 0.02) weights; hash-wordpiece tokenizer) over
   bertpassage at its defaults (maxseqlen 256, 16 passages of 150 tokens,
   stride 100), topn 100: one warm-up request, then 2 served queries with 12
   K2 launches each (one batch of 1600 passages per layer); one profiled
   request, whose copy kernels are counted: fewer than one per layer, so no
   head split or merge copy is left; K2 timed on a served request's layer-0
   head views, as served in f32 and cast to bf16; the GPU scores of
   query 0's two top first-stage candidates against the same reranker on the
   CPU, max |err| <= 1e-3;
5b. monoBERT int8 serving: the same corpus, caches and checkpoint with
   ``quantize=int8``: one warm-up request, which calibrates the GELU scales on
   its batch, then the 2 queries with 72 X1 launches (q, k, v, output,
   intermediate, ffn_output in 12 layers: 60 in the f32 epilogue, 12 in the
   int8-gelu one), 36 Q1 launches (three per layer), no zero-padded copy and
   12 K2 launches each, and the run's peak device memory; one profiled
   request, with the copy check of phase 5; query 0's top candidate on
   the GPU against the port's int8 path on the CPU with the same stats, layer
   by layer from the
   card's input to each layer (max |err| <= 5e-2: a code on a rounding
   boundary can flip by one step between devices) and the head from the card's
   last layer (<= 1e-3); the end-to-end GPU-vs-CPU gap, the card's own gap
   when its embeddings move by 1e-7, and the int8-vs-f32 score gap and top-10
   overlap of query 0 are reported;
6. ColBERT serving: the same corpus, caches of its own (phase 4's index
   copied in), ``ColbertRetrievalService``
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
   both indexes built (plain and with positions, timed; the corpus and the
   builds in a process of its own, started after phase 4 beside phases 5-7,
   with phase 10's corpora); the port's
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
   fold of 15 / 5 / 5, threshold 50: KNRM at its published width with frozen
   kernels and embeddings (K1 in every step) and monoBERT-MaxP at BERT-base
   width and depth (seeded N(0, 0.02) weights, bertpassage defaults, batch 32,
   itersize 256, 1 iteration, dropout 0.1), each with its seconds per
   iteration, samples per second, validation seconds, peak device memory and
   one profiled training step (device busy share, top ops); the launches of K1
   and K2 in training steps (K2: 0; K1: one per forward) and in predictions;
   K1 against its plain version on KNRM's training batch (B 32, both sides)
   and first prediction batch, K2 at every layer of monoBERT-MaxP's first
   prediction batch; then ``dev.best`` and ``extractor_state.pkl`` served by
   ``RerankingService`` on "cuda", query 0's scores within 1e-5 of the
   trainer's own test prediction;
10. the sparse engine at scale (after 9): ``index/synth.py``'s uniform and
   clustered 200k-doc corpora (bench.py's headline shape, cached under the
   gitignored ``build/sparse``, built by phase 8's set-up process beside
   phases 5-9), bench.py's traffic (2048 queries of 4 terms
   of 50 < df < 20k, batches of 256, k = 1000, BM25 k1 = 0.9 b = 0.4); per
   corpus the modes exact, tiered (``search_stream``, bench.py's bf16 scores
   and packed ordinals; and in f32), pruned adaptive and forced
   (``search_pruned_stream``), ``maxpostings`` 100, streaming with a quarter
   of the tiles' bytes as budget (exhaustive and pruned), and tiered,
   forced-pruned and adaptive-pruned at k = 10, each with queries/s (best and
   median of 2 pipelined passes), ms per batch, peak device memory, one
   profiled batch (busy share, top device ops), the prune and stream
   statistics and the adaptive verdicts, the numpy span builder's earlier rows beside; the
   span build alone per batch, native against numpy, at k = 10 and 1000
   (total lanes and tiles equal, kept tiles within 5% of the total); checks:
   tiered against exact (the same docs, scores within 1e-5), the packed
   ordinals and bf16 scores against f32 tiered, pruned and streamed
   bit-identical to resident tiered, card against CPU on 32 queries (tiered
   and capped: ordinals identical but for near-ties, scores within 1e-6 of
   the row's top score), no port kernel launched; then exact against tiered
   on 25k-200k-doc prefixes of the uniform corpus, pipelined and one batch
   alone, where tiered becomes faster against the engine's 65,536-doc rule;
11. a Robust04-shaped experiment (after 10): 66k seeded docs of 200-1200
   words in Robust04's TREC layout (1000 a file, cached under the gitignored
   ``build/robust04_shaped``; Robust04 itself has 528,155 docs), Robust04's
   250 shipped topics planted in 5-30 docs each with graded qrels written to
   ``benchmark.qrelfile``; index builds timed: native porter over every doc,
   and on a 1k-doc prefix the native build, the Python path
   (``CAPREOLUS_NATIVE=0``, its arrays identical to the native build's) and
   krovetz; ``rank.searcheval`` with ``benchmark.name=robust04.yang19`` (its
   shipped five folds) for BM25 and BM25RM3 (fbTerms 10, fbDocs 10), both on
   the tiered path's pruned stream with native spans (the corpus is above the
   engine's 65,536-doc exact rule), on "cuda" and the CPU (the corpus, the
   builds and the CPU's runs in a process of their own, started before phase
   5 and waited for here, on 4 of the host's threads): BM25's run
   files docid for docid with scores within 1e-6, RM3's equal but for
   near-ties, every metric within 1e-4, ``significance.compare_runs`` of BM25
   against RM3 (MAP) within 1e-4 on both, search seconds, and the busy share
   of one profiled BM25 search; no port kernel launched;
12. the other BERT rerankers (after 11), served by ``RerankingService`` over
   phase 4's corpus with phase 5's indexes (BM25, topn 100, k 10; seeded N(0,
   0.02) weights, TF32 off), each with request ms (median and spread), host
   features ms, peak device memory, one profiled request (busy share, top
   device ops) and its launches counted from 0: 12a PARADE at BERT-base width
   (``aggregation=transformer``; pooledbertpassage as
   ``config_parade.txt``: 16 passages of 150, stride 75), 1 query in f32
   (K2 14 times a request: 12 encoder and 2 aggregation layers), 1 doc card
   vs CPU within 1e-3, K2 held against its plain version at every attention
   of a served forward (L 256 and the aggregation layers' L 17), then 2 in
   int8 (84 X1 and 42 Q1 a request, the aggregation layers calibrated and,
   from the card's input, within 5e-2 of the CPU's, the head within 1e-3; the
   int8-vs-f32 gap and top-10 overlap reported); 12b CEDR-KNRM at
   electra-base width as ``config_cedrknrm_pt.txt`` (13 simmat layers, cls
   avg, combine_hidden 1024, 4 passages of 225), 1 query, 2 docs within
   1e-3; 12c Birch at bert-large width over a seeded
   ``BertForNextSentencePrediction`` checkpoint it writes with ``torch.save``
   under the gitignored ``build/`` (the encoder and NSP head on the card equal
   to the tensors written; frozen; birchbertpassage with ``sentences=True``,
   through the splitter), 1 query, 24 K2 launches a request, 1 doc within
   2e-3; 12d BERTMaxP with 4 experts of top-2 in every layer (a dense
   checkpoint refused), 1 query, 1 doc on the CPU layer by layer from the
   card's input (tokens routed alike within 1e-3; routing flips counted, at
   most 1e-3 of the tokens) and the head from the card's last layer within
   1e-3; 12e
   at tiny width on phase 9a's rerank golden: ``rerank.traineval`` for
   PARADE, CEDR-KNRM and Birch (step 1 card vs CPU within 1e-4, no K2 in a
   step), ``rerank.bircheval`` equal to ``eval_runs`` of its run file, and
   ``rererank.traineval`` with KNRM then tiny BERT-MaxP over the top 3, each
   test MAP reported;
13. what the trainer left (after 12), over phase 4's corpus and topics in
   phase 9b's fold (benchmark ``trainer_options``), threshold 50: 13a
   BERTMaxP at BERT-base width with ``lora=8``, ``loraalpha=16`` over a seeded
   BERT-base checkpoint directory it writes, trained by ``rerank.traineval``
   (batch 32, 1 iteration of 8 steps): seconds per iteration, step ms, peak
   memory and optimizer-state bytes beside phase 9b's full fine-tune, the
   dev.best bytes, the frozen base bit-identical to the checkpoint after
   training, no K2 in a step; the dev.best served by ``RerankingService`` in
   f32 (12 K2 a request, no head copy, the frozen base the checkpoint's, 1 doc
   card vs CPU within 1e-3) and int8 (72 X1, 36 Q1, 12 K2 a request; each layer
   on the CPU from the card's input within 5e-2, the head 1e-3), 2 requests of
   100 docs each; 13b ``trainer.amp``: CEDR-KNRM at electra-base width as
   ``config_cedrknrm_pt.txt`` (``amp=both``, batch 6, 4 passages of 225, 13
   simmat layers, evalbatch 128): step 1 card vs CPU on 1 of its samples with
   dropout off (loss 1e-4, gradients 2^-8 of each tensor's largest entry), 4
   steps timed, a prediction of 50 docs in amp and in f32 (the score gap, 12
   K2 each); a frozen KNRM at phase 9's width under ``amp=both`` through the
   rerank task, K1 twice a step and once a prediction forward, held against
   its plain version on the bf16-normalised rows amp hands it (RBF kernels
   2e-4, the exact-match kernel 1e-3); one monoBERT ``amp=pred`` prediction
   of 50 docs beside f32; 13c the ``colbert`` reranker at BERT-base width
   (dim 128, maxqlen 32, maxdoclen 180) trained by the rerank task (batch 32,
   8 steps; no K3 and no K2 in a step, 24 K2 per prediction forward), its
   dev.best the ``checkpointfile`` of ``ColbertRetrievalService`` over the
   first 4,000 docs of phase 4's corpus in bf16 (exact resident search, 100
   hits, either size): set-up, 8 single queries and one 64-query batch (9 K3
   launches), K3 timed on the served corpus, query 0's top 10 card vs CPU
   within 1e-2;
15. dense and learned-sparse retrieval (after 14), over a seeded BERT-base
   ``BertForMaskedLM`` checkpoint directory it writes with ``torch.save``:
   15a ``DenseRetrievalService`` over phase 4's corpus at the dense searcher's
   defaults (maxdoclen 256, maxqlen 32, batch 128, hits 1000, mean pooling),
   one embedding cache for every engine (bf16, int8, int4 with rescore 200,
   IVF with 128 cells probing 8 and 128, streamed in 4 chunks, prf 10): set-up,
   8 single queries and one 128-query batch, peak memory and a profiled
   request each; 12 K2 launches per query batch, X1 on every int8 / int4
   batch and equal to plain on the served product; K2 against plain at layer
   0 of a served doc (L 256) and query (L 32) batch; card vs CPU the
   embeddings of query 0 and 8 docs (1e-3) and every engine's top 1000 over
   the card's own matrix (near-ties, 1e-5); streamed bit-identical to
   resident; IVF with every cell probed equal to exact, with 8 its recall;
   15d ``HybridRetrievalService`` (rrf and interp, depth 100) over BM25 and
   15a's bf16 service, equal to ``fusion.py``'s math on the host; 15b the
   engines over a seeded clustered 1M x 768 matrix written into the dense
   cache (MS MARCO passage's width, cut from 8.8M rows): a 128-query batch at
   k 1000, the product and the selection apart, peak memory and busy share;
   X1 and the bf16 product at [128 x 768] x [1M x 768]; 15c
   ``ImpactRetrievalService`` for uniCOIL and SPLADE over the first 4,000
   docs of phase 4's corpus (exact scoring at either size): set-up, postings, requests, raw impacts of 8 docs card vs
   CPU (1e-3) and rankings from the card's CSR equal on both devices; 15e the
   biencoder (``loss=infonce``), uniCOIL and SPLADE (with its regularizer)
   at BERT-base width: step 1 card vs CPU on 2 samples (1e-4; SPLADE's
   decoder rows whose max over positions is a near-tie left out), 8 steps
   timed, no K2 in a step; the biencoder and uniCOIL through
   ``rerank.traineval`` at tiny width on the rerank golden, each dev.best
   served by ``rank.searcheval`` with hits (its test MAP reported; uniCOIL
   with dropout 0 from its init at trainer seed 53, which trains in the JAX
   package too, where the default seed's dies in both);
16. the serving families (after 15): 16a the ColBERT options over phase 6's
   cache (no encoding): ``prefilter`` 200 and 1000 over the bf16 and int8
   corpora (8 single queries and the 64-query batch; K3 or X1 once per query
   over its gathered candidates; stage-2 scores equal to the exact engine's
   bit for bit; top-10 overlap with exact; query 0's top 10 card vs CPU
   within 1e-2), the host stream at a quarter of the device bytes (slices
   counted, the top 100 bit-identical to the resident engine) and an int4
   corpus over the budget raising JAX's message; K3 on gathered candidates
   and on a streamed slice, X1 on int8 ones, against their plain versions;
   16c snippets of 8 queries' top 10 on the BM25, ColBERT, bf16 dense and
   uniCOIL services, equal to a CPU reader's; 16d the HTTP front end over
   BM25 and bf16 dense on 127.0.0.1: 256 requests from 16 clients (p50, p99,
   batches), ``/search`` equal to ``search``, ``/health``'s corpus size; 16b,
   last: 256 seeded docs added and 128 deleted, then ``refresh()`` of the
   four services (merge and refresh s; exactly the added docs encoded, K2
   12 times a batch there and held against plain at layer 0; deleted docs
   absent; 8 queries' hits equal to a new service's over the new generation);
17. doc-sharded serving, device metrics and sharded checkpoints (after 16),
   4 shards on one card (``devices=["cuda"] * 4``: no copy between cards is
   measured): 17a ``RetrievalService(shards=4)`` over phase 10's uniform
   200k-doc corpus (cached under build/sparse), 2048 queries in batches of
   256 at k 1000: queries/s beside the single-device service's, 512 queries'
   rankings held to it (1e-5, near-ties), no port kernel launched; 17c the
   bf16 and int8 ``DenseRetrievalService`` over phase 15's cache (one query,
   median of 8, and a 128-query batch, sharded and resident; the sharded top
   1000 equal to the resident engine's, int8 bit for bit, bf16 within 1e-5;
   X1 on every shard of every int8 batch) and phase 15b's 1M x 768 matrix at
   128 queries (each shard's product, its top-k and the merge timed apart);
   17d ColBERT over phase 6's cache, bf16 (K3 once per shard and query batch)
   and int8 (X1): one query (median of 4) and the 64-query batch, scores equal
   to the resident engine's bit for bit, K3 and X1 on shard 0 against their
   plain versions; 17e device metrics against the host's on a 1000-query x
   1000-deep run (1e-5, both timed) and phase 9's validations that took the
   device path; 17f one ``trainer.ckpt=sharded_async`` save and resume of a
   BERT-base reranker with its Adam state (the caller's blocked time against
   the writer's, the bytes, equal weights and state); 17b, last (its refresh
   changes phase 4's index): one ``RerankingService`` request over a sharded
   first stage equal to the single-device service's (K1 once), and a
   ``refresh()`` under shards after one added and one deleted doc;
19. the rank task over ``irds.*`` benchmarks (after 18): the seeded stand-in
   of ``tests/torch_irds_standin.py`` in ``sys.modules`` as ``ir_datasets``
   (4,000 docs, two datasets of 8 queries over one parent); ``get_irds``
   registers each dataset (one collection, no path, so one index), then
   ``rank.searcheval`` with BM25 on "cuda" and on the CPU: per dataset the
   run files docid for docid with scores within 1e-6 relative, every metric
   equal, no port kernel launched;
7. the seconds each phase took, a ``kernels`` JSON line (each kernel also with
   ``launches_training`` and ``launches_training_predict``, phase 9's
   launches in training steps and in the trainer's predictions, and K1 and
   K2 with ``max_abs_err_training``, their largest error on phase 9's own
   batches; K2, X1 and Q1 with phase 12's launches, K2 with its errors there;
   each kernel with ``launches_phase13``, its launches in phase 13's served
   runs, training steps and predictions, the served ones also in
   ``launches``; K1 with its error on bf16 rows; K2 and X1 with
   ``launches_phase15`` and ``max_abs_err_phase15``, X1's 1M-doc shape under
   ``served_shapes``; K2, K3 and X1 with ``launches_phase16``, K2's error in
   16b's encoding, K3's ``phase16`` measurements on gathered candidates and a
   streamed slice, X1's ``equal_plain_phase16``; every kernel with
   ``launches_phase17``, K3 and X1 with their ``phase17_shard0`` measurements),
   then the result line.

Every kernel's launch count is set to 0 just before each serving path runs
and read just after it.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
PREFIX_DOCS = 4000  # the prefix of that corpus that phase 13c's trained ColBERT (exact resident search, 100 hits)
# and phase 15's impact services (uniCOIL, SPLADE; exact scoring either side of it, EXACT_MAX_DOCS) serve: no
# dispatch rule of theirs turns on the corpus size there. SPLADE's f32 decoder is ~12 GFLOP a document
TIMED_ROUNDS = 25  # timed rounds of 20 back-to-back calls per kernel (median)
BERT_QUERIES = 2  # served monoBERT queries after the warm-up request
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
INT8_CPU_DOCS = 2  # query 0's top candidates that phase 5b runs on the CPU too, layer by layer and end to end
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


def corpus_prefix(workdir, corpus_dir):
    """The first PREFIX_DOCS docs of phase 4's corpus as a TREC directory of
    their own, written once from phase 4's index."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index

    n = PREFIX_DOCS
    out = os.path.join(workdir, f"corpus_prefix_{n}")
    if not os.path.isdir(out):
        base = constants["CACHE_BASE_PATH"]
        constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")
        try:
            index = Index.create("tpu", {"collection": {"name": "dummy", "path": corpus_dir}})
            index.create_index()
            write_trec([(d, index.get_doc(d)) for d in index.data.docid_strings[:n]], out)
        finally:
            constants["CACHE_BASE_PATH"] = base
    return out


EXTRACTOR_INDEX = {"indexstops": True, "stemmer": "none"}  # the extractors' index options over a corpus


def copy_phase4_indexes(workdir, corpus_dir, *options):
    """Phase 4's indexes of its corpus (one per index options dict: ``{}``
    the first stage's, ``EXTRACTOR_INDEX`` the extractors') copied into the
    current cache base, where a later phase serves the same corpus from
    caches of its own; phase 4 built and timed each. Returns the seconds."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index

    t0 = time.perf_counter()
    for opts in options:
        rel = Index.create("tpu", {**opts, "collection": {"name": "dummy", "path": corpus_dir}}).get_module_path()
        src = Path(workdir) / "cache" / rel / "index"
        check((src / "done").exists(), f"phase 4 built no index at {src}")
        shutil.copytree(src, Path(constants["CACHE_BASE_PATH"]) / rel / "index")
    return time.perf_counter() - t0


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


def knrm_serving_config(corpus_dir):
    """Phase 4's KNRM reranker config over the corpus at ``corpus_dir``."""
    return {"gradkernels": False, "finetune": False,
            "extractor": {"embeddings": "random300", "maxqlen": 4, "maxdoclen": 800,
                          "index": {"collection": {"name": "dummy", "path": corpus_dir}}}}


def serving_setup(workdir, num_docs=SERVING_DOCS):
    """Phase 4's card-free set-up: the seeded corpus written under
    ``workdir/corpus``, its first-stage index and the KNRM extractor's state
    over it, built into the cache base of this process. Returns the corpus
    directory, topics, qrels and the seconds of each step."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.reranker import Reranker

    capreolus_tpu_torch.load_all_modules()
    t0 = time.perf_counter()
    docs, topics, qrels = build_corpus(num_docs, num_topics=25, seed=20260819, min_len=200, max_len=1200)
    corpus_dir = os.path.join(workdir, "corpus")
    write_trec(docs, corpus_dir)
    out = {"corpus_dir": corpus_dir, "num_docs": num_docs, "topics": topics, "qrels": qrels,
           "corpus_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    index = Index.create("tpu", {"collection": {"name": "dummy", "path": corpus_dir}})
    index.create_index()
    out["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()  # the state RerankingService's preprocess reads back from the extractor's cache
    Reranker.create("KNRM", knrm_serving_config(corpus_dir)).extractor.preprocess(
        [], list(index.data.docid_strings), {})
    out["extractor_s"] = time.perf_counter() - t0
    return out


def phase_serving(workdir, setup, ckpt_seed):
    """Phase 4 over ``setup`` (``serving_setup``'s result, here or in the
    set-up process, whose index and extractor state the service reads back
    from the cache)."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.ops.simmat import knrm_pool
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService, RetrievalService

    capreolus_tpu_torch.load_all_modules()
    corpus_dir, topics, qrels = setup["corpus_dir"], setup["topics"], setup["qrels"]
    coll = {"name": "dummy", "path": corpus_dir}
    rr_cfg = knrm_serving_config(corpus_dir)
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
    print(f"[4 serving] set-up before this phase: corpus {setup['corpus_s']:.1f} s ({setup['num_docs']} docs), "
          f"first-stage index {setup['index_s']:.1f} s, extractor over the corpus {setup['extractor_s']:.1f} s (host "
          f"tokenization); here: index read in {t_index:.1f} s, service {t_service:.1f} s (of which the "
          f"extractor's state read from its cache {svc.extractor_seconds:.1f} s)")

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
    return launches, corpus_dir, topics, qrels, (reranker, ckpt)


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
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")  # a serving process's own caches
    coll = {"name": "dummy", "path": corpus_dir}
    config = get_bert_config("bert-base-uncased")
    t0 = time.perf_counter()
    ckpt = save_params(seeded_bert_params(config, seed=4), os.path.join(workdir, "bert.npz"))
    t_ckpt = time.perf_counter() - t0
    t_index = copy_phase4_indexes(workdir, corpus_dir, {}, EXTRACTOR_INDEX)  # built and timed by phase 4
    index = Index.create("tpu", {"collection": coll})
    index.create_index()
    rr_cfg = {"pretrained": "bert-base-uncased", "allowrandominit": True, "extractor": {"index": {"collection": coll}}}
    t0 = time.perf_counter()
    reranker = Reranker.create("BERTMaxP", rr_cfg)
    svc = RerankingService(index, reranker, ckpt, topn=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    ext = reranker.extractor.config
    print(f"{label} set-up: seeded BERT-base checkpoint {t_ckpt:.1f} s ({os.path.getsize(ckpt) / 1e6:.0f} MB), "
          f"phase 4's first-stage and extractor indexes copied in {t_index:.1f} s, service {t_service:.1f} s (of "
          f"which the bertpassage extractor {svc.extractor_seconds:.1f} s; the rest builds the model, loads the "
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

    # query 0's top INT8_CPU_DOCS first-stage candidates, the card against the CPU with the same weights and
    # stats. int8 makes each layer a step function of its input: where the two devices' f32
    # LayerNorm, softmax and GELU round apart, a code on a rounding boundary flips by one step, and
    # over 12 layers the flips add up (measured below: the card's own scores move about as much when
    # the embeddings move by 1e-7). So the CPU runs each layer from the card's input to that layer.
    hits = RetrievalService.search_async(svc, [queries[0]], k=svc.topn)()[0]
    docids = [d for d, _ in hits[:INT8_CPU_DOCS]]
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
    print(f"{label} query 0's top {len(docids)} first-stage docs {docids}, GPU vs CPU ({cpu_s:.1f} s with the CPU): "
          f"each layer from the card's input, max |err| {max(layer_err):.3g} (per layer {', '.join(f'{x:.2g}' for x in layer_err)};"
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


def epilogue_bound_ms(nq, lq, valid_tokens, c, ld, peaks):
    """Least time for the MaxSim epilogue of one chunk: the int32 similarities
    of the valid tokens read once (``valid_tokens`` over the chunk's docs), the
    mask and the scales read once and the [nq, c] f32 scores written once,
    over the HBM rate. Its operations (a conversion and a max a similarity, lq
    adds a score) lie far below the f32 peak."""
    nbytes = 4.0 * nq * lq * valid_tokens + c * ld + 4.0 * (nq + c) + 4.0 * nq * c
    return nbytes / peaks["bw"] * 1e3


def epilogue_chunk(nq, lq, c, ld, gen):
    """A chunk of the int8 ColBERT engine on the card: sim [nq*lq, c*ld] over
    the int8 products' range, doc lengths from the int8 benchmark's lognormal
    (median 66 tokens, sigma 0.45, clipped to 8-ld; mean 72.6 at ld 180) as
    prefixes, every 7th doc with holes, doc 3 with no valid token; the query
    and doc scales."""
    top = 127 * 127 * 128
    sim = torch.randint(-top, top + 1, (nq * lq, c * ld), generator=gen, device="cuda", dtype=torch.int32)
    normal = torch.randn(c, generator=gen, device="cuda")
    lengths = torch.exp(np.log(66.0) + 0.45 * normal).round().clamp(min(8, ld), ld)
    mask = torch.arange(ld, device="cuda")[None, :] < lengths[:, None]
    mask[::7] = torch.rand(mask[::7].shape, generator=gen, device="cuda") > 0.5
    mask[3 % c] = False
    qscale = torch.rand(nq, generator=gen, device="cuda") * 1e-2 + 1e-3
    dscale = torch.rand(c, generator=gen, device="cuda") * 1e-2 + 1e-3
    return sim, mask.contiguous(), qscale, dscale


def phase_epilogue_check(peaks):
    """The int8 ColBERT engine's MaxSim epilogue kernel against its plain
    version, bit for bit: at the served chunk (64 queries of 32 tokens over
    ``quantized_chunk_docs`` docs of 180 slots: [2,048 x 65,520]), at
    prefilter's one query over 1,000 candidates, and at ragged shapes (an odd
    Lq, Ld off 4 and off 2, a chunk with no valid doc), each writing into the
    middle of a wider score matrix; timed at the served chunk beside its bound
    and the plain version."""
    from capreolus_tpu_torch.ops.maxsim_epilogue import maxsim_epilogue, maxsim_epilogue_plain
    from capreolus_tpu_torch.searcher.late_interaction import quantized_chunk_docs

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    lq, ld = COLBERT["maxqlen"], COLBERT["maxdoclen"]
    c = quantized_chunk_docs(64, lq, ld)
    for label, (nq, q_len, docs, d_len, none_valid) in (
            ("prefilter", (1, lq, 1000, ld, False)), ("odd_lq", (3, 5, 70, ld, False)),
            ("ld_13", (2, 7, 45, 13, False)), ("ld_6", (5, 3, 40, 6, False)), ("no_valid_doc", (4, lq, 50, ld, True))):
        sim, mask, qscale, dscale = epilogue_chunk(nq, q_len, docs, d_len, gen)
        if none_valid:
            mask[:] = False
        got = maxsim_epilogue(sim, mask, qscale, dscale, torch.full((nq, docs + 21), 7.0, device="cuda"), 13)
        want = maxsim_epilogue_plain(sim, mask, qscale, dscale, torch.full((nq, docs + 21), 7.0, device="cuda"), 13)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"maxsim_epilogue {label} [{nq * q_len} x {docs * d_len}]: differs from plain")
    sim, mask, qscale, dscale = epilogue_chunk(64, lq, c, ld, gen)
    scores = torch.empty((64, c), device="cuda")
    got = maxsim_epilogue(sim, mask, qscale, dscale, scores, 0)
    want = maxsim_epilogue_plain(sim, mask, qscale, dscale, torch.empty_like(scores), 0)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"maxsim_epilogue served chunk [{64 * lq} x {c * ld}]: differs from plain")
    valid = int(mask.sum())
    out = {"shape": f"Q=64 Lq={lq} C={c} Ld={ld} (sim [{64 * lq} x {c * ld}] int32)", "max_abs_err": 0.0,
           "valid_token_share": valid / (c * ld),
           "ms": cuda_ms(lambda: maxsim_epilogue(sim, mask, qscale, dscale, scores, 0), rounds=10, calls=10),
           "plain_ms": cuda_ms(lambda: maxsim_epilogue_plain(sim, mask, qscale, dscale, scores, 0), rounds=5,
                               calls=2),
           "bound_ms": epilogue_bound_ms(64, lq, valid, c, ld, peaks), "bound_by": "bytes",
           "library_ms": None}  # no single PyTorch call computes the masked max and the tree sum
    print(f"[3 kernel] maxsim_epilogue {out['shape']}: bit-identical to plain (and at prefilter's 1 x 1,000, an odd "
          f"Lq, Ld 13 and 6, a chunk with no valid doc); {out['valid_token_share']:.3f} of the slots valid; "
          f"{out['ms']:.4f} ms (plain {out['plain_ms']:.3f}, bound {out['bound_ms']:.4f} by bytes)")
    del sim, mask, scores, got, want
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
    from capreolus_tpu_torch.ops.maxsim_epilogue import maxsim_epilogue
    from capreolus_tpu_torch.ops.quantization import quantize_per_token
    from capreolus_tpu_torch.ops.simmat import knrm_pool

    return {"knrm_pool": knrm_pool.launches, "flash_attention": flash_attention.launches,
            "maxsim": maxsim.launches, "int8_matmul": int8_matmul.launches,
            "quantize_per_token": quantize_per_token.launches, "maxsim_epilogue": maxsim_epilogue.launches}


def reset_launch_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    from capreolus_tpu_torch.ops.flash_attention import flash_attention
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul
    from capreolus_tpu_torch.ops.maxsim import maxsim
    from capreolus_tpu_torch.ops.maxsim_epilogue import maxsim_epilogue
    from capreolus_tpu_torch.ops.quantization import quantize_per_token
    from capreolus_tpu_torch.ops.simmat import knrm_pool

    knrm_pool.launches = flash_attention.launches = maxsim.launches = int8_matmul.launches = 0
    quantize_per_token.launches = int8_matmul.pad_copies = maxsim_epilogue.launches = 0
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
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_colbert")  # a serving process's own caches
    config = get_bert_config("bert-base-uncased")
    t0 = time.perf_counter()
    ckpt = str(save_params(colbert_params(config, COLBERT["dim"], seed=7), os.path.join(workdir, "colbert.npz")))
    t_ckpt = time.perf_counter() - t0
    searcher = Searcher.create("colbert", {**COLBERT, "pretrained": "bert-base-uncased", "allowrandominit": True,
                                           "checkpointfile": ckpt,
                                           "index": {"collection": {"name": "dummy", "path": corpus_dir}}})
    t_index = copy_phase4_indexes(workdir, corpus_dir, {})  # built and timed by phase 4
    searcher.index.create_index()
    t0 = time.perf_counter()
    svc = ColbertRetrievalService(searcher, max_k=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    corpus = svc._corpus
    corpus_gb = sum(t.numel() * t.element_size() for t in corpus) / 1e9
    setup = searcher.setup_seconds
    print(f"{label} set-up: seeded checkpoint {t_ckpt:.1f} s, phase 4's index copied in {t_index:.1f} s, service "
          f"{t_service:.1f} s, "
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
    from capreolus_tpu_torch.ops.maxsim_epilogue import maxsim_epilogue
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
    launches = {"int8_matmul": int8_matmul.launches, "flash_attention": flash_attention.launches,
                "maxsim_epilogue": maxsim_epilogue.launches}
    int32_launches = int8_matmul.mode_launches["int32"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = len(queries) * colbert_x1_launches(1, n_docs) + colbert_x1_launches(len(none["batch"]), n_docs)
    print(f"{label} per request (median of {len(queries)}): {np.median(request_ms):.2f} ms (spread "
          f"{min(request_ms):.2f}-{max(request_ms):.2f}); one {len(none['batch'])}-query batch {batch_ms:.2f} ms; "
          f"peak device memory of the served run {peak_gb:.2f} GB; launches in the run: int8_matmul "
          f"{launches['int8_matmul']} (one per chunk of docs), maxsim_epilogue {launches['maxsim_epilogue']}, "
          f"flash_attention {launches['flash_attention']}")
    check(launches["int8_matmul"] == want, f"int8_matmul launched {launches['int8_matmul']} times, expected {want}")
    check(int32_launches == want, f"only {int32_launches} of the ColBERT int8 X1 launches ran the int32 epilogue")
    check(launches["maxsim_epilogue"] == want, f"maxsim_epilogue launched {launches['maxsim_epilogue']} times, "
                                               f"expected one per X1 launch ({want})")
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
    launches["maxsim_epilogue_int4"] = maxsim_epilogue.launches
    check(launches["int8_matmul_int4"] == colbert_x1_launches(1, n_docs) == int8_matmul.mode_launches["int32"]
          == launches["maxsim_epilogue_int4"],
          f"int4: int8_matmul launched {launches['int8_matmul_int4']} times for one query "
          f"({int8_matmul.mode_launches['int32']} in the int32 epilogue), maxsim_epilogue "
          f"{launches['maxsim_epilogue_int4']}")
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


def rank_search(config, device, results_base, benchmark=None):
    """The port's rank task over ``benchmark`` (a benchmark config; the golden
    one by default) on ``device``: (task, search seconds, cross-validated
    metrics, {run-file name: run})."""
    import io

    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.task import Task
    from capreolus_tpu_torch.utils.trec import load_trec_run

    constants["RESULTS_BASE_PATH"] = results_base
    task = Task.create("rank", {"benchmark": benchmark or {"name": "e2e_golden"}, "searcher": config})
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
    from capreolus_tpu_torch.searcher.tpu import _load_topics_tsv, fetch

    searcher.device = device
    engine = searcher.get_engine()
    terms = [searcher.query_weights(text, engine) for _, text in _load_topics_tsv(topic_fn)]
    fixed, grid = searcher.grid_params()
    g = int(np.prod([len(v) for v in grid.values()]))
    hits = min(int(searcher.config["hits"]), engine.dindex.num_docs)
    scores, ords = np.zeros((g, len(terms), hits), np.float32), np.zeros((g, len(terms), hits), np.int32)
    for q0, g0, res in searcher._engine_calls(engine, terms, searcher.model, fixed, grid, hits):
        sc, od = fetch(res)
        scores[g0:g0 + sc.shape[0], q0:q0 + sc.shape[1]] = sc
        ords[g0:g0 + od.shape[0], q0:q0 + od.shape[1]] = od
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


def rank_golden_setup(workdir):
    """Phase 8's card-free set-up: the golden corpus written under
    ``workdir/golden``, registered, and both its indexes (plain, with
    positions) built under ``workdir/cache_rank``. Returns what phase 8 reads:
    the files, topics and qrels, and the seconds of each step."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index

    t0 = time.perf_counter()
    docs, topics, qrels = golden_corpus()
    corpus_dir, qrel_fn, topic_fn = write_golden(docs, topics, qrels, os.path.join(workdir, "golden"))
    register_golden(corpus_dir, qrel_fn, topic_fn, sorted(topics))
    out = {"files": (corpus_dir, qrel_fn, topic_fn), "docs": len(docs), "topics": topics, "qrels": qrels,
           "corpus_s": time.perf_counter() - t0, "builds": {}}
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rank")
    for positions in (False, True):
        index = Index.create("tpu", {"storepositions": positions, "collection": {"name": "e2e_golden"}})
        t0 = time.perf_counter()
        index.create_index()
        out["builds"]["positions" if positions else "plain"] = round(time.perf_counter() - t0, 2)
    return out


SETUP_WAIT_S = 600  # how long phase 4 or 8 waits for its set-up process


def prebuild_setup(workdir):
    """The card-free set-up of phases 8 and 10 (``rank_golden_setup``,
    ``sparse_corpora``), run in a process of its own beside phases 5-7
    (``start_host_side``): what phase 8 reads, and each corpus's seconds."""
    return {"rank": rank_golden_setup(workdir),
            "sparse_s": {name: secs for name, (_, secs) in sparse_corpora().items()}}


def phase_setup_wait(host, label):
    """What a set-up process (``start_host_side``) wrote, once it has ended."""
    built, waited = wait_host_side(host, SETUP_WAIT_S, label)
    print(f"{label} its set-up process ({host[0].name}) ended; waited {waited:.1f} s for it")
    return built


def _host_main(side, out_fn, *args):
    """``side(*args)``, its result pickled to ``out_fn`` through a temporary
    file, so that a reader finds it whole or not at all."""
    import pickle

    try:
        result = side(*args)
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    with open(out_fn + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(out_fn + ".tmp", out_fn)


def start_host_side(workdir, side, *args):
    """Start ``side(workdir, *args)``, card-free work of a later phase, in a
    spawned process that pickles its result. Returns (process, out_fn)."""
    import multiprocessing

    out_fn = os.path.join(workdir, f"{side.__name__}.pkl")
    proc = multiprocessing.get_context("spawn").Process(target=_host_main, args=(side, out_fn, workdir, *args),
                                                         name=side.__name__)
    proc.start()
    return proc, out_fn


def wait_host_side(host, timeout, label):
    """What a ``start_host_side`` process wrote, once it has ended, and the
    seconds waited for it."""
    import pickle

    proc, out_fn = host
    t0 = time.perf_counter()
    proc.join(timeout=timeout)
    waited = time.perf_counter() - t0
    check(not proc.is_alive(), f"{label} the host side did not end within {timeout} s")
    check(proc.exitcode == 0 and os.path.exists(out_fn), f"{label} the host side failed (exit code {proc.exitcode})")
    with open(out_fn, "rb") as fh:
        return pickle.load(fh), waited


def phase_rank_task(workdir, setup):
    """The rank task on the card over the JAX suite's 50k-doc golden corpus,
    made and indexed by ``setup`` (``rank_golden_setup``'s result, here or in
    the set-up process): the index builds' seconds, the six searchers against
    PARITY.md's pins and against the CPU, BM25Grid's split and memory, a
    repeated BM25 search, the CLI, and one profiled BM25 search."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.evaluation import DEFAULT_METRICS
    from capreolus_tpu_torch.searcher.tpu import ACC_BUDGET_ELEMENTS

    label = "[8 rank task]"
    register_golden(*setup["files"], sorted(setup["topics"]))  # into this process's registry
    corpus_dir, qrel_fn, topic_fn = setup["files"]
    topics, qrels, builds = setup["topics"], setup["qrels"], setup["builds"]
    print(f"{label} golden corpus: {setup['docs']} docs, {len(topics)} topics, "
          f"{sum(len(q) for q in qrels.values())} judgements; made in {setup['corpus_s']:.1f} s before this phase")
    print(f"{label} index build seconds: plain {builds['plain']}, with positions {builds['positions']} (before "
          f"this phase)")
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rank")

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
TRAIN_THRESHOLD = 50  # threshold = testthreshold of the full-width training runs: the depth of their predictions
STEP_RTOL = 1e-4  # step 1's loss, and each gradient tensor against its largest entry, card vs CPU from
# one init and one batch: f32 sums in other orders (K1's pooled features sit within 2e-4 of the
# plain path's on log sums of up to ~10, so a frozen KNRM's combine gradients move by ~2e-5)
REFEREE_FACTOR = 4  # a card gradient against the CPU's may differ by this many times the CPU f32 gradient's
# own error against f64 (two f32 sums in other orders, each about that far from the exact one)
GRAD_NOISE_FLOOR = 1e-3  # share of the model's largest gradient entry below which a tensor's own
# largest entry is not its scale (a gradient that is 0 but for rounding)
SERVED_DEV_BEST_TOL = 1e-5  # a dev.best served on the card against the trainer's own test prediction of
# the same docs in one batch of the same size (the same kernels on the same inputs)
TRAINER_FULL = {"batch": 32, "itersize": 256, "niters": 1, "validatefreq": 1, "evalbatch": TRAIN_THRESHOLD}
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


def hold_k2(reranker, batch, label, held=None, prefix="[9 K2]"):
    """K2 against ``attention_plain`` at every attention of one prediction
    forward of a BERT reranker on ``batch``: each attention's q, k, v and mask
    as it hands them to K2, taken by a pre-hook (``k2_error``). Returns the
    largest error at each sequence length, {"L256": ..., "L17": ...}; the
    largest of all goes into ``held``. These launches come after the path's
    counts are read."""
    from capreolus_tpu_torch.reranker.bert.encoder import BertSelfAttention

    errs, shapes, calls = {}, set(), []

    def hold(module, args):
        hidden, mask = args[0], args[1]
        q, k, v = module.heads(hidden)
        key = f"L{q.shape[2]}"
        errs[key] = max(errs.get(key, 0.0), k2_error(q, k, v, mask)[0])
        shapes.add("B={} H={} L={} D={}".format(*q.shape))
        calls.append(key)

    hooks = [m.register_forward_pre_hook(hold) for m in reranker.model.modules() if isinstance(m, BertSelfAttention)]
    try:
        with torch.no_grad():
            reranker.test(batch, next(reranker.model.parameters()).device)
    finally:
        for h in hooks:
            h.remove()
    check(len(calls) == len(hooks) > 0, f"K2 on {label}: {len(calls)} attentions held of {len(hooks)}")
    print(f"{prefix} {label}: {len(calls)} attentions at {', '.join(sorted(shapes))}: max |kernel - plain| "
          f"{errs} over the first 128 sequences (tolerance {K2_TOL[torch.float32]})")
    if held is not None:
        held["flash_attention"] = max(held.get("flash_attention", 0.0), max(errs.values()))
    return errs


def step_parity(task, batch, label, exclude=None, prefix="[9a parity]", amp=False, grad_rtol=STEP_RTOL,
                loss_rtol=STEP_RTOL, dropout=True, per_use=False, referee64=False):
    """Step 1 from one init (``init_params`` on the CPU) and one batch: the
    loss and every gradient on the card against the CPU's, with the card's
    kernel launches in that step. ``exclude`` ({parameter: [indices]}) leaves
    ill-conditioned gradient entries out. ``amp`` runs the step on the weights
    rounded to bf16, as ``trainer.amp`` does. ``dropout=False`` runs the
    deterministic training forward (no dropout seed: the card's and the CPU's
    generators draw different masks). ``per_use`` (always under ``amp``)
    scales each tensor's errors by the largest entries of its two uses'
    gradients (pos, neg) summed, not its own largest entry. ``referee64``
    also computes the step in f64 on the CPU and lets a tensor's card error
    reach ``REFEREE_FACTOR`` times the CPU f32 gradient's own error against
    it, where that is larger: a gradient that f32 itself cannot compute to
    ``grad_rtol`` (CDSSM's at its init, where both towers' cosine is ±1 to
    1e-4) is held to f32's own accuracy."""
    from capreolus_tpu_torch.reranker.common import cudnn_f32
    from capreolus_tpu_torch.trainer.amp import bf16_params

    reranker, trainer = task.reranker, task.reranker.trainer
    model = reranker.init_params(trainer.config["seed"])
    trainer.make_optimizer(reranker, model)  # freezes what the trainer freezes
    micro = {k: v[0] for k, v in batch.items()}
    seed = trainer.step_seed(0, 0) if dropout else None

    def grads(device):
        model.to(device)
        model.zero_grad(set_to_none=True)
        before = launch_counts()
        # the forward and the backward under cudnn_f32, as train_step runs them: cuDNN's backward reads the
        # TF32 flag when it runs, not when the forward did
        with bf16_params(model, amp), cudnn_f32():
            loss = trainer.compute_loss(reranker, micro, torch.device(device), dropout_seed=seed)
            loss.backward()
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        return float(loss.detach()), {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                             if p.grad is not None}, launched

    def use_scales():
        """Per tensor, on the CPU, the largest gradient entry of the positive
        forward plus the negative's: under amp each use's gradient is rounded
        to bf16 before the pairwise loss subtracts one from the other, so two
        devices a rounding apart differ by a bf16 step of each use, which can
        be many times the difference itself."""
        model.to("cpu")
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        with bf16_params(model, amp):
            pos, neg = reranker.score(micro, torch.device("cpu"), dropout_seed=seed)
            uses = [torch.autograd.grad(side.float().mean(), list(named.values()), retain_graph=True, allow_unused=True)
                    for side in (pos, neg)]
        return {n: sum(float(g[i].abs().max()) for g in uses if g[i] is not None) for i, n in enumerate(named)}

    def f32_errors():
        """Per tensor, the CPU f32 gradient's largest error against the same step in f64."""
        model.to("cpu").double()
        model.zero_grad(set_to_none=True)
        wide = {k: (np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v) for k, v in micro.items()}
        trainer.compute_loss(reranker, wide, torch.device("cpu"), dropout_seed=seed).backward()
        out = {n: float((p.grad - cpu_grads[n].double()).abs().max()) for n, p in model.named_parameters()
               if p.grad is not None}
        model.float()
        return out

    cpu_loss, cpu_grads, _ = grads("cpu")
    scales = use_scales() if amp or per_use else {n: float(g.abs().max()) for n, g in cpu_grads.items()}
    f32_err = f32_errors() if referee64 else {}
    card_loss, card_grads, launched = grads("cuda")
    check(set(card_grads) == set(cpu_grads), f"{label}: the card computes gradients for other parameters")
    loss_err = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-12)
    # a tensor's errors against its largest entry (under amp, its uses'), or against GRAD_NOISE_FLOOR of
    # the model's largest entry where that is larger: the attention key bias's gradient is 0 but for
    # rounding (softmax is invariant to it), so its own largest entry is noise
    floor = GRAD_NOISE_FLOOR * max(scales.values())
    grad_err, worst = 0.0, None
    for name, g in cpu_grads.items():
        diff = (card_grads[name] - g).abs()
        for index in (exclude or {}).get(name, []):
            diff[index] = 0.0
        err = float(diff.max()) / max(scales[name], floor, 1e-30)
        if name in f32_err:  # held to f32's own accuracy where that is coarser than grad_rtol
            err = min(err, grad_rtol * float(diff.max()) / max(REFEREE_FACTOR * f32_err[name], 1e-30))
        if err >= grad_err:
            grad_err, worst = err, name
    print(f"{prefix} {label}: step-1 loss {card_loss:.6f} on the card, {cpu_loss:.6f} on the CPU (rel err "
          f"{loss_err:.3g}); largest gradient error {grad_err:.3g} of its tensor's largest entry"
          f"{' (its two uses summed)' if amp or per_use else ''}"
          f"{f', or {REFEREE_FACTOR} x the CPU f32 error against f64' if referee64 else ''} ({worst}) over "
          f"{len(cpu_grads)} tensors (tolerance {grad_rtol}; the loss {loss_rtol}); card launches in the step: "
          f"{ {k: n for k, n in launched.items() if n} }")
    check(loss_err <= loss_rtol and grad_err <= grad_rtol, f"{label}: step 1 on the card differs from the CPU's")
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
            out[name]["k2_max_abs_err"] = max(hold_k2(task.reranker, stages["first_predict_batch"],
                                                      "tiny BERT-MaxP's first prediction batch", held).values())
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
              f"predictions: K1 {k1_pred}, K2 {k2_pred}; test MAP {test_map:.4f} (random init, {c['niters']} iteration(s))")

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
            k_err = max(hold_k2(reranker, stages["first_predict_batch"], "monoBERT-MaxP's first prediction batch",
                                held).values())

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


# ---------------------------------------------------------------- phase 10: the sparse engine at scale
SPARSE = {  # bench.py's headline shape: corpus, query recipe, batches and depth
    "num_docs": 200_000, "num_terms": 50_000, "avg_unique": 120, "queries": 2048, "terms": 4, "batch": 256,
    "topk": 1000, "uniform_seed": 0, "clustered_seed": 2, "query_seed": 1,
}
SPARSE_PARAMS = {"k1": 0.9, "b": 0.4}  # Anserini's BM25 defaults, as bench.py
SPARSE_CAP = 100  # the maxpostings mode's cap
TIERED_RTOL = 1e-5  # tiered vs exact scores: a tree sum against a sequential sum (tests/test_compact_topk.py)
SPARSE_CPU_QUERIES = 32  # queries of each corpus scored on the card and on the CPU
SPARSE_PASSES = 2  # timed pipelined passes per mode (qps: best and median)
SPAN_STATS_TOL = 0.05  # native vs numpy spans: kept tiles within this share of the total (tests/test_block_max.py)
# ms per batch measured by this phase with the numpy span builder, before the native one
# (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's rows
NUMPY_SPANS_MS = {"uniform": {"pruned_adaptive": 7.327, "pruned_forced": 9.156, "tiered_k10": 5.303,
                             "pruned_forced_k10": 6.613},
                 "clustered": {"pruned_adaptive": 9.424, "pruned_forced": 10.767, "tiered_k10": 8.25,
                               "pruned_forced_k10": 303.03}}
CROSSOVER_DOCS = (25_000, 50_000, 100_000, 200_000)  # prefixes of the uniform corpus
CROSSOVER_REPS = 3


def sparse_queries(data, seed, n, terms, num_docs):
    """bench.py's ``_make_queries``: ``terms`` distinct terms of 50 < df < N/10."""
    rng = np.random.Generator(np.random.PCG64(seed))
    df = data.df_array
    cand = np.where((df > 50) & (df < num_docs // 10))[0]
    return [[(int(t), 1.0) for t in rng.choice(cand, size=terms, replace=False)] for _ in range(n)]


def doc_prefix(data, num_docs):
    """The corpus restricted to its first ``num_docs`` ordinals: postings stay in
    canonical order (the range size is 64 below 262,144 docs), doc lengths are
    those docs' own; no prune tables."""
    from capreolus_tpu_torch.index.tpu import IndexData, pick_range_size

    if pick_range_size(num_docs) != int(data.prune_tables["range_size"]):
        raise SmokeFailure(f"a {num_docs}-doc prefix changes the range size; it is not in canonical order")
    keep = np.asarray(data.doc_ids) < num_docs
    term_of = np.repeat(np.arange(data.num_terms), np.diff(data.term_offsets))[keep]
    offsets = np.zeros(data.num_terms + 1, np.int64)
    np.cumsum(np.bincount(term_of, minlength=data.num_terms), out=offsets[1:])
    return IndexData(term_offsets=offsets, doc_ids=np.asarray(data.doc_ids)[keep], tfs=np.asarray(data.tfs)[keep],
                     doclens=data.doclens[:num_docs], norm_doclens=data.norm_doclens[:num_docs],
                     docid_strings=None, vocab=None)


def ranking_rows_faults(a, b, rtol, limit=5):
    """Where two engine results (scores, ords) [Q, k] part beyond near-ties, as
    messages: per row the same number of matching docs (score > 0), each doc
    in both rows within ``rtol`` of the row's top score of itself, and the
    same doc at each rank but where two docs tie within that (``ranking_faults``)."""
    faults = []
    for q in range(a[0].shape[0]):
        va, vb = a[0][q] > 0, b[0][q] > 0
        if va.sum() != vb.sum():
            faults.append(f"query {q}: {va.sum()} vs {vb.sum()} matching docs")
            continue
        hits_a = list(zip(a[1][q][va].tolist(), a[0][q][va].tolist()))
        hits_b = list(zip(b[1][q][vb].tolist(), b[0][q][vb].tolist()))
        tol = rtol * max([abs(s) for _, s in hits_a[:1]] + [0.0])
        bad = [f"rank {r}: {sa} vs {sb}" for r, ((_, sa), (_, sb)) in enumerate(zip(hits_a, hits_b))
               if abs(sa - sb) > tol] + ranking_faults(hits_a, hits_b, tol)
        faults += [f"query {q}: {m}" for m in bad[:2]]
        if len(faults) >= limit:
            break
    return faults


def concat_results(results):
    return np.concatenate([s for s, _ in results]), np.concatenate([o for _, o in results])


def sparse_mode_run(run, passes=SPARSE_PASSES):
    """One mode's pipelined passes over the batches (``run()`` returns the lazy
    per-batch results): a warm-up pass whose fetched results are returned, then
    ``passes`` timed ones, each timed from the first dispatch to the last fetch."""
    from capreolus_tpu_torch.searcher.tpu import fetch

    results = [tuple(x[0] for x in fetch(r)) for r in run()]  # ([Q, k] scores, ords) per batch
    torch.cuda.synchronize()
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for r in run():
            fetch(r)
        walls.append(time.perf_counter() - t0)
    return results, walls


@contextlib.contextmanager
def native_switch(value):
    """CAPREOLUS_NATIVE set to ``value`` ("1" or "0") inside the block, restored after."""
    saved = os.environ.get("CAPREOLUS_NATIVE")
    os.environ["CAPREOLUS_NATIVE"] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CAPREOLUS_NATIVE"]
        else:
            os.environ["CAPREOLUS_NATIVE"] = saved


def span_build_times(engine, batches, topk):
    """The span build alone for each batch, native against numpy (host ms per
    batch, the median; the numpy path with the library switched off), and each
    batch's statistics: total lanes and tiles equal, kept tiles within
    SPAN_STATS_TOL of the total. Returns the row and the faults."""
    ms, stats = {"native": [], "numpy": []}, {"native": [], "numpy": []}
    for how, env in (("native", "1"), ("numpy", "0")):
        with native_switch(env):
            for b in batches:
                t0 = time.perf_counter()
                engine._build_prune_spans(b, "bm25", SPARSE_PARAMS, topk)
                ms[how].append((time.perf_counter() - t0) * 1e3)
                stats[how].append(dict(engine.last_prune_stats))
    faults = [f"batch {i}: native {a} vs numpy {b}" for i, (a, b) in enumerate(zip(stats["native"], stats["numpy"]))
              if a["total_lanes"] != b["total_lanes"] or a["total_tiles"] != b["total_tiles"]
              or abs(a["kept_tiles"] - b["kept_tiles"]) > SPAN_STATS_TOL * b["total_tiles"]]
    row = {f"{how}_ms_per_batch_median": round(float(np.median(v)), 3) for how, v in ms.items()}
    for how in ms:
        row[f"{how}_kept_tile_share"] = round(sum(x["kept_tiles"] for x in stats[how])
                                              / max(1, sum(x["total_tiles"] for x in stats[how])), 4)
    return row, faults


def sparse_corpus_phase(label, data, batches, shape, cpu_terms, corpus=None):
    """Every mode over one corpus on the card: numbers, results and checks."""
    from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine
    from capreolus_tpu_torch.searcher.tpu import DISPATCH_WINDOW, _windowed, fetch

    topk = shape["topk"]
    kw = dict(model="bm25", params=SPARSE_PARAMS, topk=topk, materialize=False, score_dtype="bfloat16",
              pack_ords=True)  # bench.py's transfer settings
    kw10 = {**kw, "topk": 10}

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = ScoringEngine(DeviceIndex(data, "cuda"))
    torch.cuda.synchronize()
    index_bytes = torch.cuda.memory_allocated() - before
    stream_engine = ScoringEngine(DeviceIndex(data, "cuda", hbm_budget=engine.dindex.tile_bytes / 4))
    check(stream_engine.dindex.streaming, f"{label} a budget of a quarter of the tiles did not stream")
    modes = {
        "exact": lambda: _windowed(engine.search(b, model="bm25", params=SPARSE_PARAMS, topk=topk, exact_topk=True,
                                                 materialize=False) for b in batches),
        "tiered": lambda: engine.search_stream(batches, window=DISPATCH_WINDOW, **kw),
        # without bench.py's transfer settings: f32 scores, int32 ordinals
        "tiered_f32": lambda: engine.search_stream(batches, window=DISPATCH_WINDOW, model="bm25",
                                                   params=SPARSE_PARAMS, topk=topk, materialize=False),
        "pruned_adaptive": lambda: engine.search_pruned_stream(batches, window=DISPATCH_WINDOW, **kw),
        "pruned_forced": lambda: engine.search_pruned_stream(batches, window=DISPATCH_WINDOW, adaptive=False, **kw),
        f"maxpostings_{SPARSE_CAP}": lambda: _windowed(
            engine.search(b, max_postings_per_term=SPARSE_CAP, **kw) for b in batches),
        "streaming": lambda: stream_engine.search_stream(batches, window=DISPATCH_WINDOW, **kw),
        "streaming_pruned": lambda: stream_engine.search_pruned_stream(batches, window=DISPATCH_WINDOW,
                                                                       adaptive=False, **kw),
        # k = 10, the depth where block-max thresholds are high enough to drop tiles
        "tiered_k10": lambda: engine.search_stream(batches, window=DISPATCH_WINDOW, **kw10),
        "pruned_forced_k10": lambda: engine.search_pruned_stream(batches, window=DISPATCH_WINDOW, adaptive=False,
                                                                 **kw10),
        "pruned_adaptive_k10": lambda: engine.search_pruned_stream(batches, window=DISPATCH_WINDOW, **kw10),
    }
    one_batch = {
        "exact": lambda: fetch(engine.search(batches[0], model="bm25", params=SPARSE_PARAMS, topk=topk,
                                             exact_topk=True, materialize=False)),
        "tiered": lambda: [fetch(r) for r in engine.search_stream(batches[:1], **kw)],
        "pruned_forced": lambda: [fetch(r) for r in engine.search_pruned_stream(batches[:1], adaptive=False, **kw)],
        f"maxpostings_{SPARSE_CAP}": lambda: fetch(engine.search(batches[0], max_postings_per_term=SPARSE_CAP, **kw)),
        "streaming": lambda: [fetch(r) for r in stream_engine.search_stream(batches[:1], **kw)],
    }
    out, results = {"index_gb": round(index_bytes / 1e9, 3), "tile_bytes": engine.dindex.tile_bytes}, {}
    for mode, run in modes.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        results[mode], walls = sparse_mode_run(run)
        torch.cuda.synchronize()
        per_batch = [w * 1e3 / len(batches) for w in walls]
        r = {"qps_best": round(shape["queries"] / min(walls), 1),
             "qps_median": round(shape["queries"] / float(np.median(walls)), 1),
             "ms_per_batch_median": round(float(np.median(per_batch)), 3),
             "ms_per_batch_min_max": [round(min(per_batch), 3), round(max(per_batch), 3)],
             "peak_gb_over_index": round((torch.cuda.max_memory_allocated() - base) / 1e9, 3)}
        e = stream_engine if mode.startswith("streaming") else engine
        if "pruned" in mode:
            r["prune_stats"] = dict(e.last_prune_stats or {})
            r["kept_tile_share"] = round(r["prune_stats"].get("kept_tiles", 0)
                                         / max(1, r["prune_stats"].get("total_tiles", 0)), 4)
        if mode.startswith("pruned_adaptive"):
            key = (10 if mode.endswith("_k10") else topk, SPARSE_PARAMS["k1"], SPARSE_PARAMS["b"])
            r["tiles_verdict"] = e._prune_tiles_ok.get(key)
            r["stream_verdict"] = e._prune_stream_effective.get(key)
        if mode.startswith("streaming"):
            r["stream_stats"] = dict(e.last_stream_stats or {})
        if mode in one_batch:
            prof = profile_call(one_batch[mode], f"{label} {mode}", top=6, what=f"batch of {shape['batch']} queries")
            r["profiled_batch"] = {"wall_ms": round(prof["wall_ms"], 3), "busy_ms": round(prof["busy_ms"], 3),
                                   "busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4),
                                   "top_ops": prof["top_ops"]}
        out[mode] = r
        print(f"{label} {mode}: {r['qps_best']} queries/s best of {SPARSE_PASSES} (median {r['qps_median']}), "
              f"{r['ms_per_batch_median']} ms per batch of {shape['batch']} (min-max {r['ms_per_batch_min_max']}), "
              f"peak {r['peak_gb_over_index']} GB over the index"
              + (f", kept {r['kept_tile_share']:.1%} of tiles {r['prune_stats']}" if "pruned" in mode else "")
              + (f", verdict tiles {r['tiles_verdict']} stream {r['stream_verdict']}"
                 if mode.startswith("pruned_adaptive") else "")
              + (f", uploaded {r['stream_stats']}" if mode.startswith("streaming") else "")
              + (f"; with numpy spans earlier {NUMPY_SPANS_MS[corpus][mode]} ms per batch"
                 if mode in NUMPY_SPANS_MS.get(corpus, {}) else ""))

    # the span build alone per batch, native against numpy, at k = 10 and k = topk
    out["span_build"] = {}
    for k in (10, topk):
        row, faults = span_build_times(engine, batches, k)
        check(not faults, f"{label} native and numpy span statistics part at k={k}: {faults[:3]}")
        out["span_build"][f"k{k}"] = row
        print(f"{label} span build alone at k={k}, host ms per batch of {shape['batch']} (median of "
              f"{len(batches)}): native {row['native_ms_per_batch_median']}, numpy {row['numpy_ms_per_batch_median']}; "
              f"kept tiles native {row['native_kept_tile_share']:.1%}, numpy {row['numpy_kept_tile_share']:.1%} "
              f"(totals equal, kept within {SPAN_STATS_TOL:.0%} of tiles in every batch)")

    # checks: tiered f32 against exact; the bench settings' packed ordinals and
    # bf16 scores against it; pruned and streamed bit-identical to tiered
    tiered_f32 = concat_results(results["tiered_f32"])
    exact = concat_results(results["exact"])
    faults = ranking_rows_faults(tiered_f32, exact, TIERED_RTOL)
    check(not faults, f"{label} tiered vs exact on the card: {faults}")
    tiered = concat_results(results["tiered"])
    check(np.array_equal(tiered[1], tiered_f32[1]), f"{label} packed ordinals do not round-trip")
    widened = torch.from_numpy(tiered_f32[0]).to(torch.bfloat16).float().numpy()
    check(np.array_equal(tiered[0], widened), f"{label} bf16 scores are not the f32 scores rounded")
    for mode, ref in (("pruned_adaptive", "tiered"), ("pruned_forced", "tiered"), ("streaming", "tiered"),
                      ("streaming_pruned", "tiered"), ("pruned_forced_k10", "tiered_k10"),
                      ("pruned_adaptive_k10", "tiered_k10")):
        got, want = concat_results(results[mode]), concat_results(results[ref])
        check(np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32)) and np.array_equal(got[1], want[1]),
              f"{label} {mode} is not bit-identical to the resident exhaustive tiered path ({ref})")
    capped = concat_results(results[f"maxpostings_{SPARSE_CAP}"])
    # partial sums: a row's best capped score is at most its best exhaustive one (both rounded to bf16)
    check(bool((capped[0].max(axis=1) <= tiered[0].max(axis=1)).all()), f"{label} capped scores exceed the exhaustive ones")
    out["tiered_vs_exact_max_rel"] = float(np.max(
        np.abs(tiered_f32[0] - exact[0])[tiered_f32[0] > 0] / np.abs(exact[0][tiered_f32[0] > 0]), initial=0.0))

    # the card against the CPU on the first queries: ordinals identical but
    # for near-ties, scores within SPARSE_RTOL of the row's top score
    cpu = ScoringEngine(DeviceIndex(data, "cpu"))
    for name, fn in (("tiered", lambda e: e.search(cpu_terms, params=SPARSE_PARAMS, topk=topk, exact_topk=False)),
                     (f"maxpostings_{SPARSE_CAP}", lambda e: e.search(cpu_terms, params=SPARSE_PARAMS, topk=topk,
                                                                     max_postings_per_term=SPARSE_CAP))):
        card_rows, cpu_rows = fn(engine), fn(cpu)
        faults = ranking_rows_faults(card_rows, cpu_rows, SPARSE_RTOL)
        check(not faults, f"{label} {name} card vs CPU on {len(cpu_terms)} queries: {faults}")
        out[f"card_vs_cpu_{name}"] = {
            "ords_identical_share": round(float((card_rows[1] == cpu_rows[1]).mean()), 6),
            "max_rel": float(np.max(np.abs(card_rows[0] - cpu_rows[0])[cpu_rows[0] > 0]
                                    / cpu_rows[0][cpu_rows[0] > 0], initial=0.0))}
    print(f"{label} checks: tiered vs exact equal doc sets, max rel {out['tiered_vs_exact_max_rel']:.2e} "
          f"(tolerance {TIERED_RTOL}); packed ordinals and bf16 scores round-trip; pruned (adaptive, forced; "
          f"both at k=10, native spans) and streamed (exhaustive, pruned) bit-identical to tiered; card vs CPU on {len(cpu_terms)} queries "
          f"{out['card_vs_cpu_tiered']} (tiered), {out[f'card_vs_cpu_maxpostings_{SPARSE_CAP}']} (capped)")
    del engine, stream_engine, cpu, results
    torch.cuda.empty_cache()
    return out


def sparse_crossover(label, data, shape):
    """Exact against tiered on doc-prefixes of the uniform corpus, each over
    the full traffic in f32: ms per batch in a pipelined pass (the best of
    SPARSE_PASSES; how the rank task dispatches) and of one batch alone
    (dispatch to fetch, the median of CROSSOVER_REPS; how a service does):
    where the card's crossover lies against the engine's EXACT_MAX_DOCS rule."""
    from capreolus_tpu_torch.searcher.scoring import EXACT_MAX_DOCS, DeviceIndex, ScoringEngine
    from capreolus_tpu_torch.searcher.tpu import DISPATCH_WINDOW, _windowed, fetch

    rows = {}
    for n in CROSSOVER_DOCS:
        sub = doc_prefix(data, n) if n < data.num_docs else data
        engine = ScoringEngine(DeviceIndex(sub, "cuda"))
        queries = sparse_queries(sub, SPARSE["query_seed"], shape["queries"], shape["terms"], n)
        batches = [queries[i:i + shape["batch"]] for i in range(0, len(queries), shape["batch"])]
        kw = dict(params=SPARSE_PARAMS, topk=shape["topk"], materialize=False)

        runs = {"exact": lambda: _windowed(engine.search(b, exact_topk=True, **kw) for b in batches),
                "tiered": lambda: engine.search_stream(batches, window=DISPATCH_WINDOW, **kw)}
        row = {}
        for mode, run in runs.items():
            _, walls = sparse_mode_run(run)
            row[f"{mode}_pipelined"] = round(min(walls) * 1e3 / len(batches), 3)
            reps = []
            for _ in range(CROSSOVER_REPS):
                t0 = time.perf_counter()
                fetch(engine.search(batches[0], exact_topk=mode == "exact", **kw))
                reps.append((time.perf_counter() - t0) * 1e3)
            row[f"{mode}_one_batch"] = round(float(np.median(reps)), 3)
        rows[n] = row
        del engine
        torch.cuda.empty_cache()
    crossover = {}  # the smallest size from which tiered is faster at every larger size
    for how in ("pipelined", "one_batch"):
        crossover[how] = None
        for n in sorted(CROSSOVER_DOCS, reverse=True):
            if rows[n][f"tiered_{how}"] >= rows[n][f"exact_{how}"]:
                break
            crossover[how] = n
    print(f"{label} exact vs tiered ms per batch of {shape['batch']} by corpus size: {rows}; tiered faster from "
          f"{crossover} docs on (the engine switches above {EXACT_MAX_DOCS})")
    return {"ms_by_docs": rows, "tiered_faster_from_docs": crossover, "engine_rule_max_exact_docs": EXACT_MAX_DOCS}


def sparse_corpora(shape=SPARSE, cache_dir=None):
    """Phase 10's two synthetic corpora, each built once into its cache file
    under ``cache_dir`` (the gitignored ``build/sparse`` by default) and read
    from it after: {name: (IndexData, seconds)}."""
    from capreolus_tpu_torch.index.synth import synth_clustered_index, synth_uniform_index

    cache_dir = cache_dir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sparse")
    os.makedirs(cache_dir, exist_ok=True)
    n, v, u = shape["num_docs"], shape["num_terms"], shape["avg_unique"]
    out = {}
    for name, build, seed in (("uniform", synth_uniform_index, shape["uniform_seed"]),
                              ("clustered", synth_clustered_index, shape["clustered_seed"])):
        t0 = time.perf_counter()
        data = build(n, v, u, seed=seed, cache_fn=os.path.join(cache_dir, f"{name}_{n}_{v}_{seed}.npz"))
        out[name] = (data, time.perf_counter() - t0)
    return out


def phase_sparse_engine(workdir, built_s, shape=SPARSE, cache_dir=None):
    """The sparse engine at bench.py's 200k-doc shape on the card: a uniform
    corpus (no doc-id locality) and a clustered one, bench.py's traffic, every
    mode timed and profiled and held against the others and the CPU, the
    exact/tiered crossover, and no port kernel launched. ``sparse_corpora``
    built the corpora into their cache files before this phase, in
    ``built_s[name]`` seconds; they are read from there."""
    label = "[10 sparse engine]"
    n = shape["num_docs"]
    reset_launch_counts()
    summary = {"shape": shape}
    for name, (data, read_s) in sparse_corpora(shape, cache_dir).items():
        queries = sparse_queries(data, shape["query_seed"], shape["queries"], shape["terms"], n)
        batches = [queries[i:i + shape["batch"]] for i in range(0, len(queries), shape["batch"])]
        built = built_s[name]
        print(f"{label} {name} corpus: {data.num_docs} docs, {len(data.doc_ids)} postings, built in {built:.1f} s "
              f"before this phase, read here in {read_s:.1f} s; "
              f"{len(queries)} queries of {shape['terms']} terms in {len(batches)} batches, k={shape['topk']}")
        summary[name] = sparse_corpus_phase(f"{label} {name}", data, batches, shape,
                                            queries[:SPARSE_CPU_QUERIES], corpus=name)
        summary[name]["build_s"] = round(built, 1)
        if name == "uniform":
            summary["crossover"] = sparse_crossover(label, data, shape)
    launched = {k: c for k, c in launch_counts().items() if c}
    check(not launched, f"{label} the sparse path launched a port kernel: {launched}")
    print(f"{label} summary {json.dumps(summary, default=str)}")
    return summary


# ---------------------------------------------------------------- native helpers
def phase_native():
    """The port's native C++ host helpers: every library must load on the card's
    machine (no silent fallback to the numpy and Python paths)."""
    from capreolus_tpu_torch.native import native_status

    label = "[2b native]"
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    t0 = time.perf_counter()
    status = native_status()
    secs = time.perf_counter() - t0
    missing = {name: st["reason"] for name, st in status.items() if not st["loaded"]}
    check(not missing, f"{label} native libraries did not load: {missing}")
    print(f"{label} {(gxx.stdout or gxx.stderr).splitlines()[0].strip()}; "
          + ", ".join(f"{name} loaded (built in {st['build_s']:.2f} s)" if st["build_s"] is not None
                      else f"{name} loaded (already built)" for name, st in status.items())
          + f"; {secs:.2f} s in all")
    return {name: st["build_s"] for name, st in status.items()}


# ---------------------------------------------------------------- phase 11: a Robust04-shaped experiment
ROBUST04_SHAPED = {  # Robust04's topics and folds over a seeded corpus in its TREC layout
    # cut from Robust04's 528,155 docs to 66,000, just above the engine's exact rule (up to 65,536 docs), so that
    # BM25 and RM3's weighted, expanded queries take the tiered, pruned path with native spans on both devices
    "num_docs": 66_000, "docs_per_file": 1000, "min_len": 200, "max_len": 1200, "bg_vocab": 20_000,
    "rel_min": 5, "rel_max": 30, "seed": 4, "python_prefix": 1_000,
}
# the CPU's threads for phase 11's card-free work (the corpus, the index builds and the CPU's runs: most of the
# phase at 66,000 docs), which runs in a process of its own beside phases 5-10
ROBUST04_HOST_THREADS = 4
ROBUST04_HOST_WAIT_S = 900  # how long phase 11 waits for that process once it starts
ROBUST04_PUBLISHED_DOCS = 528_155  # TREC disks 4 and 5 minus the Congressional Record
# BM25 at the rank task's defaults; BM25RM3 at Anserini's RM3 defaults (one grid point)
ROBUST04_SEARCHERS = {"BM25": {"name": "BM25"}, "BM25RM3": {"name": "BM25RM3", "fbTerms": 10, "fbDocs": 10}}
SIGNIFICANCE_ITERS = 20_000  # randomization-test permutations of BM25 against RM3


def robust04_topics():
    """Robust04's 250 title queries as the port ships them, {qid: title}."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.utils.trec import load_trec_topics

    return load_trec_topics(constants["PACKAGE_PATH"] / "data" / "topics.robust04.301-450.601-700.txt")["title"]


def robust04_shaped_corpus(directory, num_docs, seed, docs_per_file=1000, min_len=200, max_len=1200,
                           bg_vocab=20_000, rel_min=5, rel_max=30):
    """Seeded TREC files in Robust04's layout (``<DOC><DOCNO>..</DOCNO><TEXT>..</TEXT></DOC>``,
    ``docs_per_file`` documents a file) by phase 4's recipe: Zipfian background
    words of ``bg_vocab`` synthetic words, among them every topic title word at
    a random rank from 100 to 3000 (so query terms occur in non-relevant docs
    too), docs of
    ``min_len``-``max_len`` words, and each of Robust04's 250 topics planted in
    ``rel_min``-``rel_max`` docs
    (the first third grade 2: every title word twice; the rest grade 1: every
    title word once) and half as many distractors (one title word, judged 0).
    Writes ``directory/docs/*.trec`` and ``directory/qrels.txt``; a directory
    whose qrels file exists is reused. Returns (docs dir, qrels file)."""
    docs_dir, qrel_fn = os.path.join(directory, "docs"), os.path.join(directory, "qrels.txt")
    if os.path.exists(qrel_fn):
        return docs_dir, qrel_fn
    import re

    rng = np.random.Generator(np.random.PCG64(seed))
    vocab, seen = [], set()
    while len(vocab) < bg_vocab:
        w = _word(rng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    titles = {qid: re.findall(r"[a-z0-9]+", title.lower()) for qid, title in sorted(robust04_topics().items())}
    title_words = sorted({w for words in titles.values() for w in words})
    for w, rank in zip(title_words, rng.choice(np.arange(100, 3000), size=len(title_words), replace=False)):
        vocab[int(rank)] = w
    vocab_arr = np.asarray(vocab)
    probs = 1.0 / np.arange(1, bg_vocab + 1, dtype=np.float64) ** 1.1
    probs /= probs.sum()
    lengths = rng.integers(min_len, max_len + 1, size=num_docs)
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    draws = rng.choice(bg_vocab, size=int(bounds[-1]), p=probs).astype(np.int32)
    planted, qrels = {}, {}
    for qid, words in titles.items():
        n = int(rng.integers(rel_min, rel_max + 1))
        chosen = rng.choice(num_docs, size=n + n // 2, replace=False)
        qrels[qid] = {}
        for j, d in enumerate(chosen.tolist()):
            grade = 2 if j < n // 3 else (1 if j < n else 0)
            planted.setdefault(d, []).extend(words * 2 if grade == 2 else
                                             words if grade == 1 else [words[int(rng.integers(len(words)))]])
            qrels[qid][f"RB{d:06d}"] = grade
    os.makedirs(docs_dir, exist_ok=True)
    for f0 in range(0, num_docs, docs_per_file):
        parts = []
        for d in range(f0, min(num_docs, f0 + docs_per_file)):
            words = vocab_arr[draws[bounds[d]:bounds[d + 1]]].tolist()
            for w in planted.get(d, ()):
                words.insert(int(rng.integers(0, len(words) + 1)), w)
            parts.append(f"<DOC>\n<DOCNO> RB{d:06d} </DOCNO>\n<TEXT>\n{' '.join(words)}\n</TEXT>\n</DOC>\n")
        with open(os.path.join(docs_dir, f"rb{f0 // docs_per_file:04d}.trec"), "wt", encoding="ascii") as fh:
            fh.write("".join(parts))
    tmp = qrel_fn + ".tmp"
    with open(tmp, "wt", encoding="utf-8") as fh:
        for qid in sorted(qrels):
            for docid, rel in sorted(qrels[qid].items()):
                fh.write(f"{qid} 0 {docid} {rel}\n")
    os.replace(tmp, qrel_fn)  # last: the qrels file marks a finished corpus
    return docs_dir, qrel_fn


def index_arrays_equal(a, b):
    """Whether two built indexes hold the same vocab, docids, postings, lengths and prune tables."""
    da, db = a.data, b.data
    same = da.vocab == db.vocab and da.docid_strings == db.docid_strings
    for name in ("term_offsets", "doc_ids", "tfs", "doclens", "norm_doclens"):
        same = same and np.array_equal(np.asarray(getattr(da, name)), np.asarray(getattr(db, name)))
    return same and sorted(da.prune_tables) == sorted(db.prune_tables) and all(
        np.array_equal(da.prune_tables[k], db.prune_tables[k]) for k in da.prune_tables)


def robust04_host_side(workdir, shape=ROBUST04_SHAPED, cache_dir=None, threads=ROBUST04_HOST_THREADS):
    """Phase 11's work that needs no card, run in a process of its own while
    the card runs phases 5-10 (``start_host_side``): the corpus read
    by the native TREC reader, the index builds (native porter on every doc;
    the Python path and krovetz on a prefix) under ``workdir``'s
    ``cache_robust04``, and BM25 and BM25RM3 through ``rank.searcheval`` on the
    CPU with ``threads`` threads. Returns what phase 11 reads."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.native import native_status

    import capreolus_tpu_torch

    torch.set_num_threads(threads)
    capreolus_tpu_torch.load_all_modules()
    label = "[11 robust04-shaped]"
    check(all(st["loaded"] for st in native_status().values()), f"{label} a native library is missing")
    cache_dir = cache_dir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "robust04_shaped")
    n, seed, per_file = shape["num_docs"], shape["seed"], shape["docs_per_file"]
    t_start = time.perf_counter()
    docs_dir, qrel_fn = robust04_shaped_corpus(
        os.path.join(cache_dir, f"corpus_{n}_{seed}"), n, seed, per_file, shape["min_len"], shape["max_len"],
        shape["bg_vocab"], shape["rel_min"], shape["rel_max"])
    made = time.perf_counter() - t_start
    files = sorted(os.listdir(docs_dir))

    # index builds: native porter on all docs; on a prefix of the files the native build, the
    # Python path and krovetz (each prefix build over a directory of its own, so under an index path of its own)
    prefixes = {}
    for how in ("native", "python"):
        prefixes[how] = os.path.join(workdir, f"robust04_prefix_{how}")
        os.makedirs(prefixes[how], exist_ok=True)
        for fn in files[:max(1, shape["python_prefix"] // per_file)]:
            os.symlink(os.path.join(docs_dir, fn), os.path.join(prefixes[how], fn))
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_robust04")
    builds, indexes = {}, {}
    for name, coll_path, cfg, env in (("native_porter_all", docs_dir, {}, "1"),
                                      ("native_porter_prefix", prefixes["native"], {}, "1"),
                                      ("python_porter_prefix", prefixes["python"], {}, "0"),
                                      ("krovetz_prefix", prefixes["native"], {"stemmer": "krovetz"}, "1")):
        index = Index.create("tpu", {**cfg, "collection": {"name": "robust04", "path": coll_path}})
        with native_switch(env):
            t0 = time.perf_counter()
            index.create_index()
            builds[name] = round(time.perf_counter() - t0, 2)
        indexes[name] = index
    data = indexes["native_porter_all"].data
    out = {"docs_dir": docs_dir, "qrel_fn": qrel_fn, "files": len(files), "corpus_s": round(made, 1),
           "builds_s": builds, "prefix_docs": len(indexes["python_porter_prefix"].data.docid_strings),
           "python_equals_native": index_arrays_equal(indexes["native_porter_prefix"], indexes["python_porter_prefix"]),
           "num_docs": int(data.num_docs), "postings": int(len(data.doc_ids)), "terms": int(data.num_terms),
           "threads": constants["MAX_THREADS"], "secs": {}, "metrics": {}, "runs": {}}
    benchmark = {"name": "robust04.yang19", "qrelfile": qrel_fn, "collection": {"path": docs_dir}}
    for name, config in ROBUST04_SEARCHERS.items():
        _, out["secs"][name], out["metrics"][name], out["runs"][name] = rank_search(
            config, "cpu", os.path.join(workdir, "results_robust04_cpu"), benchmark)
    out["seconds"] = round(time.perf_counter() - t_start, 1)
    return out


def phase_robust04(workdir, host, shape=ROBUST04_SHAPED):
    """A Robust04-shaped experiment through ``rank.searcheval``: the corpus, the
    index builds and the CPU's runs from ``host`` (``start_host_side`` of
    ``robust04_host_side``, waited for here), then BM25 and BM25RM3 on
    ``robust04.yang19``'s five folds on the card, their run files and metrics against the CPU's, and the
    significance test of BM25 against RM3 on each device."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.evaluation import DEFAULT_METRICS
    from capreolus_tpu_torch.evaluation.significance import compare_runs
    from capreolus_tpu_torch.native import get_pruner_lib
    from capreolus_tpu_torch.searcher.scoring import EXACT_MAX_DOCS
    from capreolus_tpu_torch.utils.trec import load_qrels

    import capreolus_tpu_torch

    capreolus_tpu_torch.load_all_modules()
    label = "[11 robust04-shaped]"
    cpu, waited = wait_host_side(host, ROBUST04_HOST_WAIT_S, label)
    n, per_file, builds = shape["num_docs"], shape["docs_per_file"], cpu["builds_s"]
    qrels = load_qrels(cpu["qrel_fn"])
    check(cpu["num_docs"] == n, f"{label} the index holds {cpu['num_docs']} docs, not {n}")
    print(f"{label} corpus: {n} docs (Robust04 has {ROBUST04_PUBLISHED_DOCS}) in {cpu['files']} TREC files of "
          f"{per_file}, {shape['min_len']}-{shape['max_len']} words, {sum(len(q) for q in qrels.values())} judgements "
          f"over {len(qrels)} topics; ready in {cpu['corpus_s']:.1f} s")
    check(cpu["python_equals_native"], f"{label} the Python path's index differs from the native build of the same prefix")
    print(f"{label} index builds (s): native porter on {n} docs {builds['native_porter_all']} "
          f"({cpu['postings']} postings, {cpu['terms']} terms); on a {cpu['prefix_docs']}-doc prefix native "
          f"{builds['native_porter_prefix']}, Python (CAPREOLUS_NATIVE=0) {builds['python_porter_prefix']} "
          f"(arrays identical to native), krovetz {builds['krovetz_prefix']}; {cpu['threads']} threads; in a "
          f"process of their own while the card ran phases 5-10 (all of it {cpu['seconds']} s with the CPU's "
          f"runs below; {waited:.1f} s waited for it here)")

    # the rank task on the card over the index the host side built (its done file: no rebuild)
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_robust04")
    benchmark = {"name": "robust04.yang19", "qrelfile": cpu["qrel_fn"], "collection": {"path": cpu["docs_dir"]}}
    reset_launch_counts()
    secs, metrics, runs, tasks = {}, {}, {}, {}
    for name, config in ROBUST04_SEARCHERS.items():
        tasks[name], secs[name, "cuda"], metrics[name, "cuda"], runs[name, "cuda"] = rank_search(
            config, "cuda", os.path.join(workdir, "results_robust04_cuda"), benchmark)
        secs[name, "cpu"], metrics[name, "cpu"], runs[name, "cpu"] = (cpu["secs"][name], cpu["metrics"][name],
                                                                      cpu["runs"][name])
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"{label} the sparse path launched a port kernel: {launched}")
    engine = tasks["BM25"].searcher.get_engine()
    check(get_pruner_lib() is not None and engine.exact_path() == (n <= EXACT_MAX_DOCS),
          f"{label} BM25 took the {'exact' if engine.exact_path() else 'tiered'} path over {n} docs "
          f"(the rule: exact up to {EXACT_MAX_DOCS}), or without the native span builder")
    key = (1000, 0.9, 0.4)
    verdict = {"tiles": engine._prune_tiles_ok.get(key), "stream": engine._prune_stream_effective.get(key),
               "last_prune_stats": engine.last_prune_stats}
    faults = run_faults(runs["BM25", "cuda"], runs["BM25", "cpu"], SPARSE_RTOL, atol=1e-6, near_ties=False)
    check(not faults, f"{label} BM25 card vs CPU: {faults[:5]}")
    faults = run_faults(runs["BM25RM3", "cuda"], runs["BM25RM3", "cpu"], FEEDBACK_RTOL, atol=1e-6)
    check(not faults, f"{label} BM25RM3 card vs CPU beyond near-ties: {faults[:5]}")
    gaps = {}
    for name in ROBUST04_SEARCHERS:
        gaps[name] = max(abs(metrics[name, "cuda"][m] - metrics[name, "cpu"][m]) for m in DEFAULT_METRICS)
        check(gaps[name] <= METRIC_TOL, f"{label} {name}: metrics card vs CPU differ by {gaps[name]:.2e}")
        print(f"{label} {name}: search {secs[name, 'cuda']:.2f} s on the card, {secs[name, 'cpu']:.2f} s on the CPU "
              f"({ROBUST04_HOST_THREADS} threads, beside phases 5-10); cross-validated map "
              f"{metrics[name, 'cuda']['map']:.4f} ndcg_cut_20 {metrics[name, 'cuda']['ndcg_cut_20']:.4f} P_20 "
              f"{metrics[name, 'cuda']['P_20']:.4f}; max metric gap card vs CPU {gaps[name]:.2e} (tolerance {METRIC_TOL})")
    print(f"{label} BM25 pruning verdict at k=1000: {verdict}")

    significance = {}
    for device in ("cuda", "cpu"):
        (bm25,), (rm3,) = runs["BM25", device].values(), runs["BM25RM3", device].values()
        significance[device] = compare_runs(bm25, rm3, qrels, metrics=["map"], iters=SIGNIFICANCE_ITERS)["map"]
    sig_gap = max(abs(significance["cuda"][k] - significance["cpu"][k]) for k in significance["cuda"])
    check(sig_gap <= METRIC_TOL, f"{label} significance card vs CPU: {significance}")
    print(f"{label} compare_runs(BM25, BM25RM3, map) on the card {json.dumps(significance['cuda'])}; "
          f"on the CPU {'identical' if significance['cuda'] == significance['cpu'] else significance['cpu']}")

    searcher = tasks["BM25"].searcher
    topic_fn = tasks["BM25"].benchmark.get_topics_file()
    profiled = profile_call(lambda: searcher.query_from_file(topic_fn, os.path.join(workdir, "robust04_profiled")),
                            f"{label} BM25", top=6, what=f"search of {len(robust04_topics())} topics")
    summary = {"shape": shape, "corpus_s": cpu["corpus_s"], "builds_s": builds, "prefix_docs": cpu["prefix_docs"],
               "postings": cpu["postings"], "terms": cpu["terms"], "host_side_s": cpu["seconds"],
               "waited_s": round(waited, 1),
               "search_s": {f"{k}_{d}": round(v, 3) for (k, d), v in secs.items()},
               "map": {k: metrics[k, "cuda"]["map"] for k in ROBUST04_SEARCHERS},
               "metric_gap_card_cpu": gaps, "significance": significance["cuda"], "bm25_pruning": verdict,
               "profiled_bm25": {k: profiled[k] for k in ("wall_ms", "busy_ms", "top_ops")}}
    print(f"{label} summary {json.dumps(summary, default=str)}")
    return summary


# ---------------------------------------------------------------- phase 12: the other BERT rerankers
PARADE_EXTRACTOR = {"name": "pooledbertpassage", "maxseqlen": 256, "numpassages": 16, "passagelen": 150,
                    "stride": 75}  # docs/reproduction/configs/config_parade.txt
CEDR_RERANKER = {"simmat_layers": "0..12,1", "cls": "avg", "combine_hidden": 1024, "gradkernels": True}
CEDR_EXTRACTOR = {"name": "pooledbertpassage", "maxseqlen": 256, "numpassages": 4, "passagelen": 225,
                  "stride": 225}  # docs/reproduction/configs/config_cedrknrm_pt.txt
BIRCH_EXTRACTOR = {"name": "birchbertpassage", "sentences": True}  # its defaults: maxseqlen 256, 16 passages of 150
PHASE12_QUERIES = {"parade": 1, "parade_int8": 2, "cedr": 1, "birch": 1, "moe": 1}  # served after a warm-up request
# (4, 4, 4, 2, 1 before phase 13 joined the script; lowered to keep it under 1000 s)
PHASE12_WARMUP = 8  # the topic of each service's warm-up request, after the served ones
PHASE12_CPU_DOCS = {"parade": 2, "cedr": 4, "birch": 1, "moe": 2}  # docs of query 0 scored on the CPU too
BIRCH_CPU_TOL = 2e-3  # bert-large scores, GPU vs CPU: 24 layers of f32 matmuls summed in other orders, twice
# BERT-base's 12 (BERT_CPU_TOL)
MOE_FLIP_SHARE = 1e-3  # tokens of a layer whose top-2 experts may differ between the devices: a gate
# probability an ulp from the next one can rank apart; such a token's output moves by a whole expert's
MOE_EXPERTS, MOE_TOPK = 4, 2
# the reranker's task at tiny width on phase 9a's rerank golden: every passage of a doc of ~40 words
GOLDEN_POOLED_EXTRACTOR = {"maxseqlen": 96, "maxqlen": 8, "numpassages": 2, "passagelen": 40, "stride": 40}
GOLDEN_TRAINER = {"niters": 4, "itersize": 256, "batch": 16, "lr": 1e-3, "bertlr": 1e-3, "validatefreq": 1}


def smi_line():
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def seeded_model_params(model, seed, std=0.02):
    """Flat ``params/...`` arrays of any BERT reranker's model, named as the JAX
    trainer saves them: N(0, std) matrices, embeddings and PARADE's vectors,
    zero biases, unit LayerNorm scales; CEDR-KNRM's kernel bank and Birch's
    top-k weights at their initial values."""
    from capreolus_tpu_torch.convert import flax_leaves

    rng = np.random.Generator(np.random.PCG64(seed))
    params = dict(model.named_parameters())
    flat = {}
    for key, name, _, _, shape in flax_leaves(model):
        value = params[name].detach().cpu()
        leaf = key.rsplit("/", 1)[1]
        if leaf in ("mus", "sigmas", "topk_weights"):
            flat[key] = value.numpy().copy()
        elif leaf == "scale":
            flat[key] = np.ones(shape, np.float32)
        elif leaf == "bias":
            flat[key] = np.zeros(shape, np.float32)
        else:
            flat[key] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return flat


def write_birch_checkpoint(directory, config, seed=12, std=0.02, head="nsp"):
    """A Hugging Face ``BertForNextSentencePrediction`` checkpoint at ``config``'s
    geometry with seeded N(0, std) weights (zero biases, unit LayerNorm
    scales), as ``pytorch_model.bin`` (``torch.save`` of its state dict) and
    ``config.json``; with ``head="mlm"`` a ``BertForMaskedLM`` one, whose
    ``cls.predictions`` head has a seeded transform and bias and the decoder
    tied to the word embeddings. Returns the state dict written."""
    gen = torch.Generator().manual_seed(seed)
    h, inter = config.hidden_size, config.intermediate_size

    def normal(*shape):
        return torch.randn(shape, generator=gen) * std

    sd = {"bert.embeddings.word_embeddings.weight": normal(config.vocab_size, h),
          "bert.embeddings.position_embeddings.weight": normal(config.max_position, h),
          "bert.embeddings.token_type_embeddings.weight": normal(config.type_vocab_size, h),
          "bert.embeddings.LayerNorm.weight": torch.ones(h), "bert.embeddings.LayerNorm.bias": torch.zeros(h)}
    for i in range(config.num_layers):
        pre = f"bert.encoder.layer.{i}."
        for name, (n_out, n_in) in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                                    ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                                    ("intermediate.dense", (inter, h)), ("output.dense", (h, inter))):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = normal(n_out, n_in), torch.zeros(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = torch.ones(h), torch.zeros(h)
    sd["bert.pooler.dense.weight"], sd["bert.pooler.dense.bias"] = normal(h, h), torch.zeros(h)
    if head == "mlm":
        sd["cls.predictions.transform.dense.weight"] = normal(h, h)
        sd["cls.predictions.transform.dense.bias"] = torch.zeros(h)
        sd["cls.predictions.transform.LayerNorm.weight"] = torch.ones(h)
        sd["cls.predictions.transform.LayerNorm.bias"] = torch.zeros(h)
        sd["cls.predictions.bias"] = normal(config.vocab_size)
        sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    else:
        sd["cls.seq_relationship.weight"], sd["cls.seq_relationship.bias"] = normal(2, h), normal(2)
    os.makedirs(directory, exist_ok=True)
    torch.save(sd, os.path.join(directory, "pytorch_model.bin"))
    architecture = "BertForMaskedLM" if head == "mlm" else "BertForNextSentencePrediction"
    with open(os.path.join(directory, "config.json"), "wt") as fh:
        json.dump({"architectures": [architecture], "model_type": "bert",
                   "vocab_size": config.vocab_size, "hidden_size": h, "num_hidden_layers": config.num_layers,
                   "num_attention_heads": config.num_heads, "intermediate_size": inter,
                   "max_position_embeddings": config.max_position, "type_vocab_size": config.type_vocab_size,
                   "hidden_act": "gelu", "layer_norm_eps": 1e-12}, fh)
    return sd


def serve_reranker(label, name, rr_cfg, ckpt, corpus_dir, topics, n_queries, reranker=None):
    """A ``RerankingService`` on the card for reranker ``name`` over the phase-4
    corpus (BM25 first stage, topn 100, k 10): a warm-up request (which
    calibrates an int8 model), then ``n_queries`` served with the launches of
    every kernel counted from 0, their times, the peak device memory and one
    profiled request. ``reranker`` is one already created from ``rr_cfg``
    (its extractor preprocessed or not). Returns (service, summary)."""
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService

    coll = {"name": "dummy", "path": corpus_dir}
    cfg = json.loads(json.dumps(rr_cfg))
    cfg.setdefault("extractor", {})["index"] = {"collection": coll}
    t0 = time.perf_counter()
    index = Index.create("tpu", {"collection": coll})
    index.create_index()
    reranker = reranker or Reranker.create(name, cfg)
    svc = RerankingService(index, reranker, ckpt, topn=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.search(topics[PHASE12_WARMUP:PHASE12_WARMUP + 1], k=10)  # warm-up request (calibrates an int8 model)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    queries = topics[:n_queries]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    request_ms, rerank_ms, features_ms, results = [], [], [], []
    for query in queries:
        t0 = time.perf_counter()
        results.append(svc.search([query], k=10)[0])
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        rerank_ms.append(svc.last_stage_ms["rerank"])
        features_ms.append(svc.last_stage_ms["features"])
    launches = launch_counts()
    launches.update(int8_matmul_modes=dict(int8_matmul.mode_launches), pad_copies=int8_matmul.pad_copies)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(len(hits) == 10 and all(np.isfinite(s) for _, s in hits) for hits in results),
          f"{label}: a served request did not return 10 finite scores")
    print(f"{label} set-up: service {t_service:.1f} s (model built and weights moved to the card; extractor "
          f"{svc.extractor_seconds:.1f} s), warm-up request {warm_ms:.1f} ms; per request (median of {len(queries)}): "
          f"{np.median(request_ms):.2f} ms (each: {', '.join(f'{t:.1f}' for t in request_ms)}; spread "
          f"{max(request_ms) - min(request_ms):.1f} ms), rerank {np.median(rerank_ms):.2f} ms, of which the host's "
          f"features {np.median(features_ms):.2f} ms; peak device memory {peak_gb:.2f} GB; launches in the run: "
          f"{ {k: v for k, v in launches.items() if v} }")
    profiled = profile_request(svc, queries[0], label)
    summary = {"request_ms": float(np.median(request_ms)), "request_ms_each": [round(t, 2) for t in request_ms],
               "rerank_ms": float(np.median(rerank_ms)), "features_ms": float(np.median(features_ms)),
               "peak_gb": peak_gb, "launches": launches, "queries": len(queries), "warm_ms": warm_ms,
               "service_s": t_service,
               "profiled": {k: profiled[k] for k in ("wall_ms", "busy_ms", "top_ops", "copy_kernels")}}
    return svc, results, summary


def served_candidates(svc, query):
    """The ``topn`` first-stage docids a request for ``query`` reranks."""
    from capreolus_tpu_torch.serving import RetrievalService

    docids = [d for d, _ in RetrievalService.search_async(svc, [query], k=svc.topn)()[0]]
    check(len(docids) == svc.topn, f"{len(docids)} first-stage candidates, not topn {svc.topn}")
    return docids


def served_batch(svc, query, qid):
    """The reranker's input of a request for ``query``: all its ``topn``
    candidates, the batch the served forward runs."""
    return svc.rerank_batch(qid, query, served_candidates(svc, query))


def card_vs_cpu(label, svc, name, rr_cfg, query, n_docs, tol, state=None):
    """Query 0's top ``n_docs`` first-stage candidates scored on the card and by
    the same reranker on the CPU with the card's weights (``state``: the card
    model's state dict, else its own). Returns the max |err|."""
    from capreolus_tpu_torch.reranker import Reranker

    docids = served_candidates(svc, query)[:n_docs]
    batch = svc.rerank_batch("smoke12", query, docids)
    cfg = json.loads(json.dumps(rr_cfg))
    cfg.setdefault("extractor", {})["index"] = svc.reranker.extractor.config["index"]
    cpu_rr = Reranker.create(name, cfg)
    cpu_model = cpu_rr.build_model()
    cpu_model.load_state_dict({k: v.cpu() for k, v in (state or svc.reranker.model.state_dict()).items()})
    cpu_model.eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        gpu = svc.reranker.test(batch, svc.device).cpu().numpy()
        cpu = cpu_rr.test(batch, "cpu").numpy()
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu - cpu).max())
    print(f"{label} query 0's top {len(docids)} first-stage docs, card vs CPU ({cpu_s:.1f} s with the CPU): max |err| "
          f"{err:.3g} (tolerance {tol}; scores {np.round(gpu, 5).tolist()})")
    check(np.isfinite(gpu).all() and err <= tol, f"{label}: card scores {gpu} vs CPU {cpu}")
    return err, batch, cpu_rr


def phase_parade(workdir, corpus_dir, topics):
    """12a: PARADE (transformer aggregation) at BERT-base width, f32 then int8."""
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker import Reranker

    label = "[12a parade]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")  # phase 5's indexes
    rr_cfg = {"pretrained": "bert-base-uncased", "allowrandominit": True, "aggregation": "transformer",
              "extractor": dict(PARADE_EXTRACTOR)}
    model = Reranker.create("parade", json.loads(json.dumps(rr_cfg))).build_model()
    ckpt = save_params(seeded_model_params(model, seed=5), os.path.join(workdir, "parade.npz"))
    layers = model.config.num_layers + 2
    del model
    svc, results, f32 = serve_reranker(label, "parade", rr_cfg, ckpt, corpus_dir, topics, PHASE12_QUERIES["parade"])
    k2 = f32["launches"]["flash_attention"]
    check(k2 == layers * f32["queries"], f"{label}: K2 launched {k2} times, expected {layers} per request "
                                         f"(12 encoder layers + 2 aggregation layers)")
    f32["cpu_err"], batch, _ = card_vs_cpu(label, svc, "parade", rr_cfg, topics[0], PHASE12_CPU_DOCS["parade"],
                                           BERT_CPU_TOL)
    f32["k2_err"] = hold_k2(svc.reranker, served_batch(svc, topics[0], "smoke12_k2"),
                            f"a served request's forward over its {svc.topn} candidates", prefix=label)
    check(set(f32["k2_err"]) == {"L256", "L17"}, f"{label}: K2 was not held at L 256 and 17: {f32['k2_err']}")
    scores0 = dict(svc.search([topics[0]], k=svc.topn)[0])
    del svc
    torch.cuda.empty_cache()

    label8 = "[12a parade int8]"
    rr8 = dict(rr_cfg, quantize="int8")
    svc, results8, int8 = serve_reranker(label8, "parade", rr8, ckpt, corpus_dir, topics, PHASE12_QUERIES["parade_int8"])
    n = int8["queries"]
    want = {"int8_matmul": 6 * layers * n, "quantize_per_token": 3 * layers * n, "flash_attention": layers * n}
    for kernel, count in want.items():
        check(int8["launches"][kernel] == count, f"{label8}: {kernel} launched {int8['launches'][kernel]} times, "
                                                 f"expected {count}")
    check(int8["launches"]["int8_matmul_modes"]["int8_gelu"] == layers * n, f"{label8}: int8-gelu epilogues "
                                                                            f"{int8['launches']['int8_matmul_modes']}")
    model = svc.reranker.model
    amax = [getattr(model, name).gelu_amax for name in ("agg_layer_0", "agg_layer_1")]
    check(all(bool((a > 0).all()) for a in amax), f"{label8}: the aggregation layers were not calibrated")
    # the int8 aggregation layers of a served request's 100 candidates (M = 17 x 100 rows) on the CPU,
    # from the card's input to each
    b8 = served_batch(svc, topics[0], "smoke12_int8")
    captured = []
    hook = model.agg_layer_0.register_forward_pre_hook(lambda m, args: captured.append(args[0].detach().clone()))
    with torch.inference_mode():
        gpu8 = svc.reranker.test(b8, svc.device).cpu().numpy()
    hook.remove()
    cpu_rr = Reranker.create("parade", dict(json.loads(json.dumps(rr8)), extractor=dict(
        PARADE_EXTRACTOR, index=svc.reranker.extractor.config["index"])))
    cpu_model = cpu_rr.build_model().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    layer_err = []
    with torch.inference_mode():
        x = captured[0]
        full = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        for name in ("agg_layer_0", "agg_layer_1"):
            out = getattr(model, name)(x, full)
            layer_err.append(float((out.cpu() - getattr(cpu_model, name)(x.cpu(), full.cpu())).abs().max()))
            x = out
        head = cpu_model.classifier(x[:, 0].cpu().float())[:, 0].numpy()
    head_err = float(np.abs(gpu8 - head).max())
    check(max(layer_err) <= INT8_LAYER_TOL and head_err <= BERT_CPU_TOL,
          f"{label8}: int8 aggregation layers card vs CPU {layer_err}, head {head_err}")
    int8_scores = dict(svc.search([topics[0]], k=svc.topn)[0])
    gap = max(abs(int8_scores[d] - s) for d, s in scores0.items())
    overlap = len({d for d, _ in results8[0]} & {d for d, _ in results[0]})
    spread = max(scores0.values()) - min(scores0.values())
    int8.update(agg_layer_err=layer_err, head_err=head_err, int8_f32_gap=gap, top10_overlap_f32=overlap)
    print(f"{label8} aggregation layers (M = {x.shape[0]} x {x.shape[1]} rows) card vs CPU from the card's input: "
          f"max |err| {layer_err} (tolerance {INT8_LAYER_TOL}), head {head_err:.3g} (tolerance {BERT_CPU_TOL}); "
          f"int8 vs f32 on query 0's {len(scores0)} docs: max |gap| {gap:.4g} (f32 scores spread over {spread:.4g}), "
          f"top-10 overlap {overlap}/10 (reported, not pinned); zero-padded X1 copies {int8['launches']['pad_copies']}")
    del svc, model, cpu_model
    torch.cuda.empty_cache()
    return {"f32": f32, "int8": int8}


def phase_cedr(workdir, corpus_dir, topics):
    """12b: CEDR-KNRM at electra-base width (random init), f32."""
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker import Reranker

    label = "[12b cedrknrm]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")
    rr_cfg = dict(CEDR_RERANKER, pretrained="electra-base", allowrandominit=True, extractor=dict(CEDR_EXTRACTOR))
    model = Reranker.create("CEDRKNRM", json.loads(json.dumps(rr_cfg))).build_model()
    ckpt = save_params(seeded_model_params(model, seed=6), os.path.join(workdir, "cedr.npz"))
    layers = model.config.num_layers
    del model
    print(f"{label} served in f32, TF32 off (the published config's trainer.amp=both is phase 13b's)")
    svc, _, out = serve_reranker(label, "CEDRKNRM", rr_cfg, ckpt, corpus_dir, topics, PHASE12_QUERIES["cedr"])
    check(out["launches"]["flash_attention"] == layers * out["queries"],
          f"{label}: K2 launched {out['launches']['flash_attention']} times, expected {layers} per request")
    out["cpu_err"], _, _ = card_vs_cpu(label, svc, "CEDRKNRM", rr_cfg, topics[0], PHASE12_CPU_DOCS["cedr"], BERT_CPU_TOL)
    out["k2_err"] = hold_k2(svc.reranker, served_batch(svc, topics[0], "smoke12_k2"),
                            f"a served request's forward over its {svc.topn} candidates", prefix=label)
    del svc
    torch.cuda.empty_cache()
    return out


def phase_birch(workdir, corpus_dir, topics):
    """12c: Birch at bert-large width over a seeded NSP checkpoint read from disk,
    the encoder frozen, sentence passages."""
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker.bert import convert_hf_weights, get_bert_config

    label = "[12c birch]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")
    directory = os.path.join(workdir, "birch_bert_large_nsp")
    large = get_bert_config("bert-large-uncased")
    t0 = time.perf_counter()
    written = write_birch_checkpoint(directory, large)
    t_write = time.perf_counter() - t0
    rr_cfg = {"pretrained": directory, "finetune": False, "topk": 3, "extractor": dict(BIRCH_EXTRACTOR)}
    # the serving checkpoint of a frozen Birch: its dev.best holds the top-k weights alone
    ckpt = save_params({"params/topk_weights": np.asarray([0.5, 0.3, 0.2], np.float32)},
                       os.path.join(workdir, "birch.npz"))
    svc, results, out = serve_reranker(label, "birch", rr_cfg, ckpt, corpus_dir, topics, PHASE12_QUERIES["birch"])
    model = svc.reranker.model
    check(model.config.num_layers == 24 and model.config.hidden_size == 1024, f"{label}: not bert-large")
    check(out["launches"]["flash_attention"] == 24 * out["queries"],
          f"{label}: K2 launched {out['launches']['flash_attention']} times, expected 24 per request")
    want = convert_hf_weights(written, model.config)
    state = {k: v.cpu() for k, v in model.bert.state_dict().items()}
    loaded = all(torch.equal(state[k], v) for k, v in want.items()) and set(want) == set(state)
    head = (torch.equal(model.relevance.weight[0].cpu(), written["cls.seq_relationship.weight"][1])
            and torch.equal(model.relevance.bias.cpu(), written["cls.seq_relationship.bias"][1:]))
    check(loaded and head, f"{label}: the encoder or NSP head on the card differ from the checkpoint written")
    ext = svc.reranker.extractor
    check(ext._punkt is not None and ext._punkt._punkt is None, f"{label}: the sentence splitter did not run")
    hits = [d for d, _ in results[0]]
    valid = [sum(p != [ext.pad_tok] for p in ext._get_passages(d)) for d in hits]
    out.update(checkpoint_write_s=t_write, checkpoint_bytes=os.path.getsize(os.path.join(directory, "pytorch_model.bin")),
               trainable=sorted(k for k in ("params/bert/word_embeddings", "params/relevance/kernel",
                                            "params/topk_weights") if svc.reranker.trainable(tuple(k.split("/")), None)))
    print(f"{label} checkpoint: {out['checkpoint_bytes'] / 1e9:.2f} GB written in {t_write:.1f} s (torch.save, "
          f"BertForNextSentencePrediction layout), read without transformers; encoder and NSP head on the card equal "
          f"the tensors written; frozen (finetune=False): trainable {out['trainable']}; sentence passages through the "
          f"splitter (nltk absent): {np.mean(valid):.2f} valid passages a doc over query 0's top 10 (the corpus has "
          f"no sentence punctuation, so each doc is one sentence cut into whole chunks of 150 tokens)")
    out["cpu_err"], _, _ = card_vs_cpu(label, svc, "birch", rr_cfg, topics[0], PHASE12_CPU_DOCS["birch"], BIRCH_CPU_TOL)
    del svc, model, state, want, written
    torch.cuda.empty_cache()
    return out, directory


def phase_moe(workdir, corpus_dir, topics, dense_checkpoint):
    """12d: BERTMaxP with 4 experts of top-2 routing in every layer, BERT-base
    width; MoE over ``dense_checkpoint`` (12c's) must be refused."""
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.core import ConfigError, constants
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RetrievalService

    label = "[12d moe]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")
    rr_cfg = {"pretrained": "bert-base-uncased", "allowrandominit": True, "moeexperts": MOE_EXPERTS,
              "moetopk": MOE_TOPK}
    try:  # a dense checkpoint cannot seed the experts: refused, as in JAX
        Reranker.create("BERTMaxP", dict(rr_cfg, pretrained=dense_checkpoint, extractor={"index": {"collection": {
            "name": "dummy", "path": corpus_dir}}})).build_model()
        check(False, f"{label}: MoE took a dense checkpoint")
    except ConfigError as e:
        print(f"{label} MoE over a dense checkpoint refused: {e}")
    model = Reranker.create("BERTMaxP", dict(rr_cfg, extractor={"index": {"collection": {
        "name": "dummy", "path": corpus_dir}}})).build_model()
    ckpt = save_params(seeded_model_params(model, seed=7), os.path.join(workdir, "moe.npz"))
    layers = model.config.num_layers
    del model
    svc, results, out = serve_reranker(label, "BERTMaxP", rr_cfg, ckpt, corpus_dir, topics, PHASE12_QUERIES["moe"])
    check(out["launches"]["flash_attention"] == layers * out["queries"],
          f"{label}: K2 launched {out['launches']['flash_attention']} times, expected {layers} per request")
    # 8 docs on the CPU, each layer from the card's input: a token whose top-2 set differs between the
    # devices is counted and left out; the others' outputs within BERT_CPU_TOL; then the head from the
    # card's last hidden states
    hits = RetrievalService.search_async(svc, [topics[0]], k=svc.topn)()[0]
    batch = svc.rerank_batch("smoke12_moe", topics[0], [d for d, _ in hits[:PHASE12_CPU_DOCS["moe"]]])
    model = svc.reranker.model
    cpu_rr = Reranker.create("BERTMaxP", dict(rr_cfg, extractor={"index": svc.reranker.extractor.config["index"]}))
    cpu_model = cpu_rr.build_model().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    seq = batch["pos_bert_input"].shape[-1]
    ids, seg, mask = (torch.from_numpy(batch[k].reshape(-1, seq)) for k in ("pos_bert_input", "pos_seg", "pos_mask"))
    doc_mask = torch.from_numpy(batch["pos_mask"])
    t0 = time.perf_counter()
    flips, tokens, layer_err = 0, 0, []
    with torch.inference_mode():
        gpu = svc.reranker.test(batch, svc.device).cpu().numpy()
        keys = mask.bool().cuda()
        hidden = model.bert.embed(ids.cuda(), seg.cuda())
        for i in range(layers):
            gl, cl = getattr(model.bert, f"layer_{i}"), getattr(cpu_model.bert, f"layer_{i}")
            out_gpu = gl(hidden, keys)
            out_cpu = cl(hidden.cpu(), keys.cpu())
            inner = gl.attention_ln(hidden + gl.attention(hidden, keys))
            top_gpu = gl.moe.gates(inner).cpu() > 0
            top_cpu = cl.moe.gates(inner.cpu()) > 0
            same = (top_gpu == top_cpu).all(dim=-1)
            flips += int((~same).sum())
            tokens += same.numel()
            layer_err.append(float((out_gpu.cpu() - out_cpu).abs().amax(dim=-1)[same].max()))
            hidden = out_gpu
        pooled = torch.tanh(cpu_model.bert.pooler(hidden[:, 0].cpu()))
        head = cpu_rr._head_scores(cpu_model.classifier(pooled)[:, 0].reshape(doc_mask.shape[:2]), doc_mask).numpy()
    cpu_s = time.perf_counter() - t0
    head_err = float(np.abs(gpu - head).max())
    check(max(layer_err) <= BERT_CPU_TOL and flips <= MOE_FLIP_SHARE * tokens and head_err <= BERT_CPU_TOL,
          f"{label}: MoE layers card vs CPU {layer_err}, {flips} routing flips of {tokens}, head {head_err}")
    print(f"{label} query 0's top {len(gpu)} docs, card vs CPU ({cpu_s:.1f} s with the CPU): each layer from the card's "
          f"input, max |err| {max(layer_err):.3g} (tolerance {BERT_CPU_TOL}) over tokens routed alike; tokens whose "
          f"top-{MOE_TOPK} experts differ between the devices {flips} of {tokens} (share allowed {MOE_FLIP_SHARE}); "
          f"scores from the card's last layer {head_err:.3g} (tolerance {BERT_CPU_TOL})")
    out.update(cpu_err=head_err, layer_err=max(layer_err), routing_flips=flips, routed_tokens=tokens)
    del svc, model, cpu_model
    torch.cuda.empty_cache()
    return out


def phase_other_tasks(workdir):
    """12e: rerank.traineval for PARADE, CEDR-KNRM and Birch at tiny width on
    phase 9a's rerank golden on the card (step 1 against the CPU), bircheval,
    and rererank.traineval with KNRM then tiny BERTMaxP."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.evaluation import DEFAULT_METRICS, eval_runs
    from capreolus_tpu_torch.searcher import Searcher
    from capreolus_tpu_torch.task import Task

    label = "[12e tasks]"
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rerank_golden")  # phase 9a's golden and caches
    constants["RESULTS_BASE_PATH"] = os.path.join(workdir, "results_rerank_golden_12")
    t0 = time.perf_counter()
    topics, qrels = setup_rerank_golden(os.path.join(workdir, "rerank_golden"))
    qids = sorted(topics)
    split = RERANK_GOLDEN["split"]
    test_q = qids[split[0] + split[1]:]
    out = {}
    reset_launch_counts()
    for name, extra in (("parade", {}), ("CEDRKNRM", {"simmat_layers": "0..2,1"}), ("birch", {"finetune": True})):
        cfg = dict(extra, name=name, pretrained="tiny", hidden_dropout_prob=0.0,
                   extractor=dict(GOLDEN_POOLED_EXTRACTOR), trainer=dict(GOLDEN_TRAINER))
        task = rerank_task(cfg, "cuda")
        parity = step_parity(task, training_batch(task, 16), f"tiny {name} (dropout off)", prefix="[12e parity]")
        check(parity["launches"]["flash_attention"] == 0, f"{label} {name}: K2 launched inside a training step")
        task = rerank_task(cfg, "cuda")
        first = task._best_search_run()
        preds = task.rerank_run(first, task.get_results_path())
        test_map = golden_map(preds["test"], qrels, test_q)
        check(all(np.isfinite(v) for r in preds["test"].values() for v in r.values()), f"{label} {name}: non-finite")
        out[name] = {"test_map": test_map, "first_stage_map": golden_map(first, qrels, test_q), "parity": parity}
        print(f"{label} {name} trained on the card: first stage {out[name]['first_stage_map']:.4f} -> test MAP "
              f"{test_map:.4f} (no pin: the JAX package has none for this model)")
        if name == "birch":
            metrics = task.bircheval()
            run = Searcher.load_trec_run(task.get_results_path() / "pred" / "test" / "best")
            want = eval_runs(run, task.benchmark.qrels, DEFAULT_METRICS, task.benchmark.relevance_level)
            check(metrics == want, f"{label} bircheval {metrics} differs from eval_runs {want}")
            out["bircheval_map"] = metrics["map"]
            print(f"{label} rerank.bircheval: map {metrics['map']:.4f}, equal to eval_runs of the run file it read")
    rr = Task.create("rererank", {
        "benchmark": {"name": "rerank_golden"}, "topn": 3,
        "rank": {"searcher": {"name": "BM25", "index": {"collection": {"name": "rerank_golden"}}}},
        "rerank1": {"reranker": dict(json.loads(json.dumps(RERANK_GOLDEN_CONFIGS["KNRM"])),
                                     trainer=dict(RERANK_GOLDEN_CONFIGS["KNRM"]["trainer"], niters=1)),
                    "threshold": RERANK_GOLDEN["cands"], "testthreshold": RERANK_GOLDEN["cands"]},
        "rerank2": {"reranker": dict(json.loads(json.dumps(RERANK_GOLDEN_CONFIGS["BERTMaxP"])),
                                     trainer=dict(RERANK_GOLDEN_CONFIGS["BERTMaxP"]["trainer"], niters=1)),
                    "threshold": 3, "testthreshold": 3}})
    rr.device = "cuda"
    stage3 = rr.train()
    metrics = rr.evaluate()
    check(all(len(docs) <= 3 for docs in stage3["test"].values()), f"{label} rererank: stage 3 took more than topn")
    out["rererank"] = {"map": metrics["map"], "test_map_over_test_qids": golden_map(stage3["test"], qrels, test_q)}
    launched = {k: v for k, v in launch_counts().items() if v}
    out["launches"] = launched
    print(f"{label} rererank.traineval (KNRM, then tiny BERT-MaxP over its top 3): test map {metrics['map']:.4f}; "
          f"launches over phase 12e: {launched}; {time.perf_counter() - t0:.1f} s")
    return out


def phase_other_rerankers(workdir, corpus_dir, topics, launches):
    """Phase 12: PARADE, CEDR-KNRM, Birch and MoE-BERT served on the card, then their tasks."""
    t0 = time.perf_counter()
    out = {"parade": phase_parade(workdir, corpus_dir, topics), "cedrknrm": phase_cedr(workdir, corpus_dir, topics)}
    out["birch"], birch_checkpoint = phase_birch(workdir, corpus_dir, topics)
    out["moe"] = phase_moe(workdir, corpus_dir, topics, birch_checkpoint)
    out["tasks"] = phase_other_tasks(workdir)
    served = [out["parade"]["f32"], out["parade"]["int8"], out["cedrknrm"], out["birch"], out["moe"]]
    for entry in served:  # each served run's launches, counted from 0 just before it
        for key in ("flash_attention", "int8_matmul", "quantize_per_token"):
            launches[key] = launches.get(key, 0) + entry["launches"][key]
    launches["int8_matmul_modes"] = out["parade"]["int8"]["launches"]["int8_matmul_modes"]
    launches["pad_copies"] = out["parade"]["int8"]["launches"]["pad_copies"]
    summary = {name: {k: v for k, v in entry.items() if k not in ("profiled",)} for name, entry in
               (("parade_f32", out["parade"]["f32"]), ("parade_int8", out["parade"]["int8"]),
                ("cedrknrm", out["cedrknrm"]), ("birch", out["birch"]), ("moe", out["moe"]))}
    summary["profiled"] = {name: entry["profiled"] for name, entry in
                           (("parade_f32", out["parade"]["f32"]), ("parade_int8", out["parade"]["int8"]),
                            ("cedrknrm", out["cedrknrm"]), ("birch", out["birch"]), ("moe", out["moe"]))}
    summary["tasks"] = {k: v for k, v in out["tasks"].items()}
    print(f"[12 other rerankers] {smi_line()}: every sub-phase passed in {time.perf_counter() - t0:.1f} s; summary "
          + json.dumps(summary, default=str))
    return out


# ---------------------------------------------------------------- phase 13: what the trainer left
PHASE13_BENCHMARK = "trainer_options"  # phase 4's corpus and topics in phase 9b's fold of 15 / 5 / 5
LORA_TRAIN = {"name": "BERTMaxP", "lora": 8, "loraalpha": 16.0, "hidden_dropout_prob": 0.1,
              "trainer": TRAINER_FULL}  # pretrained: a seeded BERT-base checkpoint directory phase 13a writes
PHASE9B_BERT = {"step_ms": 276.51, "peak_gb": 17.06, "s_per_iter": 5.57}  # phase 9b's full fine-tune, measured
# by this script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5)
LORA_QUERIES = 2  # served LoRA dev.best requests a precision, after a warm-up
LORA_CPU_DOCS = 1  # docs of query 0 scored on the CPU too (f32 end to end; int8 layer by layer)
CEDR_AMP_TRAINER = {"amp": "both", "batch": 6, "evalbatch": 128, "lr": 2e-5, "softmaxloss": False}  # as
# config_cedrknrm_pt.txt
AMP_STEPS = 4  # CEDR-KNRM training steps under amp
AMP_PARITY_SAMPLES = 1  # samples of the step-1 batch held card vs CPU (a CPU step of electra-base over
# 6 samples x 2 docs x 4 passages of 256 tokens takes minutes)
AMP_LOSS_RTOL = 1e-4  # step 1 under amp, card vs CPU: the loss as phase 9a's (f32 sums in other orders on the
# same bf16-rounded weights; the embedding sum is bf16 on both devices, one rounding per add)
AMP_GRAD_RTOL = 2 ** -8  # each gradient tensor against the largest entries of its positive and negative
# uses, summed: each use's gradient passes back through its own bf16 rounding of the weights, so two devices
# a rounding apart in f32 can land one bf16 step apart in each use, and the pairwise loss subtracts the uses
PHASE12B_CEDR_MS = 585.10  # phase 12b's f32 CEDR-KNRM request, measured by this script on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §5)
K1_EXACT_TOL = 1e-3  # K1's exact-match kernel (sigma 0.001) on bf16-normalised rows against its plain
# version: a row's self-similarity sits on the kernel's slope, where f32 rounding moves it 1/sigma times as
# much as at the flat peak f32 rows reach (tests/test_torch_amp.py); the other ten kernels at ERR_TOL
COLBERT_TRAIN = {"name": "colbert", "pretrained": "bert-base-uncased", "allowrandominit": True,
                 "dim": COLBERT["dim"], "extractor": {"maxqlen": COLBERT["maxqlen"], "maxdoclen": COLBERT["maxdoclen"]},
                 "trainer": {"batch": 32, "itersize": 256, "niters": 1, "validatefreq": 1, "evalbatch": TRAIN_THRESHOLD}}


def register_phase13_benchmark(workdir, corpus_dir, topics, qrels):
    """Phase 4's corpus and topics as the benchmark ``PHASE13_BENCHMARK`` (phase
    9b's fold). Returns (collection config, qids, {qid: topic})."""
    coll = {"name": "dummy", "path": corpus_dir}
    qids = [str(100 + t) for t in range(len(topics))]
    topic_of = dict(zip(qids, topics))
    register_golden(corpus_dir, *write_qrels_topics(topic_of, qrels, os.path.join(workdir, "phase13")), qids,
                    name=PHASE13_BENCHMARK, split=TRAIN_SPLIT, collection=coll)
    return coll, qids, topic_of


def training_batches(task, batch, steps):
    """``steps`` [1, batch, ...] training batches of ``task``'s sampler (``training_batch``'s, consecutive)."""
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    first = training_batch(task, batch)
    it = iter(task.sampler)
    for _ in range(batch):  # the stream position after the first batch
        next(it)
    out = [first]
    for _ in range(steps - 1):
        collated = collate([next(it) for _ in range(batch)], ARRAY_KEYS)
        out.append({k: v[None] for k, v in collated.items()})
    return out


def pred_sampler(task, qid, docids):
    """A ``pred`` sampler of ``docids`` for ``qid`` over ``task``'s extractor."""
    from capreolus_tpu_torch.sampler import Sampler

    sampler = Sampler.create("pred", {})
    sampler.prepare({qid: list(docids)}, task.benchmark.qrels, task.reranker.extractor)
    return sampler


def timed_predict(trainer, reranker, sampler, amp):
    """The trainer's prediction of ``sampler`` with ``trainer.amp`` set to
    ``amp`` (synchronized): (ms, {docid: score}, launches)."""
    trainer.config["amp"] = amp
    before = launch_counts()
    t0 = time.perf_counter()
    preds = trainer.predict(reranker, sampler)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    return ms, next(iter(preds.values())), launched


def optimizer_state_bytes(optimizer):
    return sum(t.numel() * t.element_size() for state in optimizer.state.values() for t in state.values()
               if torch.is_tensor(t) and t.dim() > 0)


def phase_lora(workdir, coll, qids, topic_of, corpus_dir, topics):
    """13a: BERTMaxP at BERT-base width with rank-8 adapters over a seeded
    pretrained checkpoint, trained by the rerank task, its dev.best served in
    f32 and int8."""
    from capreolus_tpu_torch.reranker.bert import get_bert_config

    label = "[13a lora]"
    directory = os.path.join(workdir, "bert_base_pretrained")
    t0 = time.perf_counter()
    write_birch_checkpoint(directory, get_bert_config("bert-base-uncased"), seed=13)
    t_write = time.perf_counter() - t0
    cfg = dict(LORA_TRAIN, pretrained=directory)
    task = rerank_task(cfg, "cuda", name=PHASE13_BENCHMARK, collection=coll, threshold=TRAIN_THRESHOLD)
    reranker, trainer = task.reranker, task.reranker.trainer
    stages = count_stages(trainer, reranker)
    first = task._best_search_run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds = task.rerank_run(first, task.get_results_path())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    c = trainer.config
    steps = c["niters"] * trainer.steps_per_iter
    check(stages["steps"] == steps, f"{label}: {stages['steps']} training steps, expected {steps}")
    sec = stages["seconds"]
    per_iter = (sec["train"] - sec["setup"] - sec["validation"] - sec["checkpoint"]) / c["niters"]
    check(stages["train"]["flash_attention"] == 0, f"{label}: K2 launched inside a training step")
    check(stages["predict"]["flash_attention"] == BERT_LAYERS * stages["forwards"],
          f"{label}: K2 launched {stages['predict']['flash_attention']} times in {stages['forwards']} predictions")
    model, optimizer = trainer._model, trainer._optimizer
    opt_bytes = optimizer_state_bytes(optimizer)
    trainable = sum(p.numel() for group in optimizer.param_groups for p in group["params"])
    # the frozen base after training: bit-identical to the checkpoint read from disk
    pretrained = reranker._pretrained_state
    moved = [k for k, v in model.bert.state_dict().items() if k in pretrained and not torch.equal(v.cpu(), pretrained[k])]
    check(not moved, f"{label}: frozen base weights moved in training: {moved[:3]}")
    adapters = [n for n, p in model.named_parameters() if "_lora." in n]
    check(len(adapters) == 4 * BERT_LAYERS, f"{label}: {len(adapters)} adapter weights")
    batch = training_batch(task, c["batch"])
    step_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(reranker, model, optimizer, batch, steps + i, trainer.step_seed(c["niters"], i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    results = task.get_results_path()
    best_bytes = (results / "dev.best.params").stat().st_size
    full_bytes = sum(p.numel() * 4 for p in model.parameters())
    test_q = qids[sum(TRAIN_SPLIT[:2]):]
    scores = [v for q in test_q for v in preds["test"].get(q, {}).values()]
    check(scores and all(np.isfinite(scores)), f"{label}: a test score is not finite")
    print(f"{label} {steps} steps of {c['batch']} (rank {cfg['lora']}, alpha {cfg['loraalpha']}, base frozen; seeded "
          f"checkpoint written in {t_write:.1f} s): {per_iter:.2f} s per iteration (phase 9b full fine-tune "
          f"{PHASE9B_BERT['s_per_iter']}), step {np.median(step_ms):.2f} ms (median of 3 more steps; 9b "
          f"{PHASE9B_BERT['step_ms']}), peak device memory {peak_gb:.2f} GB (9b {PHASE9B_BERT['peak_gb']}); "
          f"{trainable} trainable weights, optimizer state {opt_bytes / 1e6:.2f} MB (full fine-tune "
          f"{2 * full_bytes / 1e6:.1f} MB); dev.best {best_bytes / 1e6:.3f} MB (a full dump {full_bytes / 1e6:.1f} "
          f"MB); the frozen base bit-identical after training; K2 in steps {stages['train']['flash_attention']}, "
          f"in {stages['forwards']} prediction forwards {stages['predict']['flash_attention']}; test MAP "
          f"{golden_map(preds['test'], task.benchmark.qrels, test_q):.4f}")
    out = {"s_per_iter": per_iter, "step_ms": float(np.median(step_ms)), "peak_gb": peak_gb,
           "optimizer_state_bytes": opt_bytes, "trainable_weights": trainable, "dev_best_bytes": best_bytes,
           "launches_train": stages["train"], "launches_predict": stages["predict"]}
    del task, model, optimizer, trainer
    torch.cuda.empty_cache()

    # the dev.best served: f32, then int8, over phase 5's index and extractor caches
    from capreolus_tpu_torch.core import constants

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_bert")
    serve_cfg = {k: v for k, v in cfg.items() if k not in ("name", "trainer")}
    svc, _, f32 = serve_reranker(f"{label} f32 dev.best", "BERTMaxP", serve_cfg, results / "dev.best", corpus_dir,
                                 topics, LORA_QUERIES)
    check(f32["launches"]["flash_attention"] == BERT_LAYERS * LORA_QUERIES,
          f"{label}: K2 launched {f32['launches']['flash_attention']} times in {LORA_QUERIES} f32 requests")
    served_base = svc.reranker.model.bert.layer_0.attention.query.weight.cpu()
    check(torch.equal(served_base, pretrained["layer_0.attention.query.weight"]),
          f"{label}: the served frozen base is not the pretrained checkpoint's")
    check_no_head_copies(f32["profiled"], BERT_LAYERS, label)
    f32["cpu_err"], _, _ = card_vs_cpu(f"{label} f32", svc, "BERTMaxP", serve_cfg, topics[0], LORA_CPU_DOCS,
                                       BERT_CPU_TOL)
    del svc
    torch.cuda.empty_cache()
    cfg8 = dict(serve_cfg, quantize="int8")
    svc, _, int8 = serve_reranker(f"{label} int8 dev.best", "BERTMaxP", cfg8, results / "dev.best", corpus_dir,
                                  topics, LORA_QUERIES)
    want = {"int8_matmul": X1_PER_REQUEST * LORA_QUERIES, "quantize_per_token": Q1_PER_REQUEST * LORA_QUERIES,
            "flash_attention": BERT_LAYERS * LORA_QUERIES}
    for kernel, n in want.items():
        check(int8["launches"][kernel] == n, f"{label} int8: {kernel} launched {int8['launches'][kernel]} times, "
                                             f"expected {n}")
    int8["layer_err"], int8["head_err"] = int8_layers_card_vs_cpu(f"{label} int8", svc, cfg8, topics[0],
                                                                  LORA_CPU_DOCS)
    del svc
    torch.cuda.empty_cache()
    out.update(f32=f32, int8=int8)
    return out


def int8_layers_card_vs_cpu(label, svc, rr_cfg, query, n_docs):
    """An int8 BERT reranker's layers on query 0's top ``n_docs`` candidates,
    each on the CPU from the card's input to it (INT8_LAYER_TOL), and the head
    from the card's last hidden states (BERT_CPU_TOL), as phase 5b holds them."""
    from capreolus_tpu_torch.reranker import Reranker

    model = svc.reranker.model
    batch = svc.rerank_batch("smoke13_int8", query, served_candidates(svc, query)[:n_docs])
    cfg = json.loads(json.dumps(rr_cfg))
    cfg.setdefault("extractor", {})["index"] = svc.reranker.extractor.config["index"]
    cpu_rr = Reranker.create("BERTMaxP", cfg)
    cpu_model = cpu_rr.build_model().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    seq_len = batch["pos_bert_input"].shape[-1]
    ids, seg, mask = (torch.from_numpy(batch[key].reshape(-1, seq_len)) for key in ("pos_bert_input", "pos_seg",
                                                                                    "pos_mask"))
    doc_mask = torch.from_numpy(batch["pos_mask"])
    layer_err = []
    with torch.inference_mode():
        gpu = svc.reranker.test(batch, svc.device).cpu().numpy()
        keys = mask.bool().cuda()
        hidden = model.bert.embed(ids.cuda(), seg.cuda())
        for i in range(model.config.num_layers):
            out = getattr(model.bert, f"layer_{i}")(hidden, keys)
            layer_err.append(float((out.cpu() - getattr(cpu_model.bert, f"layer_{i}")(hidden.cpu(), keys.cpu())).abs().max()))
            hidden = out
        raw = cpu_model.classifier(torch.tanh(cpu_model.bert.pooler(hidden.cpu()[:, 0])).float())[:, 0]
        head = cpu_rr._head_scores(raw.reshape(doc_mask.shape[:2]), doc_mask).numpy()
    head_err = float(np.abs(gpu - head).max())
    print(f"{label} query 0's top {n_docs} docs, each layer on the CPU from the card's input: max |err| "
          f"{max(layer_err):.3g} (tolerance {INT8_LAYER_TOL}); the head from the card's last layer {head_err:.3g} "
          f"(tolerance {BERT_CPU_TOL})")
    check(max(layer_err) <= INT8_LAYER_TOL and head_err <= BERT_CPU_TOL,
          f"{label}: int8 layers card vs CPU {layer_err}, head {head_err}")
    return max(layer_err), head_err


def hold_k1_bf16(model, batch, label):
    """K1 against its plain version on the frozen KNRM's rows as ``amp``
    hands them over (normalised in bf16, widened): the ten RBF kernels at
    ERR_TOL, the exact-match kernel at K1_EXACT_TOL. Launches after the
    path's counts are read."""
    from capreolus_tpu_torch.ops.simmat import knrm_inputs, knrm_pool, knrm_pool_plain
    from capreolus_tpu_torch.reranker.common import KNRM_SIGMAS
    from capreolus_tpu_torch.trainer.amp import bf16_params

    exact = KNRM_SIGMAS.index(0.001)
    err = {"rbf": 0.0, "exact": 0.0}
    with torch.no_grad(), bf16_params(model):
        check(model.embedding.dtype == torch.bfloat16, f"{label}: the table is not bf16 under amp")
        query = torch.from_numpy(np.asarray(batch["query"])).cuda()
        for side in ("posdoc", "negdoc"):
            args = knrm_inputs(model.embedding, query, torch.from_numpy(np.asarray(batch[side])).cuda(),
                               model.mus, model.sigmas)
            check(bool(torch.equal(args[0], args[0].bfloat16().float())), f"{label}: K1's rows are not bf16 values")
            diff = (knrm_pool(*args) - knrm_pool_plain(*args)).abs()
            err["exact"] = max(err["exact"], float(diff[:, exact].max()))
            diff[:, exact] = 0.0
            err["rbf"] = max(err["rbf"], float(diff.max()))
    print(f"{label} K1 on bf16-normalised rows vs its plain version: RBF kernels {err['rbf']:.3g} (tolerance "
          f"{ERR_TOL}), exact-match kernel {err['exact']:.3g} (tolerance {K1_EXACT_TOL})")
    check(err["rbf"] <= ERR_TOL and err["exact"] <= K1_EXACT_TOL, f"{label}: K1 on bf16 rows differs from plain")
    return err


def phase_amp(workdir, coll, qids, topic_of):
    """13b: trainer.amp: CEDR-KNRM as config_cedrknrm_pt.txt (amp=both), a
    frozen KNRM at phase 9's shape (K1 on bf16 rows), a monoBERT amp=pred
    prediction beside f32."""
    from capreolus_tpu_torch.trainer.amp import bf16_params

    out = {}
    test_q = qids[sum(TRAIN_SPLIT[:2]):]
    label = "[13b cedrknrm amp]"
    cfg = dict(CEDR_RERANKER, name="CEDRKNRM", pretrained="electra-base", allowrandominit=True,
               extractor=dict(CEDR_EXTRACTOR, usecache=True), trainer=dict(CEDR_AMP_TRAINER))
    task = rerank_task(cfg, "cuda", name=PHASE13_BENCHMARK, collection=coll, threshold=TRAIN_THRESHOLD)
    reranker, trainer = task.reranker, task.reranker.trainer
    batches = training_batches(task, CEDR_AMP_TRAINER["batch"], AMP_STEPS)
    # step 1 card vs CPU with dropout off (the two devices' generators draw other masks)
    parity = rerank_task(dict(cfg, hidden_dropout_prob=0.0), "cuda", name=PHASE13_BENCHMARK, collection=coll,
                         threshold=TRAIN_THRESHOLD)
    out["parity"] = step_parity(parity, training_batch(parity, AMP_PARITY_SAMPLES),
                                "CEDR-KNRM electra-base, amp=both, dropout off", prefix=label, amp=True,
                                grad_rtol=AMP_GRAD_RTOL, loss_rtol=AMP_LOSS_RTOL)
    del parity
    check(out["parity"]["launches"]["flash_attention"] == 0, f"{label}: K2 launched inside an amp training step")
    model = reranker.init_params(trainer.config["seed"]).cuda()
    optimizer = trainer.make_optimizer(reranker, model)
    trainer._model, trainer._optimizer = model, optimizer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms, losses = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(reranker, model, optimizer, b, i, trainer.step_seed(0, i))))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and train_launches["flash_attention"] == 0,
          f"{label}: losses {losses}, K2 launches in steps {train_launches['flash_attention']}")
    check(all(p.dtype == torch.float32 and isinstance(p, torch.nn.Parameter) for p in model.parameters()),
          f"{label}: a weight is not an f32 parameter after the amp steps")
    first = task._best_search_run()
    docids = list(first[test_q[0]])[:TRAIN_THRESHOLD]
    sampler = pred_sampler(task, test_q[0], docids)
    timed_predict(trainer, reranker, sampler, "both")  # warm-up; materializes the features
    amp_ms, amp_scores, amp_launches = timed_predict(trainer, reranker, sampler, "both")
    f32_ms, f32_scores, _ = timed_predict(trainer, reranker, sampler, "none")
    layers = model.config.num_layers
    check(amp_launches["flash_attention"] == layers, f"{label}: K2 launched {amp_launches['flash_attention']} "
                                                     f"times in an amp prediction of {len(docids)} docs")
    gap = max(abs(amp_scores[d] - f32_scores[d]) for d in docids)
    check(all(np.isfinite(list(amp_scores.values()))), f"{label}: an amp score is not finite")
    print(f"{label} {AMP_STEPS} steps of {CEDR_AMP_TRAINER['batch']} (4 passages of 225, 13 simmat layers): step "
          f"{np.median(step_ms[1:]):.2f} ms (median of steps 2-{AMP_STEPS}; first {step_ms[0]:.1f}), losses "
          f"{[round(x, 4) for x in losses]}, peak device memory {peak_gb:.2f} GB; a prediction of {len(docids)} docs "
          f"(features cached): amp {amp_ms:.2f} ms, f32 {f32_ms:.2f} ms (phase 12b's f32 request {PHASE12B_CEDR_MS} "
          f"ms with its features), K2 {amp_launches['flash_attention']}; amp vs f32 max |score gap| {gap:.4g}")
    out["cedrknrm"] = {"step_ms": float(np.median(step_ms[1:])), "peak_gb": peak_gb, "predict_ms_amp": amp_ms,
                       "predict_ms_f32": f32_ms, "amp_f32_gap": gap, "launches_predict": amp_launches}
    del task, reranker, trainer, model, optimizer
    torch.cuda.empty_cache()

    label = "[13b knrm amp]"
    cfg = dict(KNRM_TRAIN, trainer=dict(TRAINER_FULL, amp="both"))
    task = rerank_task(cfg, "cuda", name=PHASE13_BENCHMARK, collection=coll, threshold=TRAIN_THRESHOLD)
    stages = count_stages(task.reranker.trainer, task.reranker)
    first = task._best_search_run()
    preds = task.rerank_run(first, task.get_results_path())
    trainer = task.reranker.trainer
    steps = trainer.config["niters"] * trainer.steps_per_iter
    k1, k1_pred = stages["train"]["knrm_pool"], stages["predict"]["knrm_pool"]
    check(k1 == 2 * steps and k1_pred == stages["forwards"],
          f"{label}: K1 launched {k1} times in {steps} amp steps and {k1_pred} in {stages['forwards']} predictions")
    scores = [v for r in preds["test"].values() for v in r.values()]
    check(scores and all(np.isfinite(scores)), f"{label}: a test score is not finite")
    batch = training_batch(task, trainer.config["batch"])
    k1_err = hold_k1_bf16(trainer._model, {k: v[0] for k, v in batch.items()}, label)
    print(f"{label} frozen KNRM (random300, maxdoclen 800) under amp=both: K1 {k1} launches in {steps} steps, "
          f"{k1_pred} in {stages['forwards']} prediction forwards; test MAP "
          f"{golden_map(preds['test'], task.benchmark.qrels, test_q):.4f}")
    out["knrm"] = {"launches_train": k1, "launches_predict": k1_pred, "k1_err": k1_err}
    del task, trainer
    torch.cuda.empty_cache()

    label = "[13b monobert amp=pred]"
    cfg = dict(BERT_TRAIN, trainer=dict(TRAINER_FULL, amp="pred"))
    task = rerank_task(cfg, "cuda", name=PHASE13_BENCHMARK, collection=coll, threshold=TRAIN_THRESHOLD)
    reranker, trainer = task.reranker, task.reranker.trainer
    seeded_init(reranker)
    trainer._model = reranker.init_params(trainer.config["seed"]).cuda()
    first = task._best_search_run()
    docids = list(first[test_q[0]])[:TRAIN_THRESHOLD]
    reranker.extractor.preprocess(qids=[test_q[0]], docids=docids,
                                  topics=task.benchmark.topics[task.benchmark.query_type])
    sampler = pred_sampler(task, test_q[0], docids)
    timed_predict(trainer, reranker, sampler, "pred")  # warm-up; materializes the features
    amp_ms, amp_scores, amp_launches = timed_predict(trainer, reranker, sampler, "pred")
    f32_ms, f32_scores, f32_launches = timed_predict(trainer, reranker, sampler, "none")
    check(amp_launches["flash_attention"] == f32_launches["flash_attention"] == BERT_LAYERS,
          f"{label}: K2 launches {amp_launches['flash_attention']} (amp), {f32_launches['flash_attention']} (f32)")
    gap = max(abs(amp_scores[d] - f32_scores[d]) for d in docids)
    check(gap > 0, f"{label}: the amp scores equal the f32 scores: nothing was rounded")
    with torch.no_grad(), bf16_params(trainer._model):
        dtypes = {p.dtype for p in trainer._model.parameters()}
    print(f"{label} a prediction of {len(docids)} docs (features cached): amp=pred {amp_ms:.2f} ms, f32 "
          f"{f32_ms:.2f} ms; K2 {amp_launches['flash_attention']} each (f32 inputs); amp vs f32 max |score gap| "
          f"{gap:.4g}; the weights under amp: {sorted(map(str, dtypes))}")
    out["monobert_pred"] = {"predict_ms_amp": amp_ms, "predict_ms_f32": f32_ms, "amp_f32_gap": gap,
                            "launches_predict": amp_launches}
    del task, reranker, trainer
    torch.cuda.empty_cache()
    return out


def phase_colbert_training(workdir, coll, qids, corpus_dir, topics, peaks):
    """13c: the colbert reranker trained by the rerank task at BERT-base width,
    its dev.best the checkpointfile of ColbertRetrievalService over the first
    PREFIX_DOCS docs of phase 4's corpus in bf16."""
    from capreolus_tpu_torch.convert import bert_state_dict, load_params
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.ops.maxsim import maxsim_scores_plain
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.reranker.colbert import ColBERTModel
    from capreolus_tpu_torch.searcher import Searcher
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    label = "[13c colbert]"
    task = rerank_task(COLBERT_TRAIN, "cuda", name=PHASE13_BENCHMARK, collection=coll, threshold=TRAIN_THRESHOLD)
    reranker, trainer = task.reranker, task.reranker.trainer
    stages = count_stages(trainer, reranker)
    first = task._best_search_run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds = task.rerank_run(first, task.get_results_path())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    c = trainer.config
    steps = c["niters"] * trainer.steps_per_iter
    sec = stages["seconds"]
    per_iter = (sec["train"] - sec["setup"] - sec["validation"] - sec["checkpoint"]) / c["niters"]
    check(stages["steps"] == steps, f"{label}: {stages['steps']} training steps, expected {steps}")
    check(stages["train"]["maxsim"] == 0 and stages["train"]["flash_attention"] == 0,
          f"{label}: K3 {stages['train']['maxsim']} and K2 {stages['train']['flash_attention']} launches in steps")
    check(stages["predict"]["flash_attention"] == 2 * BERT_LAYERS * stages["forwards"],
          f"{label}: K2 launched {stages['predict']['flash_attention']} times in {stages['forwards']} prediction "
          f"forwards (a query and a doc encoder each)")
    test_q = qids[sum(TRAIN_SPLIT[:2]):]
    scores = [v for q in test_q for v in preds["test"].get(q, {}).values()]
    check(scores and all(np.isfinite(scores)), f"{label}: a test score is not finite")
    ckpt = task.get_results_path() / "dev.best.params"
    print(f"{label} {steps} steps of {c['batch']} (dim {COLBERT['dim']}, maxqlen {COLBERT['maxqlen']}, maxdoclen "
          f"{COLBERT['maxdoclen']}): {per_iter:.2f} s per iteration of {c['itersize']} samples, set-up before the "
          f"first step {sec['setup']:.2f} s, validation {sec['validation']:.2f} s in all, peak device memory "
          f"{peak_gb:.2f} GB; K3 in steps {stages['train']['maxsim']}, K2 in steps {stages['train']['flash_attention']}, "
          f"in {stages['forwards']} prediction forwards {stages['predict']['flash_attention']}; test MAP "
          f"{golden_map(preds['test'], task.benchmark.qrels, test_q):.4f}; dev.best {ckpt.stat().st_size / 1e6:.1f} MB")
    train_out = {"s_per_iter": per_iter, "setup_s": sec["setup"], "peak_gb": peak_gb,
                 "launches_train": stages["train"], "launches_predict": stages["predict"]}
    del task, reranker, trainer
    torch.cuda.empty_cache()

    prefix = {"name": "dummy", "path": corpus_prefix(workdir, corpus_dir)}
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_colbert")
    config = get_bert_config("bert-base-uncased")
    searcher = Searcher.create("colbert", {**COLBERT, "pretrained": "bert-base-uncased", "allowrandominit": True,
                                           "checkpointfile": str(ckpt), "index": {"collection": prefix}})
    t0 = time.perf_counter()
    searcher.index.create_index()
    svc = ColbertRetrievalService(searcher, max_k=100, device="cuda")
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    setup = searcher.setup_seconds
    queries = topics[:COLBERT_QUERIES]
    batch = [topics[i % len(topics)] + " " + topics[(7 * i + 3) % len(topics)].split()[0] for i in range(64)]
    svc.search(topics[COLBERT_QUERIES:COLBERT_QUERIES + 1], k=10)  # warm-up request
    torch.cuda.synchronize()
    reset_launch_counts()
    request_ms, results = [], []
    for query in queries:
        t0 = time.perf_counter()
        results.append(svc.search([query], k=10)[0])
        request_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    batch_results = svc.search(batch, k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    check(launches["maxsim"] == len(queries) + 1 and launches["flash_attention"] == BERT_LAYERS * (len(queries) + 1),
          f"{label}: K3 {launches['maxsim']} and K2 {launches['flash_attention']} launches for {len(queries)} "
          f"requests and one batch")
    check(all(len(h) == 10 and all(np.isfinite(s) for _, s in h) for h in results + batch_results),
          f"{label}: a served request did not return 10 finite scores")
    q0 = searcher.encode_queries(searcher._tokenize(queries[:1], COLBERT["maxqlen"]))
    k3 = k3_measure(q0, *svc._corpus, peaks)
    print(k3_line(f"{label} maxsim on the served corpus with the trained encoder,", k3))

    # query 0's top 10 on the CPU: the trained checkpoint in the port's encoder, plain MaxSim
    cpu_model = ColBERTModel(config, dim=COLBERT["dim"])
    cpu_model.load_state_dict(bert_state_dict(load_params(ckpt)))
    cpu_model.eval()
    docids = [d for d, _ in results[0]]
    with torch.inference_mode():
        cq, _ = cpu_model.encode_query(torch.from_numpy(searcher._tokenize(queries[:1], COLBERT["maxqlen"])))
        texts = [searcher.index.get_doc(d) for d in docids]
        emb, dmask = cpu_model.encode_doc(torch.from_numpy(searcher._tokenize(texts, COLBERT["maxdoclen"])))
    docs_cpu = torch.from_numpy(np.ascontiguousarray(emb.numpy().astype(np.float16).swapaxes(0, 1))).to(torch.bfloat16)
    mask_cpu = dmask.T.contiguous() > 0
    cpu_scores = maxsim_scores_plain(cq, docs_cpu, torch.where(mask_cpu, 0.0, MASKED_BIAS).float(),
                                     mask_cpu.any(dim=0))[0].numpy()
    served = dict(results[0])
    err_cpu = float(max(abs(served[d] - float(s)) for d, s in zip(docids, cpu_scores)))
    check(err_cpu <= COLBERT_CPU_TOL, f"{label}: query 0's top 10 served {[served[d] for d in docids]} vs CPU "
                                      f"{cpu_scores.tolist()}")
    print(f"{label} ColbertRetrievalService(checkpointfile=dev.best.params): set-up {t_service:.1f} s (tokenization "
          f"{setup['tokenize']:.1f} s, encoding {setup['encode']:.1f} s, upload {setup['upload']:.2f} s); per request "
          f"(median of {len(queries)}) {np.median(request_ms):.2f} ms (spread {min(request_ms):.2f}-"
          f"{max(request_ms):.2f}), one 64-query batch {batch_ms:.2f} ms; launches K3 {launches['maxsim']}, K2 "
          f"{launches['flash_attention']}; query 0's top 10 card vs CPU max |err| {err_cpu:.3g} (tolerance "
          f"{COLBERT_CPU_TOL})")
    del svc, searcher, q0
    torch.cuda.empty_cache()
    return {"training": train_out, "service_s": t_service, "setup": dict(setup),
            "request_ms": float(np.median(request_ms)), "request_ms_each": [round(t, 2) for t in request_ms],
            "batch_ms": batch_ms, "launches": launches, "k3": k3, "max_abs_err_cpu": err_cpu}


def phase_trainer_options(workdir, corpus_dir, topics, qrels, peaks):
    """Phase 13: LoRA (13a), trainer.amp (13b) and the trainable ColBERT (13c)."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.core import constants

    capreolus_tpu_torch.load_all_modules()
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")  # phase 4's indexes
    constants["RESULTS_BASE_PATH"] = os.path.join(workdir, "results_phase13")
    t0 = time.perf_counter()
    coll, qids, topic_of = register_phase13_benchmark(workdir, corpus_dir, topics, qrels)
    seconds = {}
    out = {"lora": phase_lora(workdir, coll, qids, topic_of, corpus_dir, topics)}
    seconds["13a"] = round(time.perf_counter() - t0, 1)
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")
    out["amp"] = phase_amp(workdir, coll, qids, topic_of)
    seconds["13b"] = round(time.perf_counter() - t0 - seconds["13a"], 1)
    out["colbert"] = phase_colbert_training(workdir, coll, qids, corpus_dir, topics, peaks)
    seconds["13c"] = round(time.perf_counter() - t0 - seconds["13a"] - seconds["13b"], 1)
    summary = dict(out, seconds=seconds)
    print(f"[13 trainer options] {smi_line()}: every sub-phase passed in {time.perf_counter() - t0:.1f} s; summary "
          + json.dumps(summary, default=str))
    return out


def add_phase13_launches(kernels, p13, k3_fields):
    """Phase 13's launches into the ``kernels`` line: the served runs' (LoRA
    dev.best f32 and int8, the trained ColBERT's service) join each kernel's
    ``launches``; its launches in phase 13's training steps and predictions go
    under ``launches_phase13``; K1 gets its error on bf16 rows, K3 its times
    over the trained encoder's corpus."""
    lora, amp, colbert13 = p13["lora"], p13["amp"], p13["colbert"]
    for entry in kernels:
        name = entry["name"]
        served = lora["f32"]["launches"][name] + lora["int8"]["launches"][name] + colbert13["launches"][name]
        entry["launches"] += served
        entry["launches_phase13"] = {
            "served": served, "lora_f32_served": lora["f32"]["launches"][name],
            "lora_int8_served": lora["int8"]["launches"][name], "colbert_served": colbert13["launches"][name],
            "lora_training_steps": lora["launches_train"][name], "lora_training_predict": lora["launches_predict"][name],
            "colbert_training_steps": colbert13["training"]["launches_train"][name],
            "colbert_training_predict": colbert13["training"]["launches_predict"][name],
            "cedrknrm_amp_predict": amp["cedrknrm"]["launches_predict"][name],
            "monobert_amp_pred_predict": amp["monobert_pred"]["launches_predict"][name]}
    kernels[0]["launches_phase13"].update(knrm_amp_training_steps=amp["knrm"]["launches_train"],
                                          knrm_amp_training_predict=amp["knrm"]["launches_predict"])
    kernels[0]["max_abs_err_phase13_bf16_rows"] = amp["knrm"]["k1_err"]  # RBF kernels and the exact-match kernel
    kernels[2]["phase13_trained_checkpoint"] = {key: colbert13["k3"][key] for key in k3_fields}


# ---------------------------------------------------------------- phase 14: the rest of the reranker zoo
ZOO_WIDTH = {"embeddings": "random300", "maxqlen": 4, "maxdoclen": 800}  # phase 4's served width (GloVe-6B's 300)
ZOO_SERVED = {  # label: (reranker config at the JAX defaults, extractor, served requests after a warm-up)
    "DRMM": ({"name": "DRMM"}, "embedtext", 4),
    "DRMMTKS": ({"name": "DRMMTKS"}, "embedtext", 4),
    "PACRR": ({"name": "PACRR"}, "embedtext", 4),
    "ConvKNRM": ({"name": "ConvKNRM"}, "slowembedtext", 4),
    "CDSSM": ({"name": "CDSSM"}, "slowembedtext", 4),
    "DUET": ({"name": "DUET"}, "slowembedtext", 4),
    "POSITDRMM": ({"name": "POSITDRMM"}, "slowembedtext", 4),
    "TK": ({"name": "TK"}, "slowembedtext", 4),
    "HINT": ({"name": "HINT"}, "slowembedtext", 4),
    "HINT_windowed": ({"name": "HINT", "mode": "windowed"}, "slowembedtext", 1),
    "DSSM": ({"name": "DSSM"}, "bagofwords", 4),
    "DeepTileBar": ({"name": "DeepTileBar"}, "deeptiles", 4),
}
ZOO_RECURRENT = ("POSITDRMM", "TK", "HINT", "HINT_windowed", "DeepTileBar")
ZOO_RECURRENT_TOL = 1e-3  # card vs CPU for the recurrent models and TK: a GRU over 800 positions (POSITDRMM), the
# 2-D GRU's 2 x 103 dependent steps a window (HINT), TK's softmax over 800 keys: f32 sums in other orders carried
# through each step; the feed-forward models at ERR_TOL, as KNRM
TFKNRM_FROZEN = {"name": "TFKNRM", "gradkernels": False, "finetune": False}
ZOO_STEP_BATCH = 8  # 14c's step-1 batch, card vs CPU
ZOO_REFEREE64 = ("CDSSM",)  # 14c's models held to f32's own accuracy (step_parity's referee64): CDSSM's towers
# meet at a cosine of +-1 to 1e-4 at init, so its CPU f32 gradient is itself further than STEP_RTOL from f64's
ZOO_ZERO_UNK_SHARE = 0.7  # share of the corpus's terms the pretrained table of 14a's zerounk batch holds
ZOO_GOLDEN = {  # 14c's rerank.traineval runs on phase 9a's rerank golden (its KNRM width and schedule)
    "TFKNRM": dict(TFKNRM_FROZEN, extractor=RERANK_GOLDEN_CONFIGS["KNRM"]["extractor"],
                   trainer=RERANK_GOLDEN_CONFIGS["KNRM"]["trainer"]),
    "POSITDRMM": {"name": "POSITDRMM", "extractor": RERANK_GOLDEN_CONFIGS["KNRM"]["extractor"],
                  "trainer": dict(RERANK_GOLDEN_CONFIGS["KNRM"]["trainer"], lr=1e-3, bertlr=1e-3)},
}


def zoo_config(label):
    """``ZOO_SERVED[label]``'s reranker config with its extractor at phase 4's width."""
    cfg, extractor, _ = ZOO_SERVED.get(label, (TFKNRM_FROZEN, "slowembedtext", 0))
    cfg = json.loads(json.dumps(cfg))
    width = {"maxqlen": ZOO_WIDTH["maxqlen"]} if extractor == "bagofwords" else dict(ZOO_WIDTH)
    cfg["extractor"] = dict(width, name=extractor)
    return cfg


def zoo_card_vs_cpu(label, svc, query, tol):
    """Query 0's ``topn`` first-stage candidates scored on the card and, with
    the card's weights and extractor state, on the CPU. Returns (max |err|, the batch)."""
    from capreolus_tpu_torch.reranker import Reranker

    batch = served_batch(svc, query, "smoke14")
    cfg = zoo_config(label)
    cfg["extractor"]["index"] = svc.reranker.extractor.config["index"]
    cpu_rr = Reranker.create(cfg.pop("name"), cfg)
    cpu_rr.extractor.set_state(svc.reranker.extractor.get_state())
    cpu_rr.build_model().load_state_dict({k: v.cpu() for k, v in svc.reranker.model.state_dict().items()})
    cpu_rr.model.eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        gpu = svc.reranker.test(batch, svc.device).cpu().numpy()
        cpu = cpu_rr.test(batch, "cpu").numpy()
    err = float(np.abs(gpu - cpu).max())
    print(f"[14 zoo] {label}: query 0's {len(gpu)} candidates, card vs CPU ({time.perf_counter() - t0:.1f} s with "
          f"the CPU): max |err| {err:.3g} (tolerance {tol}{'; DRMM is held layer by layer' if label == 'DRMM' else ''})")
    check(np.isfinite(gpu).all(), f"{label}: a card score is not finite")
    if label == "DRMM":
        return drmm_layers_card_vs_cpu(svc, cpu_rr, batch, tol), batch
    check(err <= tol, f"{label}: card scores vs CPU: max |err| {err:.3g} > {tol}")
    return err, batch


def drmm_layers_card_vs_cpu(svc, cpu_rr, batch, tol):
    """DRMM card vs CPU layer by layer from the card's input to each layer: its
    histograms are a step function of the similarities (a self-similarity an
    ulp either side of the last edge, 1.0, moves a count), as an int8 layer is
    of its input. The similarity matrices within 1e-5; the counts of the
    card's similarities on the CPU equal to the card's exactly, and their
    ``histType`` transform (a log for LCH) within 1e-6; the scores from the
    card's histograms at ``tol``; the query terms whose counts differ between
    the devices' own similarities are reported. Returns the score error from
    the card's histograms."""
    from capreolus_tpu_torch.reranker.common import similarity_matrix
    from capreolus_tpu_torch.reranker.interaction import matching_histogram

    gpu_m, cpu_m = svc.reranker.model, cpu_rr.model
    q, d, idf = (torch.from_numpy(np.asarray(batch[k])) for k in ("query", "posdoc", "query_idf"))
    d_mask = (d != 0).float()
    with torch.inference_mode():
        sim_gpu = similarity_matrix(gpu_m.embedding, q.cuda(), d.cuda())
        sim_cpu = similarity_matrix(cpu_m.embedding, q, d)
        sim_err = float((sim_gpu.cpu() - sim_cpu).abs().max())
        counts_gpu = matching_histogram(sim_gpu, d_mask.cuda(), gpu_m.nbins, "CH").cpu()
        same = bool(torch.equal(matching_histogram(sim_gpu.cpu(), d_mask, cpu_m.nbins, "CH"), counts_gpu))
        moved = int((matching_histogram(sim_cpu, d_mask, cpu_m.nbins, "CH") != counts_gpu).any(dim=-1).sum())
        hist_gpu = gpu_m.histograms(q.cuda(), d.cuda())
        hist_err = float((matching_histogram(sim_gpu.cpu(), d_mask, cpu_m.nbins, cpu_m.hist_type)
                          - hist_gpu.cpu()).abs().max())
        score_err = float((gpu_m.score_histograms(hist_gpu, q.cuda(), idf.cuda()).cpu()
                           - cpu_m.score_histograms(hist_gpu.cpu(), q, idf)).abs().max())
    print(f"[14 zoo] DRMM layer by layer: similarities card vs CPU {sim_err:.3g} (tolerance 1e-5); counts of the "
          f"card's similarities on the CPU {'equal' if same else 'NOT equal'} to the card's, their {cpu_m.hist_type} "
          f"transform {hist_err:.3g} (tolerance 1e-6); scores from the card's histograms {score_err:.3g} (tolerance "
          f"{tol}); {moved} of {q.shape[0] * q.shape[1]} query terms' counts differ between the devices' own "
          f"similarities")
    check(sim_err <= 1e-5 and same and hist_err <= 1e-6 and score_err <= tol,
          "DRMM: a layer differs between the card and the CPU")
    return score_err


def zoo_zerounk_batch(coll, query, docids, seed=14):
    """14a's ``zerounk=True`` batch: a pretrained table of GloVe-6B's width
    over ``ZOO_ZERO_UNK_SHARE`` of the terms of ``docids`` and ``query``,
    written to the cache, and a ``slowembedtext`` extractor with ``zerounk``
    over it, so that the other terms take the pad id 0 inside documents.
    Returns (the extractor, the collated batch of the query over ``docids``)."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.extractor import Extractor
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    ext = Extractor.create("slowembedtext", dict(ZOO_WIDTH, embeddings="glove6b", zerounk=True,
                                                 index={"collection": coll}))
    ext.index.create_index()
    terms = sorted({t for d in docids for t in ext.tokenizer.tokenize(ext.index.get_doc(d))}
                   | set(ext.tokenizer.tokenize(query)))
    rng = np.random.Generator(np.random.PCG64(seed))
    kept = [t for t in terms if rng.random() < ZOO_ZERO_UNK_SHARE]
    emb_dir = os.path.join(constants["CACHE_BASE_PATH"], "embeddings")
    os.makedirs(emb_dir, exist_ok=True)
    np.save(os.path.join(emb_dir, "glove6b.npy"), rng.standard_normal((len(kept), 300), dtype=np.float32))
    with open(os.path.join(emb_dir, "glove6b.vocab.txt"), "wt", encoding="utf-8") as fh:
        fh.write("\n".join(kept) + "\n")
    ext.preprocess(["zq"], list(docids), {"zq": query})
    batch = collate([ext.id2vec("zq", d, label=[1, 0], training=False) for d in docids], ARRAY_KEYS)
    return ext, batch


def phase_zoo_serving(workdir, corpus_dir, topics, held):
    """14a and 14b: frozen TFKNRM (K1) and every other zoo model served on the
    card over phase 4's corpus and indexes, each extractor preprocessed once
    and handed to every service that reads it; cuDNN's TF32 flag left at
    PyTorch's default (True) throughout, so the package must keep its
    convolutions and recurrences in f32 on its own."""
    from capreolus_tpu_torch.convert import flax_flat_params, save_params
    from capreolus_tpu_torch.extractor import Extractor
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RetrievalService

    coll = {"name": "dummy", "path": corpus_dir}
    out = {}
    t0 = time.perf_counter()
    # phase 4's embedtext state (its cache hit) serves embedtext and slowembedtext alike: the same features
    ext = Extractor.create("embedtext", dict(ZOO_WIDTH, index={"collection": coll}))
    ext.index.create_index()
    ext.preprocess([], list(ext.index.data.docid_strings), {})
    t_embed = time.perf_counter() - t0
    t0 = time.perf_counter()
    bow = Extractor.create("bagofwords", {"maxqlen": 4, "index": {"collection": coll}})
    bow.preprocess([], list(ext.index.data.docid_strings), {})
    t_bow = time.perf_counter() - t0
    # deeptiles: TextTiling is host Python, so only the served queries' first-stage candidates are tiled
    t0 = time.perf_counter()
    first = RetrievalService(ext.index, device="cuda")
    n_tiled = max(n for _, _, n in ZOO_SERVED.values())
    served = topics[:n_tiled] + topics[PHASE12_WARMUP:PHASE12_WARMUP + 1]
    cands = sorted({d for hits in first.search(served, k=100) for d, _ in hits})
    tiles = Extractor.create("deeptiles", dict(ZOO_WIDTH, usecache=False, index={"collection": coll}))
    tiles.preprocess([], cands, {})
    t_tiles = time.perf_counter() - t0
    shared = {"embedtext": ext, "slowembedtext": ext, "bagofwords": bow, "deeptiles": tiles}
    print(f"[14 zoo] extractors: embedtext state {t_embed:.1f} s (phase 4's, {len(ext.docid2toks)} docs), "
          f"bagofwords {t_bow:.1f} s ({bow.feature_dim} features), deeptiles {t_tiles:.1f} s ({len(cands)} docs: "
          f"the union of {len(served)} queries' top 100, not the corpus)")
    out["extractor_s"] = {"embedtext": t_embed, "bagofwords": t_bow, "deeptiles": t_tiles, "deeptiles_docs": len(cands)}

    for label in ["TFKNRM"] + list(ZOO_SERVED):
        cfg = zoo_config(label)
        name = cfg.pop("name")
        cfg["extractor"]["index"] = {"collection": coll}
        reranker = Reranker.create(name, cfg)
        # the extractor's state handed over in memory (a service restores it, preprocessed, as it would a file)
        reranker.extractor.set_state(shared[cfg["extractor"]["name"]].get_state())
        ckpt = save_params(flax_flat_params(reranker.init_params(14)), os.path.join(workdir, "zoo", f"{label}.npz"))
        n_queries = 4 if label == "TFKNRM" else ZOO_SERVED[label][2]
        svc, results, summary = serve_reranker(f"[14 zoo] {label}", name, cfg, ckpt, corpus_dir, topics, n_queries,
                                               reranker=reranker)
        k1 = summary["launches"]["knrm_pool"]
        if label == "TFKNRM":
            check(k1 == n_queries, f"TFKNRM: K1 launched {k1} times in {n_queries} requests, not once a request")
        else:
            check(k1 == 0, f"{label}: K1 launched {k1} times")
        tol = ZOO_RECURRENT_TOL if label in ZOO_RECURRENT else ERR_TOL
        summary["cpu_err"], batch = zoo_card_vs_cpu(label, svc, topics[0], tol)
        summary["cpu_tol"] = tol
        if label == "TFKNRM":
            summary["k1_err_served"] = hold_k1(svc.reranker.model, batch, ("posdoc",), "a served TFKNRM batch", held)
            docids = served_candidates(svc, topics[0])
            zext, zbatch = zoo_zerounk_batch(coll, topics[0], docids)
            posdoc = zbatch["posdoc"]
            inside = int(sum(((row[:np.nonzero(row)[0].max() + 1] == 0).sum() if row.any() else 0) for row in posdoc))
            check(posdoc.min() == 0 and inside > 0, "the zerounk batch has no pad id inside a document")
            zrr = Reranker.create("TFKNRM", {**TFKNRM_FROZEN, "extractor": dict(ZOO_WIDTH, embeddings="glove6b",
                                                                                  zerounk=True)})
            zrr.extractor = zext
            zmodel = zrr.init_params(14).cuda().eval()
            summary["k1_err_zerounk"] = hold_k1(zmodel, zbatch, ("posdoc",),
                                                f"a zerounk batch ({inside} pad ids inside its documents)", held)
            summary["zerounk_pads_inside"] = inside
        out[label] = summary
        del svc
        torch.cuda.empty_cache()
    return out, shared


def phase_zoo_training(workdir, corpus_dir, topics, held, shared):
    """14c: step 1 of each zoo model on one batch of ``ZOO_STEP_BATCH`` at full
    width, card vs CPU from one init with dropout off; frozen TFKNRM (K1 twice
    a step) and POSITDRMM through rerank.traineval on phase 9a's rerank golden."""
    from types import SimpleNamespace

    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.reranker.common import KNRM_SIGMAS
    from capreolus_tpu_torch.serving import RetrievalService
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    coll = {"name": "dummy", "path": corpus_dir}
    out = {"parity": {}}
    exact = [KNRM_SIGMAS.index(0.001)]
    docids = None
    for label in ["TFKNRM"] + [lab for lab in ZOO_SERVED if lab != "HINT_windowed"] + ["HINT_windowed"]:
        cfg = zoo_config(label)
        name = cfg.pop("name")
        cfg["extractor"]["index"] = {"collection": coll}
        cfg["trainer"] = {"batch": ZOO_STEP_BATCH}
        reranker = Reranker.create(name, cfg)
        reranker.extractor.set_state(shared[cfg["extractor"]["name"]].get_state())
        if docids is None:  # the served candidates of query 0: pairs of its top 16 (pos) and next 16 (neg)
            first = RetrievalService(reranker.extractor.index, device="cuda")
            docids = [d for d, _ in first.search(topics[:1], k=2 * ZOO_STEP_BATCH)[0]]
        reranker.extractor.qid2toks["zq"] = reranker.extractor.tokenizer.tokenize(topics[0])
        if hasattr(reranker.extractor, "idf"):
            for tok in reranker.extractor.qid2toks["zq"]:
                reranker.extractor.idf.setdefault(tok, reranker.extractor.index.get_idf(tok))
        samples = [reranker.extractor.id2vec("zq", docids[i], docids[ZOO_STEP_BATCH + i], label=[1, 0])
                   for i in range(ZOO_STEP_BATCH)]
        batch = {k: v[None] for k, v in collate(samples, ARRAY_KEYS).items()}
        gradkernels = reranker.config.get("gradkernels", False)
        exclude = {"mus": exact, "sigmas": exact} if gradkernels else None
        # per use: the pairwise loss subtracts the negative's gradient from the positive's, and where the
        # two nearly cancel (DRMMTKS's mlp bias, alike for both docs) the difference keeps their rounding
        out["parity"][label] = step_parity(SimpleNamespace(reranker=reranker), batch, label, exclude=exclude,
                                           prefix="[14c parity]", dropout=False, per_use=True,
                                           referee64=label in ZOO_REFEREE64)
        expected = 2 if label == "TFKNRM" else 0
        check(out["parity"][label]["launches"]["knrm_pool"] == expected,
              f"{label}: K1 launched {out['parity'][label]['launches']['knrm_pool']} times in a step, not {expected}")

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rerank_golden")  # phase 9a's golden and caches
    constants["RESULTS_BASE_PATH"] = os.path.join(workdir, "results_rerank_golden_14")
    golden_topics, golden_qrels = rerank_golden_corpus()[1:]
    qids = sorted(golden_topics)
    test_q = qids[sum(RERANK_GOLDEN["split"][:2]):]
    for name, cfg in ZOO_GOLDEN.items():
        t0 = time.perf_counter()
        reset_launch_counts()
        task = rerank_task(cfg, "cuda")
        stages = count_stages(task.reranker.trainer, task.reranker)
        first_stage = task._best_search_run()
        preds = task.rerank_run(first_stage, task.get_results_path())
        fs_map, test_map = golden_map(first_stage, golden_qrels, test_q), golden_map(preds["test"], golden_qrels, test_q)
        check(all(np.isfinite(v) for r in preds["test"].values() for v in r.values()), f"{name}: a score is not finite")
        entry = {"first_stage_map": fs_map, "test_map": test_map, "steps": stages["steps"],
                 "launches_train": stages["train"]["knrm_pool"], "launches_predict": stages["predict"]["knrm_pool"],
                 "forwards_predict": stages["forwards"], "seconds": time.perf_counter() - t0}
        if name == "TFKNRM":
            check(entry["launches_train"] == 2 * stages["steps"],
                  f"TFKNRM: K1 launched {entry['launches_train']} times in {stages['steps']} steps, not twice a step")
            check(entry["launches_predict"] == stages["forwards"], "TFKNRM: K1 did not launch once a prediction forward")
            entry["k1_err_predict"] = hold_k1(task.reranker.model, stages["first_predict_batch"], ("posdoc",),
                                              "TFKNRM's first prediction batch", held)
        else:
            check(entry["launches_train"] == entry["launches_predict"] == 0, "POSITDRMM launched K1")
        print(f"[14c golden] {name} through rerank.traineval on the card: {stages['steps']} steps, first stage "
              f"{fs_map:.4f} -> test MAP {test_map:.4f} (no pin: the JAX package has none); K1 launches in steps "
              f"{entry['launches_train']}, in {stages['forwards']} prediction forwards {entry['launches_predict']}; "
              f"{entry['seconds']:.1f} s")
        out[name] = entry
    return out


def phase_zoo(workdir, corpus_dir, topics):
    """Phase 14: the rest of the reranker zoo on the card, served (14a, 14b)
    and trained (14c). Returns the summary, with K1's launches and errors."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.core import constants

    capreolus_tpu_torch.load_all_modules()
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")  # phase 4's indexes and extractor state
    constants["RESULTS_BASE_PATH"] = os.path.join(workdir, "results_zoo")
    os.makedirs(os.path.join(workdir, "zoo"), exist_ok=True)
    t0 = time.perf_counter()
    held = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the zoo's forwards must not rely on phase 1's False
    try:
        served, shared = phase_zoo_serving(workdir, corpus_dir, topics, held)
        check(torch.backends.cudnn.allow_tf32 is True, "a zoo forward left cuDNN's TF32 flag changed")
        training = phase_zoo_training(workdir, corpus_dir, topics, held, shared)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    summary = {"served": {k: ({kk: vv for kk, vv in v.items() if kk != "profiled"} if isinstance(v, dict) else v)
                          for k, v in served.items()},
               "profiled": {k: v["profiled"] for k, v in served.items() if isinstance(v, dict) and "profiled" in v},
               "training": training, "k1_max_abs_err": held.get("knrm_pool"), "seconds": time.perf_counter() - t0}
    print(f"[14 zoo] {smi_line()}: every sub-phase passed in {summary['seconds']:.1f} s; summary "
          + json.dumps(summary, default=str))
    return summary


def add_phase14_launches(kernels, p14):
    """Phase 14's K1 launches and errors into the ``kernels`` line: the served
    TFKNRM's requests join K1's ``launches``; its training steps, predictions
    and parity step go under ``launches_phase14`` (every other kernel: 0)."""
    served = {label: entry["launches"] for label, entry in p14["served"].items() if isinstance(entry, dict)
              and "launches" in entry}
    for entry in kernels:
        name = entry["name"]
        total = sum(launches[name] for launches in served.values())
        entry["launches"] += total
        entry["launches_phase14"] = {"served": total, "served_by_model": {k: v[name] for k, v in served.items()}}
    k1 = kernels[0]["launches_phase14"]
    training = p14["training"]
    k1.update(tfknrm_training_steps=training["TFKNRM"]["launches_train"],
              tfknrm_training_predict=training["TFKNRM"]["launches_predict"],
              parity_steps={k: v["launches"]["knrm_pool"] for k, v in training["parity"].items()})
    kernels[0]["max_abs_err_phase14"] = {"served": p14["served"]["TFKNRM"]["k1_err_served"],
                                         "served_zerounk": p14["served"]["TFKNRM"]["k1_err_zerounk"],
                                         "training_predict": training["TFKNRM"]["k1_err_predict"]}


# ---------------------------------------------------------------- phase 15: dense and learned-sparse retrieval
DENSE_ENGINES = {  # 15a's engines over phase 4's corpus at the dense searcher's defaults (maxdoclen 256, maxqlen
    # 32, batch 128, hits 1000, mean pooling), one embedding cache shared by all
    "bf16": {}, "int8": {"quantize": "int8"}, "int4": {"quantize": "int4", "rescore": 200},
    "ivf_nprobe8": {"clusters": 128, "nprobe": 8}, "ivf_nprobe128": {"clusters": 128, "nprobe": 128},
    "streamed": {"hbmbudget": "chunks"}, "prf": {"prf": 10},
}
DENSE_STREAM_CHUNKS = 4  # the streamed engine's budget holds two chunks of 1/DENSE_STREAM_CHUNKS of the corpus
DENSE_QUERIES = 8  # single-query requests per engine, after a warm-up
DENSE_BATCH = 128  # one full query batch (the searcher's ``batch``) per engine
DENSE_HITS = 1000
DENSE_SCORE_TOL = 1e-5  # engines over one embedding matrix, card vs CPU: bf16 products in f32 (and int8 epilogues)
# summed in other orders
SCALE = {"docs": 1_000_000, "dim": 768, "centres": 4096, "noise": 0.35, "queries": 128, "hits": 1000, "seed": 15}
SCALE_ENGINES = {  # 15b's engines over the synthetic 1M x 768 matrix (MS MARCO passage's width, cut from 8.8M rows)
    "bf16": {}, "int8": {"quantize": "int8"}, "int4": {"quantize": "int4", "rescore": 200},
    "ivf_nprobe8": {"clusters": 1024, "nprobe": 8}, "ivf_nprobe32": {"clusters": 1024, "nprobe": 32},
    "streamed": {"hbmbudget": "chunks"},
}
IMPACT_QUERIES = 8
IMPACT_RAW_TOL = 1e-3  # raw impacts of 8 docs, card vs CPU, against the largest: 12 f32 BERT-base layers (BERT_CPU_TOL)
IMPACT_SCORE_RTOL = SPARSE_RTOL  # one CSR and one query on both devices: the sparse engine's contract
HYBRID_DEPTH = 100
TRAIN15 = {"batch": 4, "parity_samples": 2, "maxqlen": 32, "maxdoclen": 128, "steps": 8}  # 15e's BERT-base steps
# (card vs CPU on step 1 over the batch's first parity_samples samples)
SPLADE_TIE_RTOL = 1e-4  # 15e: a term whose two best positions' SPLADE weights are this close (relative to the
# largest weight) may take its max at either position on the card and on the CPU
TRAIN15_MODELS = {"biencoder": {"trainer": {"loss": "infonce"}}, "unicoil": {}, "splade": {"regweight": 1e-3}}
GOLDEN15_TRAINER = dict(RERANK_GOLDEN_CONFIGS["BERTMaxP"]["trainer"], niters=2)  # phase 9a's rates, 2 iterations
# uniCOIL's tiny loop trains from the port's init at this trainer seed, with dropout 0 (the card's dropout draws
# are not the CPU's): at the default seed 42 its ReLU token weights all die in training, in the JAX package as in
# the port from the same init, and nothing is indexed; from seed 53's init (the port's or JAX's) both train
# (tests/torch_unicoil_init_witness.py)
GOLDEN15_UNICOIL_SEED = 53
GOLDEN15 = {  # 15e's tiny train-then-serve loops on phase 9a's rerank golden (its tiny BERT width)
    "biencoder": ({"name": "biencoder", "pretrained": "tiny", "allowrandominit": True,
                   "extractor": {"maxqlen": 8, "maxdoclen": 96},
                   "trainer": dict(GOLDEN15_TRAINER, loss="infonce")},
                  {"name": "dense", "pretrained": "tiny", "maxqlen": 8, "maxdoclen": 96, "batch": 64}),
    "unicoil": ({"name": "unicoil", "pretrained": "tiny", "allowrandominit": True, "hidden_dropout_prob": 0.0,
                 "extractor": {"maxqlen": 8, "maxdoclen": 96},
                 "trainer": dict(GOLDEN15_TRAINER, seed=GOLDEN15_UNICOIL_SEED)},
                {"name": "impact", "pretrained": "tiny", "maxqlen": 8, "maxdoclen": 96, "batch": 64}),
}


class SyntheticDenseIndex:
    """The index of a corpus that exists only as its embedding matrix (15b):
    docids, and the directory the dense searcher keys its caches under."""

    def __init__(self, n, cache_path):
        from types import SimpleNamespace

        self.data = SimpleNamespace(docid_strings=[f"s{i}" for i in range(n)])
        self.cache_path = Path(cache_path)

    def create_index(self):
        pass

    def get_cache_path(self):
        return self.cache_path


def dense_searcher(options, device, index=None, encoder_of=None):
    """A dense searcher on ``device``; ``encoder_of`` hands it another dense
    searcher's loaded encoder (an engine of the same weights needs no second
    load: the encoder only embeds, and keys the cache)."""
    from capreolus_tpu_torch.searcher import Searcher

    searcher = Searcher.create("dense", json.loads(json.dumps(options)))
    searcher.device = device
    if index is not None:
        searcher.index = index
    if encoder_of is not None:
        searcher._enc, searcher._random_init = encoder_of._encoder(), encoder_of._random_init
    return searcher


def stream_budget_mb(n, dim, qmode):
    """An hbmbudget (MB) that streams an n x dim corpus in DENSE_STREAM_CHUNKS chunks."""
    row = {"int8": dim + 4, "int4": (dim + dim % 2) // 2 + 4}.get(qmode, 2 * dim)
    return 2 * row * (-(-n // DENSE_STREAM_CHUNKS)) / 1e6


def timed_requests(svc, queries, k=10):
    """(median ms, [min, max] ms) of single-query requests after a warm-up;
    each ends with its hits on the host."""
    svc.search(queries[:1], k=k)
    times = []
    for q in queries:
        t0 = time.perf_counter()
        svc.search([q], k=k)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), [float(min(times)), float(max(times))]


def hold_k2_layer0(encoder, encode, label, errs):
    """K2 against ``attention_plain`` at layer 0 of one encoder forward
    (``encode()``), on the q, k, v and mask it hands K2; the error by
    sequence length into ``errs``. These launches come after the path's counts."""
    attention = getattr(encoder, "layer_0").attention

    def hold(module, args):
        q, k, v = module.heads(args[0])
        key = f"L{q.shape[2]}"
        errs[key] = max(errs.get(key, 0.0), k2_error(q, k, v, args[1])[0])

    hook = attention.register_forward_pre_hook(hold)
    try:
        encode()
    finally:
        hook.remove()
    print(f"[15 K2] {label}: layer 0 max |kernel - plain| {errs} (tolerance {K2_TOL[torch.float32]})")


def hits_of(scores, ords, docids, n):
    s, o = scores.float().cpu().numpy(), ords.cpu().numpy()
    return [[(docids[int(j)], float(v)) for v, j in zip(s[i], o[i]) if int(j) < n and np.isfinite(v)]
            for i in range(len(s))]


def phase_dense_serving(workdir, corpus_dir, topics, peaks, ckpt_dir):
    """15a: DenseRetrievalService at BERT-base width over phase 4's corpus,
    every engine from one embedding cache; K2 and X1 held against plain on
    served inputs; each engine card vs CPU over the card's own matrix."""
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    from capreolus_tpu_torch.ops.quantization import quantize_rows_torch
    from capreolus_tpu_torch.serving import DenseRetrievalService

    queries = list(topics[:DENSE_QUERIES])
    batch_queries = [topics[i % len(topics)] for i in range(DENSE_BATCH)]
    out, services, k2_errs = {"engines": {}}, {}, {}
    q_cpu, exact_hits = None, None
    for label, opts in DENSE_ENGINES.items():
        opts = dict(opts)
        if opts.get("hbmbudget") == "chunks":
            opts["hbmbudget"] = stream_budget_mb(SERVING_DOCS, 768, "none")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if "dense" not in services:
            svc = DenseRetrievalService.from_config(collection="dummy", collection_path=corpus_dir, max_k=DENSE_HITS,
                                                    device="cuda", pretrained=ckpt_dir, **opts)
        else:  # the next engines over the first one's encoder
            first = services["dense"].searcher
            svc = DenseRetrievalService(dense_searcher(dict(first.config, **opts), "cuda", encoder_of=first),
                                        max_k=DENSE_HITS, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        searcher = svc.searcher
        reset_launch_counts()
        single_ms, spread = timed_requests(svc, queries)
        t0 = time.perf_counter()
        batch_hits = svc.search(batch_queries, k=DENSE_HITS)
        batch_ms = (time.perf_counter() - t0) * 1e3
        launched = launch_counts()
        batches = 1 + len(queries) + 1  # warm-up, singles, the batch
        check(launched["flash_attention"] == 12 * batches,
              f"15a {label}: K2 launched {launched['flash_attention']} times, not 12 per query batch ({batches})")
        quantized = "quantize" in opts
        check((launched["int8_matmul"] >= batches) if quantized else launched["int8_matmul"] == 0,
              f"15a {label}: X1 launched {launched['int8_matmul']} times over {batches} query batches")
        probed_all = opts.get("nprobe", 0) == opts.get("clusters", 0)  # IVF with fewer cells holds fewer docs
        check(not probed_all or all(len(h) == DENSE_HITS for h in batch_hits),
              f"15a {label}: a batch request returned fewer hits than {DENSE_HITS}")
        profiled = profile_call(lambda: svc.search(queries[:1], k=10), f"[15a dense {label}]")
        entry = {"setup_s": setup_s, "setup_parts_s": dict(searcher.setup_seconds), "single_ms": single_ms,
                 "single_spread_ms": spread, "batch128_ms": batch_ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "busy_share": profiled["busy_ms"] / profiled["wall_ms"], "top_ops": profiled["top_ops"],
                 "launches": launched}
        if label == "bf16":  # K2 on a served layer-0 doc batch (L 256) and query batch (L 32)
            encoder = searcher._encoder()
            index = searcher.index
            doc_texts = [index.get_doc(d) for d in index.data.docid_strings[:DENSE_BATCH]]
            hold_k2_layer0(encoder, lambda: searcher.encode(*searcher._tokenize(doc_texts, 256)), "doc batch", k2_errs)
            hold_k2_layer0(encoder, lambda: searcher.embed_queries(batch_queries), "query batch", k2_errs)
            # card vs CPU embeddings of query 0 and 8 docs, from one checkpoint
            cpu = dense_searcher({"pretrained": ckpt_dir}, "cpu", index)
            for what, texts, maxlen in (("query 0", queries[:1], 32), ("8 docs", doc_texts[:8], 256)):
                inp, mask = searcher._tokenize(texts, maxlen)
                err = float((searcher.encode(inp, mask).cpu() - cpu.encode(inp, mask)).abs().max())
                check(err <= BERT_CPU_TOL, f"15a embeddings of {what}: card vs CPU {err:.3g} > {BERT_CPU_TOL}")
                entry[f"embedding_err_{what.replace(' ', '_')}"] = err
        if label == "int8":  # X1 against plain on the served product: the batch's codes x the corpus codes
            codes = quantize_rows_torch(searcher.embed_queries(batch_queries))[0]
            corpus = svc._corpus[0]["emb"]
            entry["x1_equal_plain"] = bool(torch.equal(int8_matmul(codes, corpus), int8_matmul_plain(codes, corpus)))
            check(entry["x1_equal_plain"], "15a int8: X1 differs from its plain version on the served product")
        # the engine card vs CPU, over the card's own embedding matrix (the CPU searcher reads the card's cache,
        # and IVF its layout), for the card's query embeddings
        q = searcher.embed_queries(queries)
        if q_cpu is None:
            q_cpu = q.cpu()
        cpu = dense_searcher(dict(searcher.config), "cpu", encoder_of=searcher)
        ctopk, cdocs, n = cpu.build_topk(DENSE_HITS)
        docids = searcher.index.data.docid_strings
        if "prf" in opts:
            card = hits_of(*svc._topk(searcher._prf_expand(q, svc._topk, *svc._corpus), *svc._corpus), docids, n)
            on_cpu = hits_of(*ctopk(cpu._prf_expand(q_cpu, ctopk, cdocs), cdocs), docids, n)
        else:
            card = hits_of(*svc._topk(q, *svc._corpus), docids, n)
            on_cpu = hits_of(*ctopk(q_cpu, cdocs), docids, n)
        faults = [f for a, b in zip(card, on_cpu) for f in ranking_faults(a, b, DENSE_SCORE_TOL)]
        check(not faults and all(len(a) == len(b) for a, b in zip(card, on_cpu)),
              f"15a {label}: card vs CPU top {DENSE_HITS} differ beyond near-ties: {faults[:3]}")
        entry["card_vs_cpu_max_err"] = max(abs(s - dict(b)[d]) for a, b in zip(card, on_cpu) for d, s in a
                                           if d in dict(b))
        if label == "bf16":
            exact_hits, exact_raw = card, svc._topk(q, *svc._corpus)
        elif label == "streamed":
            got = svc._topk(q, *svc._corpus)
            entry["equal_resident_bits"] = bool(torch.equal(got[0], exact_raw[0]) and torch.equal(got[1], exact_raw[1]))
            entry["chunks"] = searcher.stream_chunks
            check(entry["equal_resident_bits"] and searcher.stream_chunks >= DENSE_STREAM_CHUNKS,
                  f"15a streamed: not bit-identical to the resident engine ({searcher.stream_chunks} chunks)")
        elif label.startswith("ivf"):
            recall = {}
            for depth in (10, DENSE_HITS):
                recall[f"recall@{depth}"] = float(np.mean([len({d for d, _ in a[:depth]} & {d for d, _ in e[:depth]})
                                                           / depth for a, e in zip(card, exact_hits)]))
            entry.update(recall)
            if opts["nprobe"] == opts["clusters"]:
                faults = [f for a, e in zip(card, exact_hits) for f in ranking_faults(a, e, DENSE_SCORE_TOL)]
                check(not faults, f"15a IVF nprobe = clusters differs from exact: {faults[:3]}")
        out["engines"][label] = entry
        print(f"[15a dense {label}] {smi_line()}: set-up {setup_s:.2f} s {json.dumps(entry['setup_parts_s'])}; "
              f"one query {single_ms:.2f} ms (spread {spread[0]:.2f}-{spread[1]:.2f}), 128 queries {batch_ms:.2f} ms, "
              f"peak {entry['peak_gb']:.2f} GB, busy {100 * entry['busy_share']:.1f}%; launches "
              f"{ {k: v for k, v in launched.items() if v} }; card vs CPU max err {entry['card_vs_cpu_max_err']:.3g}"
              + "".join(f"; {k} {entry[k]}" for k in ("recall@10", "recall@1000", "chunks") if k in entry))
        if label == "bf16":
            services["dense"] = svc
    out["k2_max_abs_err"] = k2_errs
    return out, services


def write_scale_matrix(workdir):
    """15b's seeded clustered n x dim matrix written straight into the dense
    searcher's cache of a ``SyntheticDenseIndex`` (no encoding). Returns the
    index and SCALE["queries"] query rows drawn around the same centres."""
    import torch.nn.functional as F

    n, dim = SCALE["docs"], SCALE["dim"]
    index = SyntheticDenseIndex(n, os.path.join(workdir, "dense_scale"))
    cache_fn = dense_searcher({"pretrained": "tiny"}, "cuda", index)._doc_cache_file()
    cache_fn.parent.mkdir(parents=True, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(SCALE["seed"])
    centres = F.normalize(torch.randn((SCALE["centres"], dim), generator=g, device="cuda"), dim=1)

    def around(count):
        picks = torch.randint(0, SCALE["centres"], (count,), generator=g, device="cuda")
        noise = torch.randn((count, dim), generator=g, device="cuda") * (SCALE["noise"] / dim ** 0.5)
        return F.normalize(centres[picks] + noise, dim=1)

    emb = np.lib.format.open_memmap(cache_fn, mode="w+", dtype=np.float32, shape=(n, dim))
    for s0 in range(0, n, 131072):
        emb[s0:s0 + 131072] = around(min(131072, n - s0)).cpu().numpy()
    emb.flush()
    del emb
    return index, around(SCALE["queries"])


def phase_dense_scale(workdir, peaks):
    """15b: the dense engines over a seeded clustered 1M x 768 matrix written
    straight into the searcher's cache file (no encoding): per engine the
    128-query batch at k 1000, the product and the selection apart, peak
    memory and busy share; X1 and the bf16 product at the served shape."""
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    from capreolus_tpu_torch.ops.quantization import quantize_rows_torch
    from capreolus_tpu_torch.searcher.dense import _dense_scores, score_block
    from capreolus_tpu_torch.searcher.ivf import bf16_sims
    from capreolus_tpu_torch.searcher.streamed import topk_lower_ordinal_first

    n, dim = SCALE["docs"], SCALE["dim"]
    t0 = time.perf_counter()
    index, q = write_scale_matrix(workdir)
    out = {"write_s": time.perf_counter() - t0, "engines": {}}
    print(f"[15b dense] {n} x {dim} around {SCALE['centres']} centres written to the searcher's cache in "
          f"{out['write_s']:.1f} s")
    exact = None
    for label, opts in SCALE_ENGINES.items():
        opts = dict(opts)
        if opts.get("hbmbudget") == "chunks":
            opts["hbmbudget"] = stream_budget_mb(n, dim, "none")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        searcher = dense_searcher({"pretrained": "tiny", **opts}, "cuda", index)
        t0 = time.perf_counter()
        topk, docs, _ = searcher.build_topk(SCALE["hits"])
        torch.cuda.synchronize()
        entry = {"setup_s": time.perf_counter() - t0, "setup_parts_s": dict(searcher.setup_seconds)}
        reset_launch_counts()
        topk(q, docs)
        torch.cuda.synchronize()
        walls = []
        for _ in range(1 if label in ("int4", "streamed") else 3):  # the host-bound engines once
            t0 = time.perf_counter()
            scores, ords = topk(q, docs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        entry["batch128_ms"] = float(np.median(walls))
        entry["x1_launches"] = launch_counts()["int8_matmul"]
        check((entry["x1_launches"] > 0) == ("quantize" in opts), f"15b {label}: X1 launched {entry['x1_launches']}")
        if isinstance(docs, torch.Tensor) or (isinstance(docs, dict) and "starts" not in docs):
            block = score_block(n)
            entry["product_ms"] = cuda_ms(lambda: _dense_scores(q, docs, block), rounds=3, calls=2)
            full = _dense_scores(q, docs, block)[:, :n]
            entry["selection_ms"] = cuda_ms(lambda: topk_lower_ordinal_first(full, SCALE["hits"]), rounds=3, calls=2)
            del full
        profiled = profile_call(lambda: topk(q, docs), f"[15b dense {label}]", what="128-query batch")
        entry.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, busy_share=profiled["busy_ms"] / profiled["wall_ms"],
                     top_ops=profiled["top_ops"])
        if label == "bf16":
            exact = [set(r) for r in ords[:, :10].cpu().numpy().tolist()]
            qb = q.to(torch.bfloat16)
            entry["bf16_product_ms"] = cuda_ms(lambda: bf16_sims(qb, docs[:n]), rounds=3, calls=2)
            nbytes = 2.0 * (q.numel() + n * dim) + 4.0 * q.shape[0] * n
            entry["bf16_product_bound_ms"] = max(nbytes / peaks["bw"], 2.0 * q.shape[0] * n * dim
                                                 / peaks[torch.bfloat16]) * 1e3
        else:
            entry["recall@10_vs_bf16"] = float(np.mean([len(set(r) & e) / 10 for r, e in
                                                        zip(ords[:, :10].cpu().numpy().tolist(), exact)]))
        if label == "int8":  # X1 at the served shape: [128 x 768] x [1M x 768]^T
            codes, corpus = quantize_rows_torch(q)[0], docs["emb"]
            want = int8_matmul_plain(codes, corpus)
            check(torch.equal(int8_matmul(codes, corpus), want), "15b: X1 differs from its plain version at 1M docs")
            del want
            bound, by = x1_bound_ms(codes.shape[0], dim, n, peaks)
            out["x1"] = {"shape": f"M={codes.shape[0]} K={dim} N={n}", "max_abs_err": 0,
                         "ms": cuda_ms(lambda: int8_matmul(codes, corpus), rounds=5, calls=4),
                         "library_ms": cuda_ms(lambda: torch._int_mm(codes, corpus.T), rounds=5, calls=4),
                         "plain_ms": cuda_ms(lambda: int8_matmul_plain(codes, corpus), rounds=2, calls=1),
                         "bound_ms": bound, "bound_by": by}
            print(f"[15b X1] {out['x1']['shape']}: {out['x1']['ms']:.3f} ms (torch._int_mm {out['x1']['library_ms']:.3f}, "
                  f"plain {out['x1']['plain_ms']:.3f}, bound {bound:.3f} by {by}); equal to plain")
        out["engines"][label] = entry
        print(f"[15b dense {label}] {smi_line()}: 1M x 768, 128 queries at k {SCALE['hits']}: {entry['batch128_ms']:.2f} ms"
              + (f" (product {entry['product_ms']:.2f}, selection {entry['selection_ms']:.2f})" if "product_ms" in entry
                 else "") + f", set-up {entry['setup_s']:.1f} s, peak {entry['peak_gb']:.2f} GB, busy "
              f"{100 * entry['busy_share']:.1f}%" + (f", recall@10 vs bf16 {entry['recall@10_vs_bf16']:.3f}"
                                                     if "recall@10_vs_bf16" in entry else ""))
        del searcher, topk, docs, scores, ords
    torch.cuda.empty_cache()
    return out


def impact_checkpoints(workdir, ckpt_dir):
    """The 15c searchers' checkpoints (``params/...`` npz): uniCOIL's seeded
    BERT-base encoder and ``tokweight`` head; SPLADE's encoder and MLM head
    read from the phase's checkpoint directory."""
    from capreolus_tpu_torch.convert import flax_flat_params, save_params
    from capreolus_tpu_torch.reranker.bert import load_pretrained_encoder
    from capreolus_tpu_torch.reranker.splade import SpladeModel, load_pretrained_mlm_head
    from capreolus_tpu_torch.reranker.unicoil import UniCoilModel

    cfg, state = load_pretrained_encoder(ckpt_dir)
    unicoil = UniCoilModel(cfg)
    unicoil.bert.load_state_dict(state)
    with torch.no_grad():
        unicoil.tokweight.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(16))
        unicoil.tokweight.bias.zero_()
    splade = SpladeModel(cfg, vocab_size=cfg.vocab_size)
    splade.bert.load_state_dict(state)
    splade.mlm.load_state_dict(load_pretrained_mlm_head(ckpt_dir, cfg))
    return {name: str(save_params(flax_flat_params(model), os.path.join(workdir, f"{name}_15.npz")))
            for name, model in (("unicoil", unicoil), ("splade", splade))}


def term_weight_err(card, cpu, cut):
    """(largest error against the largest CPU weight, terms kept on one device
    only) of per-text (term ids, weights) lists. A term kept on one device
    only counts at its distance from the edge it straddles: ReLU's 0, or with
    ``cut`` (SPLADE's ``topterms``) the other device's smallest kept weight."""
    top = max(float(w.max()) for _, w in cpu if len(w))
    err, edge_terms = 0.0, 0
    for (ct, cw), (pt, pw) in zip(card, cpu):
        a, b = dict(zip(ct.tolist(), cw.tolist())), dict(zip(pt.tolist(), pw.tolist()))
        for t in a.keys() & b.keys():
            err = max(err, abs(a[t] - b[t]) / top)
        for t in a.keys() ^ b.keys():
            mine, other = (a, b) if t in a else (b, a)
            edge = min(other.values()) if cut and other else 0.0
            err, edge_terms = max(err, abs(mine[t] - edge) / top), edge_terms + 1
    return err, edge_terms


def phase_impact_serving(workdir, corpus_dir, topics, ckpt_dir):
    """15c: ImpactRetrievalService (uniCOIL, SPLADE) over ``corpus_dir`` (the
    first PREFIX_DOCS docs of phase 4's corpus); raw impacts and rankings card vs CPU."""
    from capreolus_tpu_torch.searcher import Searcher
    from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine
    from capreolus_tpu_torch.serving import ImpactRetrievalService

    ckpts = impact_checkpoints(workdir, ckpt_dir)
    queries = list(topics[:IMPACT_QUERIES])
    batch_queries = [topics[i % len(topics)] for i in range(DENSE_BATCH)]
    out = {}
    for encoder in ("unicoil", "splade"):
        config = {"encoder": encoder, "pretrained": ckpt_dir, "checkpointfile": ckpts[encoder]}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc = ImpactRetrievalService.from_config(collection="dummy", collection_path=corpus_dir, device="cuda",
                                                 **config)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        engine, docids, scale = svc._snapshot
        reset_launch_counts()
        single_ms, spread = timed_requests(svc, queries)
        t0 = time.perf_counter()
        batch_hits = svc.search(batch_queries, k=DENSE_HITS)
        batch_ms = (time.perf_counter() - t0) * 1e3
        launched = launch_counts()
        batches = 2 + len(queries)
        check(launched["flash_attention"] == 12 * batches,
              f"15c {encoder}: K2 launched {launched['flash_attention']} times, not 12 per query batch ({batches})")
        check(any(batch_hits), f"15c {encoder}: the batch request found nothing")
        profiled = profile_call(lambda: svc.search(queries[:1], k=10), f"[15c impact {encoder}]")
        entry = {"docs": len(docids), "postings": int(len(engine.dindex.host.doc_ids)), "setup_s": setup_s,
                 "setup_parts_s": dict(svc.searcher.setup_seconds), "single_ms": single_ms, "single_spread_ms": spread,
                 "batch128_ms": batch_ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "busy_share": profiled["busy_ms"] / profiled["wall_ms"], "top_ops": profiled["top_ops"],
                 "launches": launched}
        # raw impacts of 8 docs and query weights, card vs CPU, from one checkpoint
        cpu = Searcher.create("impact", dict(svc.searcher.config))
        cpu.device = "cpu"
        texts = [svc.searcher.index.get_doc(d) for d in docids[:8]]
        err, edge_terms = term_weight_err(svc.searcher._doc_term_weights(texts), cpu._doc_term_weights(texts),
                                          cut=encoder == "splade")
        check(err <= IMPACT_RAW_TOL, f"15c {encoder}: raw impacts card vs CPU {err:.3g} > {IMPACT_RAW_TOL}")
        entry.update(raw_impact_err=err, terms_at_an_edge=edge_terms)
        # rankings from the card's CSR on both devices, for the card's query weights
        cpu_engine = ScoringEngine(DeviceIndex(engine.dindex.host, device="cpu"))
        terms = svc.searcher.term_lists(engine, scale, svc.searcher.query_weights_batch(queries))
        card_s, card_o = engine.search(terms, model="impact", params={}, topk=DENSE_HITS)
        cpu_s, cpu_o = cpu_engine.search(terms, model="impact", params={}, topk=DENSE_HITS)
        rel = 0.0
        for i in range(len(queries)):
            keep = cpu_s[i] > 0
            check(np.array_equal(card_o[i][keep], cpu_o[i][keep]), f"15c {encoder}: query {i}'s ranking differs on the CPU")
            rel = max(rel, float(np.max(np.abs(card_s[i][keep] - cpu_s[i][keep]) / np.maximum(cpu_s[i][keep], 1e-30)))
                      if keep.any() else 0.0)
        check(rel <= IMPACT_SCORE_RTOL, f"15c {encoder}: scores card vs CPU {rel:.3g} > {IMPACT_SCORE_RTOL} relative")
        entry["score_rel_err"] = rel
        out[encoder] = entry
        print(f"[15c impact {encoder}] {smi_line()}: {entry['docs']} docs, {entry['postings']} postings; set-up "
              f"{setup_s:.2f} s {json.dumps(entry['setup_parts_s'])}; one query {single_ms:.2f} ms (spread "
              f"{spread[0]:.2f}-{spread[1]:.2f}), 128 queries {batch_ms:.2f} ms; peak {entry['peak_gb']:.2f} GB, busy "
              f"{100 * entry['busy_share']:.1f}%; K2 launches {launched['flash_attention']}; raw impacts card vs CPU "
              f"{err:.3g} ({edge_terms} terms at ReLU's or topterms' edge), rankings equal, scores {rel:.3g} relative")
    return out


def phase_hybrid(corpus_dir, topics, dense_svc):
    """15d: HybridRetrievalService over BM25 and 15a's bf16 dense service."""
    from capreolus_tpu_torch.searcher.fusion import interp_fuse, rrf_fuse
    from capreolus_tpu_torch.serving import HybridRetrievalService, RetrievalService

    bm25 = RetrievalService.from_config(collection="dummy", collection_path=corpus_dir, device="cuda")
    queries = list(topics[:DENSE_QUERIES])
    out = {}
    for method in ("rrf", "interp"):
        hybrid = HybridRetrievalService(bm25, dense_svc, method=method, depth=HYBRID_DEPTH)
        single_ms, spread = timed_requests(hybrid, queries)
        fused = hybrid.search(queries, k=10)
        legs = [{str(i): dict(h) for i, h in enumerate(svc.search(queries, k=HYBRID_DEPTH))} for svc in (bm25, dense_svc)]
        want = rrf_fuse(legs, k=60, hits=10) if method == "rrf" else interp_fuse(legs[0], legs[1], alpha=0.5, hits=10)
        same = all(fused[i] == sorted(want[str(i)].items(), key=lambda kv: (-kv[1], kv[0])) for i in range(len(queries)))
        check(same, f"15d {method}: the fused lists differ from fusion.py's math over the legs' lists")
        out[method] = {"single_ms": single_ms, "single_spread_ms": spread}
        print(f"[15d hybrid {method}] {smi_line()}: depth {HYBRID_DEPTH}, one query {single_ms:.2f} ms (spread "
              f"{spread[0]:.2f}-{spread[1]:.2f}); fused lists = fusion.py's math over the two legs")
    return out


def splade_tied_rows(rr, batch):
    """{"mlm.decoder.weight": [vocab rows]} of the terms whose max over
    positions is a near-tie (two valid positions' weights within
    SPLADE_TIE_RTOL of the largest) in any text of ``batch`` ([1, B, ...]),
    from the step's init on the CPU: the card and the CPU may route such a
    term's gradient through different positions, a step of the max, not an
    error of the arithmetic, so step 1's check leaves those rows out."""
    from capreolus_tpu_torch.reranker.biencoder import encoder_inputs

    model = rr.init_params(rr.trainer.config["seed"]).to("cpu")
    rows = set()
    with torch.no_grad():
        for key in ("query", "posdoc", "negdoc"):
            toks, mask = encoder_inputs(torch.from_numpy(np.asarray(batch[key][0])), model.config.max_position)
            hidden, _ = model.bert(toks, mask, torch.zeros_like(toks))
            w = torch.log1p(torch.relu(model.mlm(hidden.float())))
            valid = (toks != 0) & (toks != model.cls_id) & (toks != model.sep_id)
            top2 = torch.where(valid[..., None], w, 0.0).topk(2, dim=1).values  # [B, 2, V]
            tied = (top2[:, 0] > 0) & (top2[:, 0] - top2[:, 1] <= SPLADE_TIE_RTOL * float(w.max()))
            rows.update(torch.nonzero(tied.any(dim=0)).reshape(-1).tolist())
    print(f"[15e parity] splade: {len(rows)} of {model.vocab_size} vocabulary rows take their max at a near-tie "
          f"(within {SPLADE_TIE_RTOL} of the largest weight); mlm.decoder.weight's check leaves them out")
    return {"mlm.decoder.weight": sorted(rows)}


def phase_dense_training(workdir, corpus_dir, topics, ckpt_dir):
    """15e: biencoder (infonce), uniCOIL and SPLADE (with its regularizer) at
    BERT-base width: step 1 card vs CPU from one init (dropout off), 8 timed
    steps, no K2 in a step; then the tiny train-then-serve loops."""
    from types import SimpleNamespace

    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RetrievalService
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    coll = {"name": "dummy", "path": corpus_dir}
    b = TRAIN15["batch"]
    docids = [d for d, _ in RetrievalService.from_config(collection="dummy", collection_path=corpus_dir,
                                                         device="cuda").search(topics[:1], k=2 * b)[0]]
    out = {}
    for name, extra in TRAIN15_MODELS.items():
        # dropout 0: a training forward (attention_plain, never K2) whose masks draw nothing, so that the
        # card's and the CPU's steps agree
        cfg = json.loads(json.dumps({"pretrained": ckpt_dir, "hidden_dropout_prob": 0.0, **extra}))
        cfg["extractor"] = {"maxqlen": TRAIN15["maxqlen"], "maxdoclen": TRAIN15["maxdoclen"], "index": {"collection": coll}}
        cfg.setdefault("trainer", {})["batch"] = b
        rr = Reranker.create(name, cfg)
        rr.extractor.preprocess(["q15"], docids, {"q15": topics[0]})
        samples = [rr.extractor.id2vec("q15", docids[i], docids[b + i], label=[1, 0]) for i in range(b)]
        batch = {k: v[None] for k, v in collate(samples, ARRAY_KEYS).items()}
        few = {k: v[:, :TRAIN15["parity_samples"]] for k, v in batch.items()}
        exclude = splade_tied_rows(rr, few) if name == "splade" else None
        parity = step_parity(SimpleNamespace(reranker=rr), few, name, prefix="[15e parity]", exclude=exclude)
        check(parity["launches"]["flash_attention"] == 0, f"15e {name}: K2 launched in a training step")
        trainer = rr.trainer
        trainer.device = "cuda"
        torch.cuda.reset_peak_memory_stats()
        rr.build_train_model().to("cpu")  # step_parity left it on the card; flax's draws come from a CPU generator
        model = rr.init_params(trainer.config["seed"]).to("cuda")
        optimizer = trainer.make_optimizer(rr, model)
        reset_launch_counts()
        times = []
        for i in range(TRAIN15["steps"]):
            t0 = time.perf_counter()
            loss = float(trainer.train_step(rr, model, optimizer, batch, i, trainer.step_seed(0, i)))
            times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(loss), f"15e {name}: step {i} loss {loss}")
        check(launch_counts()["flash_attention"] == 0, f"15e {name}: K2 launched in a timed step")
        out[name] = {"parity": parity, "step_ms": float(np.median(times[1:])), "first_step_ms": times[0],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[15e train {name}] {smi_line()}: BERT-base, batch {b} (q {TRAIN15['maxqlen']}, d {TRAIN15['maxdoclen']}), "
              f"{out[name]['step_ms']:.1f} ms a step (median of {TRAIN15['steps'] - 1} after the first, "
              f"{times[0]:.1f}), peak {out[name]['peak_gb']:.2f} GB, no K2 in a step")
        del model, optimizer
    torch.cuda.empty_cache()

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_rerank_golden")  # phase 9a's golden and caches
    golden_topics, golden_qrels = rerank_golden_corpus()[1:]
    test_q = sorted(golden_topics)[sum(RERANK_GOLDEN["split"][:2]):]
    for name, (rr_cfg, searcher_cfg) in GOLDEN15.items():
        t0 = time.perf_counter()
        constants["RESULTS_BASE_PATH"] = os.path.join(workdir, f"results_golden15_{name}")
        reset_launch_counts()
        task = rerank_task(rr_cfg, "cuda")
        first_stage = task._best_search_run()
        preds = task.rerank_run(first_stage, task.get_results_path())
        rerank_map = golden_map(preds["test"], golden_qrels, test_q)
        ckpt = task.get_results_path() / "dev.best.params"
        check(ckpt.exists(), f"15e {name}: no dev.best.params")
        _, secs, scores, runs = rank_search(dict(searcher_cfg, checkpointfile=str(ckpt),
                                                 index={"collection": {"name": "rerank_golden"}}),
                                            "cuda", os.path.join(workdir, f"results_golden15_{name}_rank"),
                                            benchmark={"name": "rerank_golden"})
        run = next(iter(runs.values()))
        search_map = golden_map({q: run.get(q, {}) for q in test_q}, golden_qrels, test_q)
        hits = sum(len(r) for r in run.values())
        check(hits > 0 and np.isfinite(search_map) and all(np.isfinite(s) for r in run.values() for s in r.values()),
              f"15e {name}: the served search returned {hits} hits, or scores that are not finite")
        launched = launch_counts()
        out[f"golden_{name}"] = {"rerank_test_map": rerank_map, "first_stage_map": golden_map(first_stage, golden_qrels, test_q),
                                 "searcher_test_map": search_map, "served_hits": hits,
                                 "search_s": secs, "launches": launched, "seconds": time.perf_counter() - t0}
        print(f"[15e golden {name}] rerank.traineval test MAP {rerank_map:.4f} (first stage "
              f"{out[f'golden_{name}']['first_stage_map']:.4f}); its dev.best as {searcher_cfg['name']}'s checkpointfile in "
              f"rank.searcheval: test MAP {search_map:.4f}, {out[f'golden_{name}']['served_hits']} hits over "
              f"{len(golden_topics)} topics (no pin: the JAX package has none); K2 launches "
              f"{launched['flash_attention']}; {out[f'golden_{name}']['seconds']:.1f} s")
    return out


def phase_dense_retrieval(workdir, corpus_dir, topics, peaks):
    """Phase 15: dense and learned-sparse retrieval on the card (15a-15e).
    Returns the summary, with K2's and X1's launches and errors."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.reranker.bert import get_bert_config

    capreolus_tpu_torch.load_all_modules()
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")  # phase 4's index
    check(torch.backends.cuda.matmul.allow_tf32 is False, "phase 15: TF32 is on for matmuls")
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(workdir, "bert_mlm_15")
    write_birch_checkpoint(ckpt_dir, get_bert_config("bert-base-uncased"), seed=15, head="mlm")
    seconds = {}

    def timed15(label, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        seconds[label] = round(time.perf_counter() - t1, 1)
        print(f"[{label} done] {seconds[label]} s")
        return result

    dense, services = timed15("15a", phase_dense_serving, workdir, corpus_dir, topics, peaks, ckpt_dir)
    hybrid = timed15("15d", phase_hybrid, corpus_dir, topics, services["dense"])
    del services
    torch.cuda.empty_cache()
    scale = timed15("15b", phase_dense_scale, workdir, peaks)
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")
    impact = timed15("15c", phase_impact_serving, workdir, corpus_prefix(workdir, corpus_dir), topics, ckpt_dir)
    training = timed15("15e", phase_dense_training, workdir, corpus_dir, topics, ckpt_dir)
    summary = {"dense": dense, "scale": scale, "impact": impact, "hybrid": hybrid, "training": training,
               "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    print(f"[15 dense and sparse] {smi_line()}: every sub-phase passed in {summary['seconds']:.1f} s "
          f"({json.dumps(seconds)}); summary " + json.dumps(summary, default=str))
    return summary


def add_phase15_launches(kernels, p15):
    """Phase 15's K2 and X1 launches and errors into the ``kernels`` line
    (served requests of 15a and 15c; 15e's training steps launch neither)."""
    served = {f"dense_{k}": v["launches"] for k, v in p15["dense"]["engines"].items()}
    served.update({f"impact_{k}": v["launches"] for k, v in p15["impact"].items()})
    for entry in kernels:
        name = entry["name"]
        if name not in ("flash_attention", "int8_matmul"):
            continue
        total = sum(launches[name] for launches in served.values())
        entry["launches"] += total
        entry["launches_phase15"] = {"served": total, "served_by_path": {k: v[name] for k, v in served.items()},
                                     "training_steps": sum(t["parity"]["launches"][name]
                                                           for k, t in p15["training"].items() if "parity" in t)}
    kernels[1]["max_abs_err_phase15"] = p15["dense"]["k2_max_abs_err"]
    kernels[3]["max_abs_err_phase15"] = 0  # int32 products, equal to the plain version on the served and 1M shapes
    kernels[3]["served_shapes"]["dense_1m"] = p15["scale"]["x1"]


# ---------------------------------------------------------------- phase 16: the serving families
P16 = {  # phase 16's counts (none crosses a dispatch threshold)
    "prefilters": (200, 1000), "queries": 8, "stream_queries": 3, "stream_quarter": 4,
    "added": 256, "deleted": 128, "http_requests": 256, "http_clients": 16, "snippet_queries": 8,
}
RESIDENT16_MS = {"none": (6.36, 17.20), "int8": (8.15, 93.35)}  # PERF.md §5: ColBERT resident, one query / 64
PREFILTER_CPU_TOL = COLBERT_CPU_TOL  # a prefilter's served top 10 vs the CPU encoder + plain scoring


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def colbert16(cfg, encoder_of=None, corpus_of=None, device="cuda"):
    """A colbert searcher on ``device``; ``encoder_of`` hands it a loaded
    encoder (one BERT-base load for the phase), ``corpus_of`` another
    searcher's uploaded corpus of the same representation (one upload)."""
    from capreolus_tpu_torch.searcher import Searcher

    searcher = Searcher.create("colbert", json.loads(json.dumps(cfg)))
    searcher.device = device
    if encoder_of is not None:
        searcher._enc, searcher._random_init = encoder_of._encoder(), encoder_of._random_init
    if corpus_of is not None:
        searcher._docs_emb, searcher._docs_emb_gen = corpus_of._doc_tensors(), corpus_of._docs_emb_gen
    return searcher


def colbert_cpu_top10(cpu_model, searcher, query, hits, qmode, corpus):
    """max |served - CPU| over a served top 10: the port's encoder on the CPU
    for the query, the CPU's plain MaxSim (or int8 scoring) over those docs'
    rows of the searcher's own cache (f16 then bf16) or int8 corpus."""
    from capreolus_tpu_torch.ops.maxsim import maxsim_scores_plain
    from capreolus_tpu_torch.searcher.late_interaction import quantized_maxsim_scores

    ordinal = {d: i for i, d in enumerate(searcher.index.data.docid_strings)}
    rows = [ordinal[d] for d, _ in hits]
    with torch.inference_mode():
        cq, _ = cpu_model.encode_query(torch.from_numpy(searcher._tokenize([query], COLBERT["maxqlen"])))
    if qmode == "none":
        cache = searcher._current_doc_cache_file()
        emb = np.load(cache, mmap_mode="r")[rows]
        mask = np.load(searcher._mask_for(cache), mmap_mode="r")[rows] > 0
        docs_t = torch.from_numpy(np.ascontiguousarray(emb.swapaxes(0, 1))).to(torch.bfloat16)
        mask_t = torch.from_numpy(np.ascontiguousarray(mask.T))
        cpu = maxsim_scores_plain(cq, docs_t, torch.where(mask_t, 0.0, MASKED_BIAS).float(), mask_t.any(dim=0))[0]
    else:
        idx = torch.tensor(rows, device=corpus[0].device)
        cpu = quantized_maxsim_scores(cq, *(t[idx].cpu() for t in corpus))[0]
    return float(max(abs(s - float(c)) for (_, s), c in zip(hits, cpu)))


def phase_colbert_options(workdir, corpus_dir, topics, none, peaks, device="cuda", shape=P16):
    """16a: the ColBERT options over phase 6's 20k-doc cache (no encoding):
    ``prefilter`` 200 and 1000 over the bf16 and int8 corpora (one query,
    median of 8, and a 64-query batch; stage 2 equal to the exact engine's
    scores bit for bit; top-10 overlap with exact; query 0's top 10 card vs
    CPU), the host stream at about a quarter of the corpus's device bytes
    (bit-identical to the resident engine) and an int4 corpus over the budget
    (JAX's message). K3 on gathered candidates and on a streamed slice, X1 on
    int8 candidates and on an int8 slice, held against their plain versions."""
    from capreolus_tpu_torch.convert import bert_state_dict, load_params
    from capreolus_tpu_torch.core import ConfigError, constants
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    from capreolus_tpu_torch.ops.maxsim import maxsim_scores
    from capreolus_tpu_torch.ops.quantization import quantize_rows_torch
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.reranker.colbert import ColBERTModel
    from capreolus_tpu_torch.searcher.late_interaction import prefilter_candidates, quantized_maxsim_scores
    from capreolus_tpu_torch.searcher.streamed import topk_lower_ordinal_first
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_colbert")  # phase 6's doc-embedding cache
    cfg = {**COLBERT, "pretrained": "bert-base-uncased", "allowrandominit": True, "checkpointfile": none["ckpt"],
           "index": {"collection": {"name": "dummy", "path": corpus_dir}}}
    queries, batch = list(topics[:shape["queries"]]), list(none["batch"])
    encoder = colbert16(cfg, device=device)
    cpu_model = ColBERTModel(get_bert_config("bert-base-uncased"), dim=COLBERT["dim"])
    cpu_model.load_state_dict(bert_state_dict(load_params(none["ckpt"])))
    cpu_model.eval()
    out, launches, held = {}, {}, {}
    for qmode in ("none", "int8"):
        opts = {} if qmode == "none" else {"quantize": "int8"}
        t0 = time.perf_counter()
        exact = colbert16({**cfg, **opts}, encoder_of=encoder, device=device)
        corpus = exact._doc_tensors()
        sync(device)
        setup_s = time.perf_counter() - t0
        check(exact.docs_encoded == 0, f"16a {qmode}: {exact.docs_encoded} docs encoded; phase 6's cache holds them all")
        n = corpus[0].shape[1] if qmode == "none" else corpus[0].shape[0]
        qb = exact.encode_queries(exact._tokenize(batch, COLBERT["maxqlen"]))
        full = maxsim_scores(qb, *corpus) if qmode == "none" else quantized_maxsim_scores(qb, *corpus)
        exact_top10 = topk_lower_ordinal_first(full, 10)[1].cpu().numpy()
        for pf in shape["prefilters"]:
            label = f"{qmode} prefilter {pf}"
            svc = ColbertRetrievalService(colbert16({**cfg, **opts, "prefilter": pf}, encoder_of=encoder,
                                                    corpus_of=exact, device=device), max_k=100, device=device)
            reset_launch_counts()
            single_ms, spread = timed_requests(svc, queries)
            t0 = time.perf_counter()
            batch_hits = svc.search(batch, k=10)
            batch_ms = (time.perf_counter() - t0) * 1e3
            launched = launch_counts()
            launches[f"prefilter_{qmode}_{pf}"] = launched
            requests = 1 + len(queries)
            served_queries = requests + len(batch)
            check(launched["flash_attention"] == 12 * (requests + 1),
                  f"16a {label}: K2 launched {launched['flash_attention']} times, not 12 per query batch")
            if qmode == "none":
                check(launched["maxsim"] == served_queries and launched["int8_matmul"] == 0,
                      f"16a {label}: K3 launched {launched['maxsim']} times for {served_queries} queries (one each)")
            else:
                check(launched["int8_matmul"] == served_queries == launched["maxsim_epilogue"]
                      and launched["maxsim"] == 0,
                      f"16a {label}: X1 launched {launched['int8_matmul']} times for {served_queries} queries, the "
                      f"MaxSim epilogue {launched['maxsim_epilogue']}")
            check(all(len(h) == 10 and len({d for d, _ in h}) == 10 for h in batch_hits),
                  f"16a {label}: a request did not return 10 distinct docids")
            # stage 2 equals the exact engine's scores, bit for bit, over the batch's own embeddings
            s2, o2 = svc._topk(qb, *svc._corpus)
            equal = bool(torch.equal(s2, torch.gather(full, 1, o2)))
            check(equal, f"16a {label}: a candidate's stage-2 score differs from the exact engine's")
            got10 = o2[:, :10].cpu().numpy()
            overlap = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got10, exact_top10)]))
            single0 = svc.search(queries[:1], k=10)[0]
            err_cpu = colbert_cpu_top10(cpu_model, svc.searcher, queries[0], single0, qmode, svc._corpus)
            check(err_cpu <= PREFILTER_CPU_TOL, f"16a {label}: query 0's top 10 card vs CPU {err_cpu:.3g}")
            if pf == max(shape["prefilters"]):  # the kernel on this path's inputs: query 0's gathered candidates
                q0 = svc.searcher.encode_queries(svc.searcher._tokenize(queries[:1], COLBERT["maxqlen"]))
                cand = prefilter_candidates(q0, svc.searcher.pooled_docs(corpus), pf)[0]
                if qmode == "none":
                    docs_t, bias_t, valid = corpus
                    held["k3_prefilter"] = k3_measure(q0, docs_t[:, cand].contiguous(), bias_t[:, cand].contiguous(),
                                                      valid[cand], peaks) if device == "cuda" else None
                else:
                    q_codes = quantize_rows_torch(q0)[0].reshape(-1, COLBERT["dim"])
                    d_codes = corpus[0][cand].reshape(-1, COLBERT["dim"])
                    held["x1_prefilter_equal"] = bool(torch.equal(int8_matmul(q_codes, d_codes),
                                                                  int8_matmul_plain(q_codes, d_codes))) \
                        if device == "cuda" else None
                    check(held["x1_prefilter_equal"] is not False, "16a: X1 differs from plain on int8 candidates")
            out[f"prefilter_{qmode}_{pf}"] = {"single_ms": single_ms, "single_spread_ms": spread,
                                              "batch64_ms": batch_ms, "top10_overlap_exact": overlap,
                                              "stage2_equals_exact": equal, "max_abs_err_cpu_top10": err_cpu}
            print(f"[16a colbert {label}] {smi_line() if device == 'cuda' else device}: one query {single_ms:.2f} ms "
                  f"(spread {spread[0]:.2f}-{spread[1]:.2f}; resident {RESIDENT16_MS[qmode][0]}), 64 queries "
                  f"{batch_ms:.2f} ms (resident {RESIDENT16_MS[qmode][1]}); top-10 overlap with exact {overlap:.3f}; "
                  f"stage 2 = exact engine bit for bit; query 0's top 10 card vs CPU {err_cpu:.3g}; launches "
                  f"{ {k: v for k, v in launched.items() if v} }")
            del svc

        # the host stream at about a quarter of the device bytes
        ld, dim = COLBERT["maxdoclen"], COLBERT["dim"]
        row = ld * dim * (1 if qmode == "int8" else 2) + ld + (4 if qmode == "int8" else 0)
        budget_mb = n * row / shape["stream_quarter"] / 1e6
        t0 = time.perf_counter()
        streamed = colbert16({**cfg, **opts, "hbmbudget": budget_mb}, encoder_of=encoder, device=device)
        svc = ColbertRetrievalService(streamed, max_k=100, device=device)
        stream_setup_s = time.perf_counter() - t0
        reset_launch_counts()
        stream_ms, stream_spread = timed_requests(svc, queries[:shape["stream_queries"]])
        launched = launch_counts()
        launches[f"streamed_{qmode}"] = launched
        slices = streamed.stream_slices
        batches = 1 + shape["stream_queries"]
        kernel = "maxsim" if qmode == "none" else "int8_matmul"
        check(launched[kernel] == slices * batches, f"16a streamed {qmode}: {kernel} launched {launched[kernel]} "
                                                    f"times for {batches} query batches of {slices} slices")
        check(launched["maxsim_epilogue"] == (launched["int8_matmul"] if qmode == "int8" else 0),
              f"16a streamed {qmode}: the MaxSim epilogue launched {launched['maxsim_epilogue']} times, X1 "
              f"{launched['int8_matmul']}")
        q8 = qb[: shape["queries"]]
        got = svc._topk(q8)
        want = topk_lower_ordinal_first(full[: shape["queries"]], 100)
        bits = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        check(bits, f"16a streamed {qmode}: the top 100 is not bit-identical to the resident engine's")
        check(slices >= shape["stream_quarter"], f"16a streamed {qmode}: {slices} slices at a quarter of the bytes")
        if device == "cuda":  # the kernel on a streamed slice of the corpus
            host = streamed._docs_emb
            upload = streamed.stream_slice_docs
            if qmode == "none":
                rows = torch.from_numpy(np.array(host.emb[:upload])).to(torch.bfloat16).transpose(0, 1).contiguous()
                mask_t = torch.from_numpy(np.ascontiguousarray(np.array(host.mask[:upload]).T > 0)).to(device)
                held["k3_streamed_slice"] = k3_measure(q8, rows.to(device), torch.where(mask_t, 0.0, MASKED_BIAS),
                                                       mask_t.any(dim=0), peaks)
            else:
                q_codes = quantize_rows_torch(q8)[0].reshape(-1, dim)
                d_codes = torch.from_numpy(np.array(host.emb[:upload])).to(device).reshape(-1, dim)
                held["x1_streamed_equal"] = bool(torch.equal(int8_matmul(q_codes, d_codes),
                                                             int8_matmul_plain(q_codes, d_codes)))
                check(held["x1_streamed_equal"], "16a: X1 differs from plain on an int8 slice")
        out[f"streamed_{qmode}"] = {"budget_mb": budget_mb, "slices": slices, "setup_s": stream_setup_s,
                                    "single_ms": stream_ms, "single_spread_ms": stream_spread,
                                    "equal_resident_bits": bits}
        print(f"[16a colbert {qmode} streamed] {smi_line() if device == 'cuda' else device}: hbmbudget "
              f"{budget_mb:.1f} MB, {slices} slices a query batch; set-up {stream_setup_s:.2f} s; one query "
              f"{stream_ms:.2f} ms (spread {stream_spread[0]:.2f}-{stream_spread[1]:.2f}); top 100 of "
              f"{shape['queries']} queries bit-identical to the resident engine")
        out[f"setup_{qmode}_s"] = setup_s
        del svc, streamed, exact, corpus, full
        if device == "cuda":
            torch.cuda.empty_cache()

    # int4 is resident-only: over the budget it raises JAX's message
    try:
        colbert16({**cfg, "quantize": "int4", "hbmbudget": 1.0}, encoder_of=encoder, device=device)._doc_tensors()
        raised = None
    except ConfigError as e:
        raised = str(e)
    check(raised is not None and "quantize=int4 is resident-only" in raised,
          f"16a: an int4 corpus over hbmbudget did not raise JAX's message ({raised})")
    out["int4_over_budget"] = raised
    print(f"[16a colbert int4 over the budget] raises: {raised}")
    return out, launches, held


def phase16_services(workdir, corpus_dir, none, device="cuda"):
    """The four services phases 16b-16d share: BM25 over phase 4's index, the
    bf16 dense service over phase 15's cache of it, uniCOIL over phase 15's
    prefix and cache, ColBERT over phase 6's index and cache. Returns
    {family: (service, cache base)}."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.serving import (ColbertRetrievalService, DenseRetrievalService, ImpactRetrievalService,
                                             RetrievalService)

    where = dict(collection="dummy", collection_path=corpus_dir, device=device)
    prefix = dict(where, collection_path=corpus_prefix(workdir, corpus_dir))
    ckpt_dir = os.path.join(workdir, "bert_mlm_15")
    base = os.path.join(workdir, "cache")
    constants["CACHE_BASE_PATH"] = base
    services = {
        "bm25": (RetrievalService.from_config(**where), base),
        "dense": (DenseRetrievalService.from_config(max_k=DENSE_HITS, pretrained=ckpt_dir, **where), base),
        "unicoil": (ImpactRetrievalService.from_config(encoder="unicoil", pretrained=ckpt_dir,
                                                        checkpointfile=os.path.join(workdir, "unicoil_15.npz"),
                                                        **prefix), base),
    }
    base_colbert = os.path.join(workdir, "cache_colbert")
    constants["CACHE_BASE_PATH"] = base_colbert
    services["colbert"] = (ColbertRetrievalService.from_config(
        max_k=100, pretrained="bert-base-uncased", allowrandominit=True, checkpointfile=none["ckpt"],
        **{k: v for k, v in COLBERT.items() if k != "hits"}, **where), base_colbert)
    constants["CACHE_BASE_PATH"] = base
    for svc, _ in services.values():
        if hasattr(svc, "searcher"):
            check(svc.searcher.docs_encoded == 0, f"16: {type(svc).__name__} encoded documents; the caches hold them")
    return services


def phase_snippets(services, corpus_dir, topics, shape=P16):
    """16c: snippets of 8 queries' top 10 on each service: host ms, and equal
    to the port's highlighter over a CPU reader of the same index."""
    from capreolus_tpu_torch.analysis.highlight import snippets_for_hits
    from capreolus_tpu_torch.index import Index

    queries = list(topics[:shape["snippet_queries"]])
    out = {}
    for family, (svc, _) in services.items():
        hits = svc.search(queries, k=10)
        t0 = time.perf_counter()
        snips = [svc.snippets(q, h) for q, h in zip(queries, hits)]
        ms = (time.perf_counter() - t0) * 1e3
        index = svc.index if hasattr(svc, "index") else svc.searcher.index
        reader = Index.create("tpu", dict(index.config))  # a second reader: the same artifacts, host only
        reader._load()
        want = [snippets_for_hits(reader, q, h) for q, h in zip(queries, hits)]
        check(snips == want, f"16c {family}: snippets differ from the CPU reader's")
        marked = sum("<em>" in s for per in snips for s in per)
        out[family] = {"ms": ms, "snippets": sum(len(s) for s in snips), "marked": marked}
        print(f"[16c snippets {family}] {len(queries)} queries' top 10: {ms:.1f} ms on the host, {marked} of "
              f"{out[family]['snippets']} with a marked term; equal to the CPU reader's")
    return out


HTTP_CLIENT = """
import json, sys, time, urllib.request
base, queries, ms = sys.argv[1], json.loads(sys.argv[2]), []
for q in queries:
    t0 = time.perf_counter()
    req = urllib.request.Request(base + "/search", method="POST", data=json.dumps({"queries": [q], "k": 10}).encode())
    json.load(urllib.request.urlopen(req, timeout=120))
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps(ms))
"""  # one HTTP client: single-query requests in turn, its latencies (ms) as JSON on stdout


def phase_http(services, corpus_dir, topics, shape=P16):
    """16d: the HTTP front end on 127.0.0.1 (port 0) over the BM25 and the bf16
    dense services: 256 single-query requests from 16 clients, each a process
    of its own (``HTTP_CLIENT``: clients inside the server's process would
    contend for its interpreter lock); client p50 / p99 ms, batches run, the
    mean batch; /search equal to ``service.search``; /health's corpus size
    the corpus's."""
    import threading
    import urllib.request

    from capreolus_tpu_torch.serving_http import make_server

    out = {}
    for family in ("bm25", "dense"):
        svc = services[family][0]
        server = make_server(svc, host="127.0.0.1", port=0)
        host, port = server.server_address
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://{host}:{port}"

        def post(queries, k=10):
            req = urllib.request.Request(f"{base}/search", method="POST",
                                         data=json.dumps({"queries": queries, "k": k}).encode())
            return json.load(urllib.request.urlopen(req, timeout=120))["results"]

        try:
            health = json.load(urllib.request.urlopen(f"{base}/health", timeout=60))
            check(health == {"ok": True, "corpus_size": len(svc._docids)} and health["corpus_size"] == SERVING_DOCS,
                  f"16d {family}: /health {health}")
            queries = [topics[i % len(topics)] + " " + topics[(5 * i + 1) % len(topics)].split()[0]
                       for i in range(shape["http_requests"])]
            want = svc.search(queries[:8], k=10)
            check(post(queries[:8]) == [[[d, s] for d, s in h] for h in want], f"16d {family}: /search != search")
            per = shape["http_requests"] // shape["http_clients"]
            before = server.batcher.stats.snapshot()
            t0 = time.perf_counter()
            clients = [subprocess.Popen([sys.executable, "-c", HTTP_CLIENT, base, json.dumps(queries[c * per:(c + 1) * per])],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                       for c in range(shape["http_clients"])]
            latencies, errors = [], []
            for proc in clients:
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode:
                    errors.append(stderr[-300:])
                else:
                    latencies.extend(json.loads(stdout))
            wall_s = time.perf_counter() - t0
            stats = server.batcher.stats.snapshot()
        finally:
            server.shutdown()
            server.server_close()
            server.batcher.close()
        check(not errors and len(latencies) == shape["http_requests"], f"16d {family}: client errors {errors[:3]}")
        lat = np.sort(np.asarray(latencies))
        batches = stats["batches"] - before["batches"]
        queries_run = stats["queries"] - before["queries"]
        out[family] = {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                       "batches": batches, "mean_batch": queries_run / max(1, batches),
                       "queries_per_s": shape["http_requests"] / wall_s, "errors": stats["errors"]}
        print(f"[16d http {family}] {shape['http_requests']} requests from {shape['http_clients']} client processes: p50 "
              f"{out[family]['p50_ms']:.2f} ms, p99 {out[family]['p99_ms']:.2f} ms, {batches} batches (mean "
              f"{out[family]['mean_batch']:.2f} queries), {out[family]['queries_per_s']:.0f} requests/s; /search = "
              f"search, /health corpus {health['corpus_size']}")
    return out


def phase_refresh(workdir, services, corpus_dir, topics, device="cuda", shape=P16):
    """16b, last: 256 seeded docs added and 128 deleted, then ``refresh()`` of
    the BM25, ColBERT, bf16 dense and uniCOIL services: merge s, docs encoded
    (exactly the added ones, K2 in that encoding), refresh s; deleted docs
    absent from the hits; 8 queries' hits equal a new service's over the new
    generation (reading the caches the refresh wrote)."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.serving import (ColbertRetrievalService, DenseRetrievalService, ImpactRetrievalService,
                                             RetrievalService)

    added = [(f"N16_{i:05d}", text) for i, (_, text) in enumerate(build_corpus(
        shape["added"], num_topics=shape["added"] // 120, seed=16, min_len=200, max_len=1200)[0])]
    queries = list(topics[:shape["queries"]]) + [" ".join(added[0][1].split()[:6])]
    out, launches, k2_errs = {}, {}, {}
    ops_done = set()
    for family in ("colbert", "bm25", "dense", "unicoil"):
        svc, base = services[family]
        constants["CACHE_BASE_PATH"] = base
        index = svc.index if hasattr(svc, "index") else svc.searcher.index
        docids = list(index.data.docid_strings)
        rng = np.random.Generator(np.random.PCG64(16))
        deleted = sorted(docids[i] for i in rng.choice(len(docids), size=shape["deleted"], replace=False))
        merge_s = 0.0
        if str(index.get_index_path()) not in ops_done:  # one set of ops per index directory
            index.add_documents(added)
            index.delete_documents(deleted)
            t0 = time.perf_counter()
            index.refresh()
            merge_s = time.perf_counter() - t0
            ops_done.add(str(index.get_index_path()))
        encoded0 = getattr(getattr(svc, "searcher", None), "docs_encoded", 0)
        reset_launch_counts()
        t0 = time.perf_counter()
        changed = svc.refresh()
        sync(device)
        refresh_s = time.perf_counter() - t0
        launched = launch_counts()
        launches[family] = launched
        encoded = getattr(getattr(svc, "searcher", None), "docs_encoded", 0) - encoded0
        check(changed is True, f"16b {family}: refresh() returned {changed}")
        check(len(svc._docids) == len(docids) + shape["added"] - shape["deleted"],
              f"16b {family}: {len(svc._docids)} docs served after the refresh")
        if family != "bm25":
            check(encoded == shape["added"], f"16b {family}: {encoded} docs encoded, not the {shape['added']} added")
            batch = int(svc.searcher.config["batch"])
            want_k2 = 12 * -(-shape["added"] // batch)
            check(device != "cuda" or launched["flash_attention"] == want_k2,
                  f"16b {family}: K2 launched {launched['flash_attention']} times encoding {encoded} docs "
                  f"(expected {want_k2})")
        hits = svc.search(queries, k=100)
        gone = set(deleted) & {d for h in hits for d, _ in h}
        check(not gone, f"16b {family}: deleted docs served: {sorted(gone)[:5]}")
        found = any(d == added[0][0] for d, _ in hits[-1][:10])  # seeded weights: BM25's alone is certain
        check(family != "bm25" or found, f"16b {family}: an added doc's own words do not find it in the top 10")
        # a new service over the new generation reads the caches the refresh wrote
        if family == "bm25":
            fresh = RetrievalService.from_config(collection="dummy", collection_path=corpus_dir, device=device)
        elif family == "dense":
            fresh = DenseRetrievalService(dense_searcher(dict(svc.searcher.config), device, encoder_of=svc.searcher),
                                          max_k=svc.max_k, device=device)
        elif family == "colbert":
            fresh = ColbertRetrievalService(colbert16(dict(svc.searcher.config), encoder_of=svc.searcher,
                                                      device=device), max_k=svc.max_k, device=device)
        else:
            from capreolus_tpu_torch.searcher import Searcher

            s = Searcher.create("impact", dict(svc.searcher.config))
            s.device, s._enc, s._random_init = device, svc.searcher._encoder(), svc.searcher._random_init
            fresh = ImpactRetrievalService(s, device=device)
        fresh_encoded = getattr(getattr(fresh, "searcher", None), "docs_encoded", 0)
        check(fresh_encoded == 0, f"16b {family}: the new service encoded {fresh_encoded} docs")
        same = fresh.search(queries, k=100) == hits
        check(same, f"16b {family}: hits differ from a new service's over the new generation")
        if family == "dense" and device == "cuda":  # K2 on the encoding of added docs, at layer 0
            searcher = svc.searcher
            texts = [text for _, text in added[: searcher.config["batch"]]]
            hold_k2_layer0(searcher._encoder(), lambda: searcher.encode(*searcher._tokenize(texts, 256)),
                           "16b added docs", k2_errs)
        out[family] = {"merge_s": merge_s, "refresh_s": refresh_s, "docs_encoded": encoded,
                       "docs": len(svc._docids), "equal_new_service": same, "added_doc_in_top10": found}
        print(f"[16b refresh {family}] merge {merge_s:.2f} s, refresh {refresh_s:.2f} s, {encoded} docs encoded "
              f"(K2 {launched['flash_attention']}), {len(svc._docids)} docs served; deleted docs absent; "
              f"{len(queries)} queries' hits = a new service's over the new generation")
        del fresh
    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")
    out["k2_max_abs_err"] = k2_errs
    return out, launches


def phase_serving_families(workdir, corpus_dir, topics, none, peaks, device="cuda", shape=P16):
    """Phase 16: the ColBERT options (16a), snippets (16c), the HTTP front end
    (16d) and, last, NRT refresh (16b). Returns the summary with the launches."""
    t0 = time.perf_counter()
    seconds = {}

    def timed16(label, fn, *args, **kwargs):
        t1 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[label] = round(time.perf_counter() - t1, 1)
        print(f"[{label} done] {seconds[label]} s")
        return result

    options, option_launches, held = timed16("16a", phase_colbert_options, workdir, corpus_dir, topics, none, peaks,
                                             device=device, shape=shape)
    services = timed16("16 services", phase16_services, workdir, corpus_dir, none, device=device)
    snippets = timed16("16c", phase_snippets, services, corpus_dir, topics, shape=shape)
    http = timed16("16d", phase_http, services, corpus_dir, topics, shape=shape)
    refresh, refresh_launches = timed16("16b", phase_refresh, workdir, services, corpus_dir, topics, device=device,
                                        shape=shape)
    summary = {"colbert_options": options, "held": held, "snippets": snippets, "http": http, "refresh": refresh,
               "launches": {"options": option_launches, "refresh": refresh_launches},
               "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    print(f"[16 serving families] {smi_line() if device == 'cuda' else device}: every sub-phase passed in "
          f"{summary['seconds']:.1f} s ({json.dumps(seconds)}); summary " + json.dumps(summary, default=str))
    return summary


def add_phase16_launches(kernels, p16):
    """Phase 16's K2, K3, X1 and MaxSim epilogue launches in its served runs
    (16a's prefilter and streamed requests, 16b's refresh encoding) and the
    kernels' errors on its inputs, into the ``kernels`` line."""
    runs = {**p16["launches"]["options"], **{f"refresh_{k}": v for k, v in p16["launches"]["refresh"].items()}}
    for entry in kernels:
        name = entry["name"]
        if name not in ("flash_attention", "maxsim", "int8_matmul", "maxsim_epilogue"):
            continue
        total = sum(launches[name] for launches in runs.values())
        entry["launches"] += total
        entry["launches_phase16"] = {"served": total, "by_path": {k: v[name] for k, v in runs.items() if v[name]}}
    held = p16["held"]
    kernels[1]["max_abs_err_phase16_refresh"] = p16["refresh"]["k2_max_abs_err"]
    kernels[2]["phase16"] = {key: {k: held[key][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                             "bound_by")}
                             for key in ("k3_prefilter", "k3_streamed_slice")}
    kernels[3]["equal_plain_phase16"] = {key: held[key] for key in ("x1_prefilter_equal", "x1_streamed_equal")}


P17 = {  # phase 17's counts (none crosses a dispatch threshold)
    "shards": 4, "bm25_queries": 2048, "bm25_batch": 256, "bm25_k": 1000, "bm25_compared": 512,
    "dense_queries": 8, "dense_batch": 128, "colbert_queries": 4, "colbert_batch": 64,
    "metrics_queries": 1000, "metrics_depth": 1000, "scale_queries": 128,
}
SHARDED_RTOL = 1e-5  # bf16 dense and BM25, sharded vs the resident engine: f32 sums of one doc's terms (BM25's
# tree sum over shifted runs in both; the bf16 product in blocks of one shape) may round apart
DEVICE_METRIC_TOL = 1e-5  # device metrics (f32) vs the host's (f64), the JAX suite's tolerance
METRICS17 = ["map", "recip_rank", "MRR@10", "ndcg_cut_5", "ndcg_cut_20", "ndcg_cut_1000", "P_5", "P_10", "recall_10",
             "recall_100", "recall_1000"]


class SyntheticSparseIndex:
    """Phase 10's synthetic postings as a served index: term i is the word
    ``t<i>``, doc ordinal d the docid ``S<d>`` (the corpus has no text)."""

    def __init__(self, data):
        data.docid_strings = [f"S{d:06d}" for d in range(data.num_docs)]
        data.vocab = {f"t{i}": i for i in range(data.num_terms)}
        self.data = data

    def create_index(self):
        pass

    def analyze(self, text):
        return text.split()


def hit_arrays(hits, k, ordinal, missing):
    """[(docid, score)] lists -> (scores, ordinals) [Q, k] arrays, padded with
    -1 and ``missing``, for ``ranking_rows_faults``."""
    scores = np.full((len(hits), k), -1.0, np.float32)
    ords = np.full((len(hits), k), missing, np.int64)
    for i, row in enumerate(hits):
        scores[i, : len(row)] = [s for _, s in row]
        ords[i, : len(row)] = [ordinal(d) for d, _ in row]
    return scores, ords


def served_qps(svc, texts, k, passes=2):
    """(best queries/s over ``passes`` passes of every text, the hits of the last pass)."""
    svc.search(texts[: svc.batch_size], k=k)  # warm-up
    walls, hits = [], None
    for _ in range(passes):
        t0 = time.perf_counter()
        hits = svc.search(texts, k=k)
        walls.append(time.perf_counter() - t0)
    return len(texts) / min(walls), hits


def engine_ms_per_batch(batches, dispatch, collect):
    """ms per batch of a pipelined pass of the engine alone: every batch
    dispatched, then every result copied to the host (no hit lists)."""
    collect(dispatch(batches[0]))  # warm-up
    t0 = time.perf_counter()
    for result in [dispatch(b) for b in batches]:
        collect(result)
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def phase17_bm25(workdir, device, shape, shards):
    """17a: ``RetrievalService(shards=4)`` over phase 10's uniform 200k-doc
    corpus at bench.py's query recipe, 256-query batches at k 1000: queries/s
    beside the single-device service's, and each engine's pipelined pass
    alone (the service's hit lists are host Python); the first batches'
    rankings held to it, no port kernel launched."""
    from capreolus_tpu_torch.index.synth import synth_uniform_index
    from capreolus_tpu_torch.parallel.sharded_search import sharded_search
    from capreolus_tpu_torch.searcher.tpu import fetch
    from capreolus_tpu_torch.serving import RetrievalService

    n, v, u = SPARSE["num_docs"], SPARSE["num_terms"], SPARSE["avg_unique"]
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sparse")
    os.makedirs(cache_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = synth_uniform_index(n, v, u, seed=SPARSE["uniform_seed"],
                               cache_fn=os.path.join(cache_dir, f"uniform_{n}_{v}_{SPARSE['uniform_seed']}.npz"))
    index = SyntheticSparseIndex(data)
    terms = sparse_queries(data, SPARSE["query_seed"], shape["bm25_queries"], SPARSE["terms"], n)
    texts = [" ".join(f"t{t}" for t, _ in q) for q in terms]
    load_s = time.perf_counter() - t0
    k, batch = shape["bm25_k"], shape["bm25_batch"]
    t0 = time.perf_counter()
    single = RetrievalService(index, params=SPARSE_PARAMS, batch_size=batch, device=device)
    single_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = RetrievalService(index, params=SPARSE_PARAMS, batch_size=batch, shards=shards, device=device,
                               devices=[device] * shards)
    sync(device)
    sharded_setup = time.perf_counter() - t0
    reset_launch_counts()
    sharded_qps, sharded_hits = served_qps(sharded, texts, k)
    launched = {name: c for name, c in launch_counts().items() if c}
    check(not launched, f"17a: sharded BM25 launched a port kernel: {launched}")
    single_qps, single_hits = served_qps(single, texts, k)
    batches = [terms[i : i + batch] for i in range(0, len(terms), batch)]
    sindex = sharded._sindex
    sharded_engine_ms = engine_ms_per_batch(
        batches, lambda b: sharded_search(sindex, sindex.build_work_units(b), len(b), k, params=SPARSE_PARAMS,
                                          materialize=False), lambda r: (r[0].cpu(), r[1].cpu()))
    single_engine_ms = engine_ms_per_batch(
        batches, lambda b: single.engine.search_pruned(b, model="bm25", params=SPARSE_PARAMS, topk=k,
                                                       materialize=False), fetch)
    m = shape["bm25_compared"]
    ordinal = lambda d: int(d[1:])  # noqa: E731
    got = hit_arrays(sharded_hits[:m], k, ordinal, n)
    want = hit_arrays(single_hits[:m], k, ordinal, n)
    faults = ranking_rows_faults(got, want, SHARDED_RTOL)
    check(not faults, f"17a: sharded BM25 vs the single-device service: {faults}")
    matched = want[0] > 0
    rel = float(np.max(np.abs(got[0][matched] - want[0][matched]) / want[0][matched])) if matched.any() else 0.0
    swapped = int((got[1] != want[1]).sum())
    out = {"docs": n, "postings": int(len(data.doc_ids)), "queries": len(texts), "batch": batch, "k": k,
           "qps_sharded": sharded_qps, "qps_single": single_qps, "setup_sharded_s": sharded_setup,
           "setup_single_s": single_setup, "load_s": load_s, "engine_ms_per_batch_sharded": sharded_engine_ms,
           "engine_ms_per_batch_single": single_engine_ms, "compared_queries": m, "max_rel_score_diff": rel,
           "positions_at_near_ties": swapped, "docs_per_shard": sharded._sindex.docs_per_shard,
           "tiles_per_shard": sharded._sindex.n_tiles}
    print(f"[17a sharded bm25] {smi_line() if device == 'cuda' else device}: {n} docs ({out['postings']} postings) over "
          f"{shards} shards on one card ({sharded._sindex.n_tiles} tiles each); {len(texts)} queries in batches of "
          f"{batch} at k {k}: {sharded_qps:.1f} queries/s sharded, {single_qps:.1f} single-device through the "
          f"services (set-up {sharded_setup:.2f} s / {single_setup:.2f} s); the engines alone, pipelined: "
          f"{sharded_engine_ms:.2f} ms a batch sharded, {single_engine_ms:.2f} single-device (pruned, adaptive); "
          f"{m} queries' rankings = the single-device service's "
          f"(max rel score diff {rel:.3g}; {swapped} positions at near-ties); no port kernel launched")
    return out


def phase17_rerank_refresh(workdir, corpus_dir, topics, knrm, device, shards):
    """17b: one ``RerankingService`` request over a sharded first stage
    (phase 4's KNRM and its extractor state; K1 once), equal to the
    single-device service's; then a ``refresh()`` under shards after one
    added and one deleted doc (on phase 16b's merged generation): the added
    doc served, the deleted one gone, hits equal to a single-device service
    over the new generation."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.serving import RerankingService, RetrievalService

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")  # phase 4's index
    coll = {"name": "dummy", "path": corpus_dir}
    index = Index.create("tpu", {"collection": coll})
    index.create_index()
    reranker, ckpt = knrm
    devices = [device] * shards
    sharded_rr = RerankingService(index, reranker, ckpt, topn=100, device=device, shards=shards, devices=devices)
    single_rr = RerankingService(index, reranker, ckpt, topn=100, device=device)
    query = topics[0]
    first_sh = RetrievalService.search_async(sharded_rr, [query], k=100)()[0]
    first_si = RetrievalService.search_async(single_rr, [query], k=100)()[0]
    check([d for d, _ in first_sh] == [d for d, _ in first_si], "17b: the sharded first stage's top 100 differ")
    rel = max(abs(a - b) / b for (_, a), (_, b) in zip(first_sh, first_si))
    check(rel <= SHARDED_RTOL, f"17b: sharded first-stage scores {rel:.3g} from the single-device service's")
    single_rr.search([query], k=10)  # warm-up of the single service's path
    reset_launch_counts()
    t0 = time.perf_counter()
    got = sharded_rr.search([query], k=10)[0]
    request_ms = (time.perf_counter() - t0) * 1e3
    launched = launch_counts()
    want = single_rr.search([query], k=10)[0]
    check(got == want, f"17b: reranked top 10 over the sharded first stage {got[:3]} != {want[:3]}")
    check(launched["knrm_pool"] == 1, f"17b: K1 launched {launched['knrm_pool']} times in one request")

    svc = RetrievalService(index, shards=shards, device=device, devices=devices)
    added = ("N17_00000", "quokka numbat wombat quokka " + " ".join(query.split()[:3]))
    deleted = index.data.docid_strings[1]
    index.add_documents([added])
    index.delete_documents([deleted])
    t0 = time.perf_counter()
    index.refresh()
    merge_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    changed = svc.refresh()
    sync(device)
    refresh_s = time.perf_counter() - t0
    check(changed is True, f"17b: refresh() under shards returned {changed}")
    hits = svc.search(["quokka numbat wombat", query], k=100)
    check(hits[0] and hits[0][0][0] == added[0], f"17b: the added doc is not served first: {hits[0][:3]}")
    check(deleted not in {d for h in hits for d, _ in h} and deleted not in svc._docids,
          "17b: the deleted doc is still served")
    fresh = RetrievalService(index, device=device).search(["quokka numbat wombat", query], k=100)
    check([[d for d, _ in h] for h in hits] == [[d for d, _ in h] for h in fresh],
          "17b: hits after the refresh differ from a single-device service over the new generation")
    out = {"rerank_request_ms": request_ms, "first_stage_max_rel_diff": rel, "launches": launched,
           "merge_s": merge_s, "refresh_s": refresh_s, "docs": len(svc._docids)}
    print(f"[17b sharded rerank, refresh] reranked request over {shards} shards {request_ms:.2f} ms, its top 10 = "
          f"the single-device service's (first-stage top 100 identical, max rel diff {rel:.3g}; K1 once); refresh "
          f"under shards after 1 added and 1 deleted doc: merge {merge_s:.2f} s, refresh {refresh_s:.2f} s; the "
          f"added doc served first, the deleted one gone, hits = a single-device service's")
    return out, launched


def hold_sharded_engine(label, sharded, resident, q, exact_scores):
    """The sharded engine's top k against the resident engine's on the same
    query embeddings: ordinals identical, scores bit for bit (``exact_scores``)
    or within SHARDED_RTOL. Returns the max relative score difference."""
    gs, go = sharded._topk(q, *sharded._corpus)
    ws, wo = resident._topk(q, *resident._corpus)
    check(torch.equal(go.cpu(), wo.cpu()), f"{label}: sharded ordinals differ from the resident engine's")
    gs, ws = gs.float().cpu(), ws.float().cpu()
    finite = torch.isfinite(ws)
    check(torch.equal(torch.isfinite(gs), finite), f"{label}: -inf slots differ from the resident engine's")
    rel = float(((gs[finite] - ws[finite]).abs() / ws[finite].abs().clamp_min(1e-30)).max()) if finite.any() else 0.0
    check(rel == 0.0 if exact_scores else rel <= SHARDED_RTOL,
          f"{label}: sharded scores {rel:.3g} from the resident engine's ({'bit for bit' if exact_scores else SHARDED_RTOL})")
    return rel


def time_service(svc, queries, batch):
    single_ms, spread = timed_requests(svc, queries)
    t0 = time.perf_counter()
    svc.search(batch, k=10)
    return single_ms, spread, (time.perf_counter() - t0) * 1e3


def phase17_dense(workdir, corpus_dir, topics, device, shape, shards):
    """17c: ``DenseRetrievalService`` at BERT-base over phase 15's cache of
    phase 4's corpus (the generation 16b merged), bf16 and int8, sharded and
    resident: one query (median of 8) and a 128-query batch; the sharded
    engines held to the resident ones (int8 bit for bit); X1 once per shard
    and query batch in int8."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.serving import DenseRetrievalService

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache")
    cfg = {"pretrained": os.path.join(workdir, "bert_mlm_15"), "index": {"collection": {"name": "dummy",
                                                                                        "path": corpus_dir}}}
    queries = list(topics[: shape["dense_queries"]])
    batch = [topics[i % len(topics)] for i in range(shape["dense_batch"])]
    encoder = dense_searcher(cfg, device)
    out, launches = {}, {}
    for qmode in ("none", "int8"):
        opts = {} if qmode == "none" else {"quantize": "int8"}
        resident = DenseRetrievalService(dense_searcher({**cfg, **opts}, device, encoder_of=encoder),
                                         max_k=DENSE_HITS, device=device)
        searcher = dense_searcher({**cfg, **opts, "shards": shards}, device, encoder_of=encoder)
        searcher.devices = [device] * shards
        t0 = time.perf_counter()
        sharded = DenseRetrievalService(searcher, max_k=DENSE_HITS, device=device)
        sync(device)
        setup_s = time.perf_counter() - t0
        check(searcher.docs_encoded == 0 and resident.searcher.docs_encoded == 0,
              f"17c {qmode}: documents were encoded; phase 15's cache holds them")
        reset_launch_counts()
        single_ms, spread, batch_ms = time_service(sharded, queries, batch)
        launched = launch_counts()
        launches[f"dense_{qmode}"] = launched
        requests = 2 + len(queries)
        check(launched["flash_attention"] == 12 * requests, f"17c {qmode}: K2 launched {launched['flash_attention']}")
        check((launched["int8_matmul"] >= shards * requests) if qmode == "int8" else launched["int8_matmul"] == 0,
              f"17c {qmode}: X1 launched {launched['int8_matmul']} times over {requests} query batches")
        r_single, _, r_batch = time_service(resident, queries, batch)
        rel = hold_sharded_engine(f"17c dense {qmode}", sharded, resident, sharded._embed_batch(batch[:32]),
                                  exact_scores=qmode == "int8")
        out[qmode] = {"setup_s": setup_s, "single_ms": single_ms, "single_spread_ms": spread, "batch128_ms": batch_ms,
                      "resident_single_ms": r_single, "resident_batch128_ms": r_batch, "max_rel_diff": rel,
                      "launches": launched}
        print(f"[17c sharded dense {qmode}] {smi_line() if device == 'cuda' else device}: {len(sharded._docids)} docs "
              f"over {shards} shards: one query {single_ms:.2f} ms (spread {spread[0]:.2f}-{spread[1]:.2f}; resident "
              f"{r_single:.2f}), 128 queries {batch_ms:.2f} ms (resident {r_batch:.2f}); set-up {setup_s:.2f} s; "
              f"top 1000 = the resident engine's ({'bit for bit' if qmode == 'int8' else f'max rel diff {rel:.3g}'}); "
              f"launches {launched}")
        del sharded, resident, searcher
    return out, launches


def phase17_dense_scale(workdir, device, shape, shards):
    """17c': phase 15b's 1M x 768 matrix (its cache) over 4 shards, 128
    queries at k 1000 in bf16: the batch, each shard's product and top-k and
    the merge timed apart, held to the resident engine."""
    from capreolus_tpu_torch.parallel.sharded_search import merge_shard_candidates
    from capreolus_tpu_torch.searcher.dense import _dense_scores, score_block
    from capreolus_tpu_torch.searcher.streamed import topk_lower_ordinal_first

    n, dim, hits = SCALE["docs"], SCALE["dim"], SCALE["hits"]
    index = SyntheticDenseIndex(n, os.path.join(workdir, "dense_scale"))
    resident = dense_searcher({"pretrained": "tiny"}, device, index)
    r_topk, r_docs, _ = resident.build_topk(hits)
    searcher = dense_searcher({"pretrained": "tiny", "shards": shards}, device, index)
    searcher.devices = [device] * shards
    t0 = time.perf_counter()
    topk, parts, n_corpus = searcher.build_topk(hits)
    sync(device)
    setup_s = time.perf_counter() - t0
    g = torch.Generator(device="cpu").manual_seed(SCALE["seed"] + 17)
    q = torch.nn.functional.normalize(torch.randn((shape["scale_queries"], dim), generator=g), dim=1).to(device)
    reset_launch_counts()
    scores, ords = topk(q, parts)
    sync(device)
    launched = launch_counts()
    check(not any(launched.values()), f"17c 1M: the bf16 engine launched a port kernel: {launched}")
    want_s, want_o = r_topk(q, r_docs)
    check(torch.equal(ords.cpu(), want_o.cpu()), "17c 1M: sharded ordinals differ from the resident engine's")
    rel = float(((scores - want_s).abs() / want_s.abs().clamp_min(1e-30)).max())
    check(rel <= SHARDED_RTOL, f"17c 1M: sharded scores {rel:.3g} from the resident engine's")
    per, block = -(-n // shards), score_block(n)
    local_k = min(hits, per)
    part_scores = [_dense_scores(q, part, block)[:, :per] for part in parts]
    cands = [(sv, so + i * per) for i, (sv, so) in enumerate(topk_lower_ordinal_first(s, local_k) for s in part_scores)]

    def merge():
        return merge_shard_candidates(cands, hits, device)

    if device == "cuda":
        out = {"batch_ms": cuda_ms(lambda: topk(q, parts), rounds=3, calls=2),
               "resident_batch_ms": cuda_ms(lambda: r_topk(q, r_docs), rounds=3, calls=2),
               "shard_product_ms": [cuda_ms(lambda p=p: _dense_scores(q, p, block), rounds=3, calls=2) for p in parts],
               "shard_topk_ms": [cuda_ms(lambda s=s: topk_lower_ordinal_first(s, local_k), rounds=3, calls=2)
                                 for s in part_scores],
               "merge_ms": cuda_ms(merge, rounds=3, calls=2)}
    else:
        out = {}
    out.update(setup_s=setup_s, max_rel_diff=rel, docs_per_shard=per, rows_per_shard=int(parts[0].shape[0]))
    print(f"[17c sharded dense 1M] {smi_line() if device == 'cuda' else device}: {n} x {dim} over {shards} shards "
          f"on one card, {shape['scale_queries']} queries at k {hits}: "
          + (f"{out['batch_ms']:.2f} ms (resident {out['resident_batch_ms']:.2f}); per shard product "
             f"{out['shard_product_ms'][0]:.3f} ms, top {local_k} {out['shard_topk_ms'][0]:.3f} ms; merge "
             f"{out['merge_ms']:.3f} ms; " if device == "cuda" else "")
          + f"set-up {setup_s:.2f} s; top {hits} = the resident engine's (max rel diff {rel:.3g})")
    del parts, r_docs, part_scores, cands
    return out


def phase17_colbert(workdir, corpus_dir, topics, none, peaks, device, shape, shards):
    """17d: ColBERT over phase 6's cache (the generation 16b merged), bf16
    (K3 once per shard and query batch) and int8 (X1), sharded and resident:
    one query (median of 4) and phase 6's 64-query batch; sharded scores
    equal to the resident engine's bit for bit; K3 and X1 on shard 0 against
    their plain versions, timed."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    from capreolus_tpu_torch.ops.quantization import quantize_rows_torch
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_colbert")
    cfg = {**COLBERT, "pretrained": "bert-base-uncased", "allowrandominit": True, "checkpointfile": none["ckpt"],
           "index": {"collection": {"name": "dummy", "path": corpus_dir}}}
    queries, batch = list(topics[: shape["colbert_queries"]]), list(none["batch"])[: shape["colbert_batch"]]
    encoder = colbert16(cfg, device=device)
    out, launches, held = {}, {}, {}
    for qmode in ("none", "int8"):
        opts = {} if qmode == "none" else {"quantize": "int8"}
        resident = ColbertRetrievalService(colbert16({**cfg, **opts}, encoder_of=encoder, device=device), max_k=100,
                                           device=device)
        searcher = colbert16({**cfg, **opts, "shards": shards}, encoder_of=encoder, device=device)
        searcher.devices = [device] * shards
        t0 = time.perf_counter()
        sharded = ColbertRetrievalService(searcher, max_k=100, device=device)
        sync(device)
        setup_s = time.perf_counter() - t0
        check(searcher.docs_encoded == 0, f"17d {qmode}: documents were encoded; phase 6's cache holds them")
        reset_launch_counts()
        single_ms, spread, batch_ms = time_service(sharded, queries, batch)
        launched = launch_counts()
        launches[f"colbert_{qmode}"] = launched
        requests = 2 + len(queries)
        check(launched["maxsim"] == (shards * requests if qmode == "none" else 0),
              f"17d {qmode}: K3 launched {launched['maxsim']} times over {requests} query batches on {shards} shards")
        check((launched["int8_matmul"] >= shards * requests) if qmode == "int8" else launched["int8_matmul"] == 0,
              f"17d {qmode}: X1 launched {launched['int8_matmul']} times over {requests} query batches")
        check(launched["maxsim_epilogue"] == launched["int8_matmul"],
              f"17d {qmode}: the MaxSim epilogue launched {launched['maxsim_epilogue']} times, X1 "
              f"{launched['int8_matmul']}")
        r_single, _, r_batch = time_service(resident, queries, batch)
        q = searcher.encode_queries(searcher._tokenize(batch, COLBERT["maxqlen"]))
        hold_sharded_engine(f"17d colbert {qmode}", sharded, resident, q, exact_scores=True)
        part = sharded._corpus[0]  # shard 0's docs
        q1 = q[:1]
        if qmode == "none" and device == "cuda":
            held["k3_shard0"] = k3_measure(q1, *part, peaks)
        elif device == "cuda":
            q_codes = quantize_rows_torch(q1)[0].reshape(-1, COLBERT["dim"])
            d_codes = part[0].reshape(-1, COLBERT["dim"])
            equal = bool(torch.equal(int8_matmul(q_codes, d_codes), int8_matmul_plain(q_codes, d_codes)))
            check(equal, "17d: X1 differs from its plain version on shard 0's codes")
            bound, by = x1_bound_ms(q_codes.shape[0], COLBERT["dim"], d_codes.shape[0], peaks)
            held["x1_shard0"] = {"shape": f"M={q_codes.shape[0]} K={COLBERT['dim']} N={d_codes.shape[0]}",
                                 "max_abs_err": 0, "equal_plain": equal,
                                 "ms": cuda_ms(lambda: int8_matmul(q_codes, d_codes), rounds=5, calls=4),
                                 "plain_ms": cuda_ms(lambda: int8_matmul_plain(q_codes, d_codes), rounds=2, calls=1),
                                 "library_ms": cuda_ms(lambda: torch._int_mm(q_codes, d_codes.T), rounds=5, calls=4),
                                 "bound_ms": bound, "bound_by": by}
        out[qmode] = {"setup_s": setup_s, "single_ms": single_ms, "single_spread_ms": spread, "batch64_ms": batch_ms,
                      "resident_single_ms": r_single, "resident_batch64_ms": r_batch, "launches": launched,
                      "docs_per_shard": [int(p[0].shape[1] if qmode == "none" else p[0].shape[0])
                                         for p in sharded._corpus if p is not None]}
        print(f"[17d sharded colbert {qmode}] {smi_line() if device == 'cuda' else device}: {len(sharded._docids)} docs "
              f"over {shards} shards ({out[qmode]['docs_per_shard']}): one query {single_ms:.2f} ms (spread "
              f"{spread[0]:.2f}-{spread[1]:.2f}; resident {r_single:.2f}), {len(batch)} queries {batch_ms:.2f} ms "
              f"(resident {r_batch:.2f}); set-up {setup_s:.2f} s; scores = the resident engine's bit for bit; "
              f"launches {launched}")
        del sharded, resident, searcher, part
    if "k3_shard0" in held:
        print(k3_line("[17d K3 shard 0]", held["k3_shard0"]))
    if "x1_shard0" in held:
        x = held["x1_shard0"]
        print(f"[17d X1 shard 0] {x['shape']}: equal to plain, {x['ms']:.4f} ms (torch._int_mm {x['library_ms']:.4f}, "
              f"plain {x['plain_ms']:.3f}, bound {x['bound_ms']:.4f} by {x['bound_by']})")
    return out, launches, held


def synthetic_experiment(nq, depth, seed=17, num_docs=200_000):
    """(qrels, runs) of ``nq`` queries ranked ``depth`` deep, 50 judged docs
    a query (30 of them retrieved), grades 0-2."""
    rng = np.random.Generator(np.random.PCG64(seed))
    runs, qrels = {}, {}
    for q in range(nq):
        docs = rng.choice(num_docs, size=depth, replace=False)
        runs[f"q{q}"] = {f"d{d}": float(s) for d, s in zip(docs, rng.random(depth))}
        judged = np.concatenate([docs[rng.choice(depth, size=min(30, depth), replace=False)],
                                 rng.choice(num_docs, size=20)])
        qrels[f"q{q}"] = {f"d{d}": int(rng.integers(0, 3)) for d in judged}
    return qrels, runs


def phase17_metrics(validations, device, shape):
    """17e: device metrics against the host's on a 1000-query x 1000-deep
    synthetic run, both timed; phase 9's validations that took the device path."""
    from capreolus_tpu_torch.evaluation import eval_runs
    from capreolus_tpu_torch.evaluation.device_metrics import eval_runs_device

    qrels, runs = synthetic_experiment(shape["metrics_queries"], shape["metrics_depth"])
    eval_runs_device(runs, qrels, METRICS17[:2], device=device)  # warm-up
    t0 = time.perf_counter()
    dev = eval_runs_device(runs, qrels, METRICS17, device=device)
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = eval_runs(runs, qrels, METRICS17)
    host_s = time.perf_counter() - t0
    err = max(abs(dev[m] - host[m]) for m in METRICS17)
    check(err <= DEVICE_METRIC_TOL, f"17e: device metrics {err:.3g} from the host's")
    check(validations["phase9"]["device"] > 0 and validations["phase9"]["host"] == 0,
          f"17e: phase 9's validations {validations['phase9']}: every one should take the device path")
    out = {"device_s": device_s, "host_s": host_s, "max_abs_diff": err, "validations": validations}
    print(f"[17e device metrics] {shape['metrics_queries']} queries x {shape['metrics_depth']} deep, "
          f"{len(METRICS17)} metrics: device {device_s:.3f} s, host {host_s:.3f} s, max |diff| {err:.3g} "
          f"(tolerance {DEVICE_METRIC_TOL}); phase 9's validations on the device: {validations['phase9']['device']} "
          f"of {validations['phase9']['device'] + validations['phase9']['host']}")
    return out


CKPT17_PRETRAINED = "bert-base-uncased"  # 17f's reranker width (seeded init)


def phase17_checkpoint(workdir, device):
    """17f: one ``trainer.ckpt=sharded_async`` save and resume of a BERT-base
    reranker with a populated Adam state: the time the caller is blocked
    against the writer's, the bytes written, weights and Adam state equal
    after the resume."""
    import copy

    from capreolus_tpu_torch.reranker import Reranker

    rr = Reranker.create("BERTMaxP", {"pretrained": CKPT17_PRETRAINED, "allowrandominit": True,
                                      "trainer": {"ckpt": "sharded_async"}})
    trainer = rr.trainer
    trainer.device = device
    model = rr.init_params(17).to(device)
    optimizer = trainer.make_optimizer(rr, model)
    g = torch.Generator(device=device).manual_seed(17)
    for p in model.parameters():  # one Adam step from seeded gradients: the state holds every tensor
        if p.requires_grad:
            p.grad = torch.randn(p.shape, generator=g, device=device) * 1e-3
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    path = Path(workdir) / "ckpt17" / "dev.best"
    sync(device)
    t0 = time.perf_counter()
    written = trainer.save_checkpoint(path, model, optimizer, rr)
    blocked_s = time.perf_counter() - t0
    trainer._wait_for_checkpoints()
    writer_s = time.perf_counter() - t0
    done = path.parent / "dev.best.done"
    check(done.exists(), "17f: no done file after the writes")
    on_disk = sum(f.stat().st_size for d in ("dev.best.params.shards", "dev.best.optstate.shards")
                  for f in (path.parent / d).iterdir())
    fresh = copy.deepcopy(model)
    fresh_opt = trainer.make_optimizer(rr, fresh)
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(1.0)
    t0 = time.perf_counter()
    trainer.load_checkpoint(path, fresh, fresh_opt, rr)
    sync(device)
    load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    check(same, "17f: weights differ after the resume")
    want, got = optimizer.state_dict()["state"], fresh_opt.state_dict()["state"]
    same_opt = all(torch.equal(want[i][k].cpu(), got[i][k].cpu()) for i in want for k in want[i])
    check(same_opt and len(want) == len(got), "17f: Adam's state differs after the resume")
    out = {"bytes_written": written, "bytes_on_disk": on_disk, "blocked_s": blocked_s, "writer_s": writer_s,
           "load_s": load_s, "params": sum(p.numel() for p in model.parameters())}
    print(f"[17f sharded checkpoint] BERT-base reranker ({out['params']} parameters) and Adam, ckpt=sharded_async: "
          f"the caller blocked {blocked_s:.3f} s (host snapshot), the writer done after {writer_s:.3f} s; "
          f"{written / 1e9:.3f} GB of leaves ({on_disk / 1e9:.3f} GB on disk); resume {load_s:.3f} s, weights and "
          f"Adam state equal")
    shutil.rmtree(path.parent, ignore_errors=True)
    del model, fresh, optimizer, fresh_opt
    return out


def phase_sharded_serving(workdir, corpus_dir, topics, none, knrm, validations, peaks, device="cuda", shape=P17):
    """Phase 17: doc-sharded serving over 4 shards on one card (BM25, its
    reranking and refresh, dense at 20k and 1M docs, ColBERT), device metrics
    and a sharded asynchronous checkpoint. Returns the summary with the launches."""
    t0 = time.perf_counter()
    shards = shape["shards"]
    seconds = {}

    def timed17(label, fn, *args, **kwargs):
        t1 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[label] = round(time.perf_counter() - t1, 1)
        print(f"[{label} done] {seconds[label]} s")
        return result

    print(f"[17 sharded serving] {shards} shards share one card ({device}): no copy between cards is measured; "
          f"each shard's work is launched before any result is copied, and the merge runs on the first device")
    bm25 = timed17("17a", phase17_bm25, workdir, device, shape, shards)
    dense, dense_launches = timed17("17c", phase17_dense, workdir, corpus_dir, topics, device, shape, shards)
    scale = timed17("17c 1M", phase17_dense_scale, workdir, device, shape, shards)
    colbert, colbert_launches, held = timed17("17d", phase17_colbert, workdir, corpus_dir, topics, none, peaks,
                                              device, shape, shards)
    metrics = timed17("17e", phase17_metrics, validations, device, shape)
    ckpt = timed17("17f", phase17_checkpoint, workdir, device)
    # last: its refresh changes phase 4's index, whose caches 17c reads
    rerank, rerank_launches = timed17("17b", phase17_rerank_refresh, workdir, corpus_dir, topics, knrm, device, shards)
    summary = {"bm25": bm25, "rerank_refresh": rerank, "dense": dense, "dense_1m": scale, "colbert": colbert,
               "device_metrics": metrics, "checkpoint": ckpt, "held": held,
               "launches": {"rerank": rerank_launches, **dense_launches, **colbert_launches},
               "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    print(f"[17 sharded serving] {smi_line() if device == 'cuda' else device}: every sub-phase passed in "
          f"{summary['seconds']:.1f} s ({json.dumps(seconds)}); summary " + json.dumps(summary, default=str))
    return summary


def add_phase17_launches(kernels, p17):
    """Phase 17's launches in its served runs (17b's reranked request, 17c's
    and 17d's sharded services) into the ``kernels`` line, and K3's and X1's
    shard-0 measurements."""
    runs = p17["launches"]
    for entry in kernels:
        total = sum(launches[entry["name"]] for launches in runs.values())
        entry["launches"] += total
        entry["launches_phase17"] = {"served": total, "by_path": {k: v[entry["name"]] for k, v in runs.items()
                                                                  if v[entry["name"]]}}
    held = p17["held"]
    kernels[2]["phase17_shard0"] = {k: held["k3_shard0"][k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                                      "bound_ms", "bound_by")}
    kernels[3]["phase17_shard0"] = held["x1_shard0"]


@contextlib.contextmanager
def counted_validations(into):
    """Count the trainer's validations by the path their metrics took
    (``into["device"]``, ``into["host"]``) while the block runs."""
    from capreolus_tpu_torch.trainer.torch_trainer import TorchTrainer

    real = TorchTrainer._eval_dev_runs

    def counted(self, preds, qrels, metrics, relevance_level):
        before = self.device_validations
        out = real(self, preds, qrels, metrics, relevance_level)
        into["device" if self.device_validations > before else "host"] += 1
        return out

    TorchTrainer._eval_dev_runs = counted
    try:
        yield into
    finally:
        TorchTrainer._eval_dev_runs = real

# ---------------------------------------------------------------- phase 18: multi-device training
P18 = {"batch": 8, "seq": 256, "query": 20, "timed_steps": 3, "pred_docs": 2, "pred_passages": 4, "seed": 18,
       "pretrained": "bert-base-uncased"}
# (label, trainer options, MoE): BERT-base BERTMaxP at phase 9b's training shape ([8, 256] token rows of
# bertpassage's default maxseqlen), MoE-BERTMaxP (12d's 4 experts, top-2) for ep
MODES18 = (("dp4", {}, False), ("fsdp4", {"fsdp": True, "ckpt": "sharded"}, False), ("tp2xdp2", {"tp": 2}, False),
           ("tp2+sp", {"tp": 2, "sp": True}, False), ("pp2", {"pp": 2, "microbatches": 4}, False),
           ("pp2xtp2", {"pp": 2, "tp": 2, "microbatches": 4}, False), ("ep2", {"ep": 2}, True))


def mesh_devices18(device):
    """Four distinct cards where the machine has them, else one card (or the
    CPU, in a rehearsal) named four times."""
    if device != "cuda":
        return [device] * 4
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(4)] if n >= 4 else ["cuda:0"] * 4


def batch18(shape18, rows, passages=None, seed=P18["seed"]):
    """A bertpassage-shaped batch of seeded token ids: ``rows`` training triples
    ([rows, L] pos and neg), or with ``passages`` [rows, passages, L] docs:
    a 20-token query (segment 0) then the passage (segment 1), the last 16
    positions padding."""
    rng = np.random.Generator(np.random.PCG64(seed))
    shape = (rows, shape18["seq"]) if passages is None else (rows, passages, shape18["seq"])
    out = {}
    for side in ("pos", "neg"):
        mask = np.ones(shape, np.int64)
        mask[..., -16:] = 0
        seg = np.ones(shape, np.int64)
        seg[..., :shape18["query"]] = 0
        out[f"{side}_bert_input"] = rng.integers(1000, 30000, size=shape).astype(np.int64) * mask
        out[f"{side}_mask"], out[f"{side}_seg"] = mask, seg
    return out


def reranker18(shape18, opts, moe):
    from capreolus_tpu_torch.reranker import Reranker

    cfg = {"pretrained": shape18["pretrained"], "allowrandominit": True, "hidden_dropout_prob": 0.0,
           "trainer": dict({"batch": shape18["batch"], "lr": 1e-4, "bertlr": 1e-4}, **opts)}
    if moe:
        cfg.update(moeexperts=MOE_EXPERTS, moetopk=MOE_TOPK)
    return Reranker.create("BERTMaxP", cfg)


def grads_by_key18(placement, model, device):
    """{flax key: gradient} of a step: a placement's blocks assembled (a stacked
    leaf cut into its layers), or the model's parameters in the flax layout."""
    from capreolus_tpu_torch.convert import flax_leaves
    from capreolus_tpu_torch.parallel.distributed import assemble_blocks

    if placement is None:
        named = dict(model.named_parameters())
        return {key: to_flax(named[name].grad) for key, name, to_flax, _, _ in flax_leaves(model)}
    out = {}
    for key, arr in placement.store.items():
        full = assemble_blocks([(i, b.grad) for i, b in arr.blocks.items()], device)
        if key.startswith("stacked/"):
            out.update({k: full[i] for i, k in enumerate(placement.stacked_from(key))})
        else:
            out[key] = full
    return out


def step_error18(got, want):
    """Each gradient tensor's largest error against its own largest entry, or
    GRAD_NOISE_FLOOR of the model's largest where that is larger (9a's measure)."""
    floor = GRAD_NOISE_FLOOR * max(float(g.abs().max()) for g in want.values())
    errs = {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), floor, 1e-30) for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def timed_steps18(shape18, trainer, rr, model, optimizer, batches, device):
    """The timed optimizer steps after the parity step: ms per step (host
    clock to a synchronize) and the peak device memory (GB; None on the CPU)."""
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        for d in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    for i in range(shape18["timed_steps"]):
        loss = trainer.train_step(rr, model, optimizer, batches, i + 1, trainer.step_seed(0, i + 1))
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / shape18["timed_steps"]
    check(bool(torch.isfinite(loss)), "18: a non-finite training loss")
    if not cuda:
        return ms, None
    return ms, max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())) / 1e9


def phase18_reference(shape18, moe, micro, batches, device):
    """Step 1 on one device (its loss and gradients) and its step time."""
    from capreolus_tpu_torch.reranker.common import cudnn_f32, matmul_f32

    rr = reranker18(shape18, {}, moe)
    trainer = rr.trainer
    trainer.device = device
    model = rr.build_train_model()
    model.load_state_dict(rr.state_dict_from_params(seeded_model_params(model, shape18["seed"])))
    model.to(device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = trainer.make_optimizer(rr, model)
    with cudnn_f32(), matmul_f32():  # a training forward (dropout 0): attention_plain, as train_step runs it
        loss = trainer.compute_loss(rr, micro, torch.device(device), dropout_seed=trainer.step_seed(0, 0))
        loss.backward()
    grads = {k: g.detach().clone() for k, g in grads_by_key18(None, model, device).items()}
    optimizer.zero_grad(set_to_none=True)
    ms, peak = timed_steps18(shape18, trainer, rr, model, optimizer, batches, device)
    # the model and its init serve every mode of its kind (each mode's placement copies the weights)
    out = {"loss": float(loss.detach()), "grads": grads, "model": model, "init": init, "step_ms": ms,
           "peak_gb": peak, "layers": model.config.num_layers}
    del rr, trainer, optimizer
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def phase18_k2(shape18, rr, placement, peaks, layers):
    """A tp prediction forward of 2 docs x 4 passages over the mesh: K2's launches
    (counted from 0 just before, read just after), then K2 against its plain
    version on model shard 0's first call (its H / tp heads), timed."""
    from capreolus_tpu_torch.ops import flash_attention as fa

    batch = batch18(shape18, shape18["pred_docs"], shape18["pred_passages"], seed=shape18["seed"] + 1)
    seen, real = [], fa.multihead_attention

    def recording(q, k, v, mask, **kw):
        if not seen:
            seen.append((q, k, v, mask))
        return real(q, k, v, mask, **kw)

    fa.multihead_attention = recording
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.no_grad(), placement.bind():
            scores = [rr.test(shard, d) for d, shard in placement.split(batch)]
        torch.cuda.synchronize()
        launched = launch_counts()["flash_attention"]
    finally:
        fa.multihead_attention = real
    check(all(bool(torch.isfinite(x).all()) for x in scores), "18: non-finite tp prediction scores")
    tp, dp = placement.mesh.shape["model"], placement.dp
    check(launched == layers * tp * dp, f"18: K2 launched {launched} times in the tp prediction forward, expected "
                                        f"{layers} layers x {tp} model shards x {dp} data shards")
    q, k, v, mask = seen[0]
    err, _ = k2_error(q, k, v, mask)
    timing = k2_time(q, k, v, mask, peaks)
    return {"launches": launched, "shape": list(q.shape), "max_abs_err": err,
            **{key: timing[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def phase_training_mesh(workdir, peaks, device="cuda", shape18=P18):
    """Phase 18: the training half of multi-device on the card. BERT-base
    BERTMaxP (MoE-BERTMaxP for ep) trained over four devices (four cards, or
    one card named four times) in each mode: step 1 from one init and one
    batch against the single-device step (the loss and each gradient within
    STEP_RTOL), then timed steps; K2 in a tp prediction forward; an fsdp=4
    sharded checkpoint resumed under tp=2 x dp=2. ``device="cpu"`` with a
    tiny ``shape18`` rehearses the phase without a card (K2 left out)."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.reranker.common import cudnn_f32, matmul_f32

    capreolus_tpu_torch.load_all_modules()
    t_phase = time.perf_counter()
    devices = mesh_devices18(device)
    distinct = len(set(devices)) == len(devices)
    micro = batch18(shape18, shape18["batch"])
    batches = {k: v[None] for k, v in micro.items()}
    card = smi_line() if device == "cuda" else device
    print(f"[18 mesh training] {card}; devices {devices} ({'four cards' if distinct else 'one card named four times'}"
          f"): the step times below are the cost of the single-process mesh (copies, Python dispatch), not scaling")
    refs = {moe: phase18_reference(shape18, moe, micro, batches, device) for moe in (False, True)}
    for moe, ref in refs.items():
        print(f"[18 one device] {'MoE-' if moe else ''}BERTMaxP: step-1 loss {ref['loss']:.6f}, "
              f"{ref['step_ms']:.1f} ms per step, peak {ref['peak_gb']} GB")
    modes, k2, ckpt = {}, None, {}
    for label, opts, moe in MODES18:
        t0 = time.perf_counter()
        rr = reranker18(shape18, opts, moe)
        trainer = rr.trainer
        trainer.device, trainer.devices = device, devices
        rr.model = model = refs[moe]["model"]  # built once per kind, back at its init
        model.load_state_dict(refs[moe]["init"])
        model.zero_grad(set_to_none=True)
        trainer._data_mesh = trainer._mesh(shape18["batch"])
        placement = trainer._placement = trainer._place_params(rr, model)
        optimizer = trainer.make_optimizer(rr, model, placement)
        trainer._model, trainer._optimizer = model, optimizer
        before = launch_counts()["flash_attention"]
        with placement.bind(), cudnn_f32(), matmul_f32():
            loss = trainer.mesh_loss(rr, micro, trainer.step_seed(0, 0))
            loss.backward()
        grad_err, worst = step_error18(grads_by_key18(placement, model, device), refs[moe]["grads"])
        loss_err = abs(float(loss.detach()) - refs[moe]["loss"]) / max(abs(refs[moe]["loss"]), 1e-12)
        optimizer.zero_grad(set_to_none=True)
        ms, peak = timed_steps18(shape18, trainer, rr, model, optimizer, batches, device)
        check(launch_counts()["flash_attention"] == before, f"18 {label}: K2 launched inside training steps")
        modes[label] = {"mesh": trainer._data_mesh.shape, "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                        "worst": worst, "step_ms": ms, "peak_gb": peak, "seconds": time.perf_counter() - t0}
        print(f"[18 {label}] mesh {trainer._data_mesh.shape}: step 1 against one device: loss rel err {loss_err:.3g}, "
              f"largest gradient error {grad_err:.3g} of its tensor's scale ({worst}; tolerance {STEP_RTOL}); "
              f"{ms:.1f} ms per step ({shape18['timed_steps']} steps), peak {peak} GB; {card}")
        check(loss_err <= STEP_RTOL and grad_err <= STEP_RTOL, f"18 {label}: step 1 differs from one device's")
        if label == "fsdp4":  # a sharded checkpoint with a populated Adam state, resumed under tp=2 x dp=2 below
            ckpt["path"] = Path(workdir) / "ckpt18" / "dev.best"
            trainer.save_checkpoint(ckpt["path"], model, optimizer, rr)
            ckpt["weights"] = {k: a.at("cpu").detach() for k, a in placement.store.items()}
            ckpt["adam"] = trainer._placement_optimizer_tree(optimizer, gather=True)["state"]
        if label == "tp2xdp2" and device == "cuda":
            k2 = phase18_k2(shape18, rr, placement, peaks, refs[moe]["layers"])
            print(f"[18 K2] {k2['launches']} launches in the tp prediction forward; model shard 0's call "
                  f"{k2['shape']}: max |K2 - plain| {k2['max_abs_err']:.3g} (tolerance {K2_TOL[torch.float32]}), "
                  f"{k2_line(k2 | {'bound_ms_cuda_core': None})}")
        if label == "tp2xdp2":
            trainer.load_checkpoint(ckpt["path"], model, optimizer, rr)
            same_w = all(torch.equal(placement.store[k].at("cpu"), w) for k, w in ckpt["weights"].items())
            got = trainer._placement_optimizer_tree(optimizer, gather=True)["state"]
            same_adam = got.keys() == ckpt["adam"].keys() and all(
                torch.equal(torch.as_tensor(got[k][m]), torch.as_tensor(ckpt["adam"][k][m]))
                for k in got for m in ("exp_avg", "exp_avg_sq", "step"))
            check(same_w and same_adam, "18: the fsdp=4 checkpoint resumed under tp=2 x dp=2 differs")
            blocks = len(placement.store["params/bert/layer_0/attention/query/kernel"].blocks)
            ckpt.update(resumed={"weights_equal": same_w, "adam_equal": same_adam, "query_kernel_blocks": blocks})
            print(f"[18 checkpoint] fsdp=4 sharded dev.best (Adam after {shape18['timed_steps']} steps) resumed "
                  f"under tp=2 x dp=2 ({blocks} column blocks of each query kernel): weights and Adam state equal")
        del rr, trainer, model, optimizer, placement
        if device == "cuda":
            torch.cuda.empty_cache()
    shutil.rmtree(Path(workdir) / "ckpt18", ignore_errors=True)
    out = {"devices": devices, "distinct_cards": distinct, "card": card, "modes": modes, "k2": k2,
           "one_device": {("moe" if m else "dense"): {k: r[k] for k in ("loss", "step_ms", "peak_gb")}
                          for m, r in refs.items()},
           "checkpoint": ckpt["resumed"], "seconds": time.perf_counter() - t_phase}
    del refs
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[18 mesh training] every mode passed in {out['seconds']:.1f} s; summary " + json.dumps(out, default=str))
    return out


def add_phase18_launches(kernels, p18):
    """Phase 18's K2 launches in its tp prediction forward, and K2 on model shard 0."""
    k2 = kernels[1]
    k2["launches"] += p18["k2"]["launches"]
    k2["launches_phase18"] = p18["k2"]["launches"]
    k2["phase18_shard0"] = {k: p18["k2"][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                      "bound_ms", "bound_by")}


IRDS19 = {"docs": 4000, "queries": 8, "seed": 19, "hits": 1000}  # the stand-in's corpus and each dataset's queries


def irds_standin():
    """``tests/torch_irds_standin.py`` of this checkout, which imports no JAX."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_irds_standin.py"
    spec = importlib.util.spec_from_file_location("torch_irds_standin", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_irds(workdir, device="cuda", shape=IRDS19):
    """Phase 19: the rank task over ``irds.*`` benchmarks. A seeded stand-in
    for ``ir_datasets`` in ``sys.modules`` serves a docs-only parent and two
    datasets over it; ``get_irds`` registers each (one collection, so one
    index for both), then ``rank.searcheval`` with BM25 on ``device`` and on
    the CPU: per dataset the run files with the same docids in the same order
    and scores within SPARSE_RTOL relative, the cross-validated metrics equal,
    and no port kernel launched (BM25 has no Pallas kernel)."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.utils.irds import get_irds

    t0 = time.perf_counter()
    standin = irds_standin()
    saved = sys.modules.get("ir_datasets")
    sys.modules["ir_datasets"] = standin.make_standin(num_docs=shape["docs"], num_queries=shape["queries"],
                                                     seed=shape["seed"])
    card = smi_line() if device == "cuda" else device
    out = {}
    try:
        constants["CACHE_BASE_PATH"] = os.path.join(workdir, "cache_irds")
        for name in standin.DATASETS:
            collection, benchmark = get_irds(name)
            reset_launch_counts()
            task, secs, scores, runs = rank_search({"name": "BM25", "hits": shape["hits"]}, device,
                                                   os.path.join(workdir, f"results_irds_{device}"),
                                                   benchmark={"name": benchmark})
            launched = {k: c for k, c in launch_counts().items() if c}
            check(not launched, f"19 {name}: the BM25 path launched a port kernel: {launched}")
            _, cpu_secs, cpu_scores, cpu_runs = rank_search({"name": "BM25", "hits": shape["hits"]}, "cpu",
                                                            os.path.join(workdir, "results_irds_cpu_ref"),
                                                            benchmark={"name": benchmark})
            check(sorted(runs) == sorted(cpu_runs) and runs,
                  f"19 {name}: run files {sorted(runs)} vs {sorted(cpu_runs)}")
            rel, hits = 0.0, 0
            for fn, run in runs.items():
                check(list(run) == list(cpu_runs[fn]), f"19 {name}: {fn}'s queries differ from the CPU's")
                for qid, docs in run.items():
                    want = cpu_runs[fn][qid]
                    check(list(docs) == list(want), f"19 {name} {fn} {qid}: docids differ from the CPU's")
                    got_s, want_s = np.array(list(docs.values())), np.array(list(want.values()))
                    rel = max(rel, float(np.max(np.abs(got_s - want_s) / np.maximum(np.abs(want_s), 1e-30))))
                    hits += len(docs)
            check(rel <= SPARSE_RTOL, f"19 {name}: scores card vs CPU {rel:.3g} > {SPARSE_RTOL} relative")
            check(scores == cpu_scores, f"19 {name}: metrics {scores} vs the CPU's {cpu_scores}")
            check(task.benchmark.collection.get_path() is None, f"19 {name}: the irds collection has a path")
            out[name] = {"collection": collection, "benchmark": benchmark,
                         "queries": len(task.benchmark.topics["title"]), "hits": hits, "search_s": secs, "search_s_cpu": cpu_secs, "score_rel_err": rel,
                         "map": scores["map"], "ndcg_cut_20": scores["ndcg_cut_20"]}
            print(f"[19 irds {name}] {card}: rank.searcheval benchmark.name={benchmark} (collection {collection}, "
                  f"no path) with BM25: search {secs:.2f} s on {device}, {cpu_secs:.2f} s on the CPU; {hits} hits, "
                  f"run files equal docid for docid, scores within {rel:.3g} relative (tolerance {SPARSE_RTOL}); "
                  f"map {scores['map']:.4f} ndcg_cut_20 {scores['ndcg_cut_20']:.4f}, every metric equal to the CPU's")
        check(len({entry["collection"] for entry in out.values()}) == 1, "19: the datasets do not share a collection")
    finally:
        if saved is None:
            sys.modules.pop("ir_datasets", None)
        else:
            sys.modules["ir_datasets"] = saved
    out["seconds"] = time.perf_counter() - t0
    print(f"[19 irds] ir_datasets is a stand-in (tests/torch_irds_standin.py: {shape['docs']} seeded docs, "
          f"{shape['queries']} queries in each of {len(standin.DATASETS)} datasets); {card}; every check passed in "
          f"{out['seconds']:.1f} s")
    return out


def smoke_workdir(prefix):
    """A new work directory, which the port's caches and results go under."""
    workdir = tempfile.mkdtemp(prefix=prefix)
    os.environ["CAPREOLUS_CACHE"] = os.path.join(workdir, "cache")
    os.environ["CAPREOLUS_RESULTS"] = os.path.join(workdir, "results")
    os.environ["CAPREOLUS_OFFLINE"] = "1"  # every file a module reads is local: a download must fail, not be tried
    return workdir


def last_line(name):
    """The contract's last line, printed only when every phase passed."""
    return json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


def main():
    t_start = time.perf_counter()
    name = phase_device()
    peaks = card_peaks(name)
    workdir = smoke_workdir("capreolus_tpu_torch_smoke_")
    seconds = {}
    serving_host = robust04_host = prebuild = None

    def timed(phase, *args, key=None, **kwargs):
        t0 = time.perf_counter()
        result = phase(*args, **kwargs)
        seconds[key or phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 1)
        return result

    try:
        timed(phase_native)  # before the set-up process, which builds an index with its libraries
        serving_host = start_host_side(workdir, serving_setup)  # phase 4's card-free set-up, beside 2-3
        timed(phase_build)
        k1 = timed(phase_k1_check, peaks)
        k2 = timed(phase_k2_check, peaks)
        k3 = timed(phase_k3_check, peaks)
        x1 = timed(phase_x1_check, peaks)
        q1 = timed(phase_q1_check, peaks)
        epilogue = timed(phase_epilogue_check, peaks)
        q1["scales_differing_from_cpu"] = timed(phase_scales_check)
        setup = timed(phase_setup_wait, serving_host, "[4 serving]", key="serving_setup_wait")
        k1_launches, corpus_dir, topics, qrels, knrm = timed(phase_serving, workdir, setup, ckpt_seed=3)
        robust04_host = start_host_side(workdir, robust04_host_side)  # phase 11's card-free work, beside phases 5-10
        prebuild = start_host_side(workdir, prebuild_setup)  # phase 8's and 10's card-free set-up, beside 5-7
        k2_launches, k2_served, f32 = timed(phase_bert_serving, workdir, corpus_dir, topics, peaks)
        bert_int8_launches, bert_int8 = timed(phase_bert_int8_serving, workdir, corpus_dir, topics, f32)
        colbert_launches, k3_served, none = timed(phase_colbert_serving, workdir, corpus_dir, topics, peaks)
        colbert_int8_launches, colbert_int8 = timed(phase_colbert_int8_serving, workdir, corpus_dir, topics, none)
        prebuilt = timed(phase_setup_wait, prebuild, "[8 rank task]", key="prebuild_wait")
        timed(phase_rank_task, workdir, prebuilt["rank"])
        training_launches, training_held = {"train": {}, "predict": {}}, {}
        validations = {"phase9": {"device": 0, "host": 0}}
        with counted_validations(validations["phase9"]):  # phase 17 reads how phase 9 validated
            golden = timed(phase_train_golden, workdir, training_launches, training_held)
            training = timed(phase_training, workdir, corpus_dir, topics, qrels, training_launches, training_held)
        print("[9 training] summary " + json.dumps({"golden": golden, "full_width": training}, default=str))
        timed(phase_sparse_engine, workdir, prebuilt["sparse_s"])
        timed(phase_robust04, workdir, robust04_host)
        other_launches = {}
        other = timed(phase_other_rerankers, workdir, corpus_dir, topics, other_launches)
        p13 = timed(phase_trainer_options, workdir, corpus_dir, topics, qrels, peaks)
        p14 = timed(phase_zoo, workdir, corpus_dir, topics)
        p15 = timed(phase_dense_retrieval, workdir, corpus_dir, topics, peaks)
        p16 = timed(phase_serving_families, workdir, corpus_dir, topics, none, peaks)
        p17 = timed(phase_sharded_serving, workdir, corpus_dir, topics, none, knrm, validations, peaks)
        print(f"[17 total] the script has run {time.perf_counter() - t_start:.1f} s")
        p18 = timed(phase_training_mesh, workdir, peaks)
        timed(phase_irds, workdir)
    finally:
        for host in (serving_host, robust04_host, prebuild):
            if host is not None and host[0].is_alive():
                host[0].terminate()
                host[0].join()
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
        # the runs of monoBERT f32 and int8, then ColBERT's over the bf16 and int8 corpora, then phase 12's
        "launches": (k2_launches + bert_int8_launches["flash_attention"] + colbert_launches["flash_attention"]
                     + colbert_int8_launches["flash_attention"] + other_launches["flash_attention"]),
        "launches_monobert": k2_launches,
        "launches_monobert_int8": bert_int8_launches["flash_attention"],
        "launches_colbert": colbert_launches["flash_attention"],
        "launches_colbert_int8": colbert_int8_launches["flash_attention"],
        # PARADE f32 and int8 (12 encoder + 2 aggregation layers a forward), CEDR-KNRM, Birch, MoE-BERT
        "launches_phase12": other_launches["flash_attention"],
        "launches_phase12_by_model": {k: v["launches"]["flash_attention"] for k, v in (
            ("parade", other["parade"]["f32"]), ("parade_int8", other["parade"]["int8"]),
            ("cedrknrm", other["cedrknrm"]), ("birch", other["birch"]), ("moe", other["moe"]))},
        # on a served PARADE forward's own q, k, v over its 100 candidates: the encoder's L 256 (B 1600)
        # and the aggregation layers' L 17 (B 100)
        "max_abs_err_phase12": other["parade"]["f32"]["k2_err"],
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
        # monoBERT int8's run, then ColBERT's int8 run and its int4 + rescore query, then int8 PARADE's
        "launches": (bert_int8_launches["int8_matmul"] + colbert_int8_launches["int8_matmul"]
                     + colbert_int8_launches["int8_matmul_int4"] + other_launches["int8_matmul"]),
        "launches_parade_int8": other_launches["int8_matmul"],
        "launches_parade_int8_by_mode": other_launches["int8_matmul_modes"],
        "pad_copies_parade_int8": other_launches["pad_copies"],
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
        "launches": bert_int8_launches["quantize_per_token"] + other_launches["quantize_per_token"],
        "launches_monobert_int8": bert_int8_launches["quantize_per_token"],
        "launches_parade_int8": other_launches["quantize_per_token"],
        "max_abs_err": q1["max_abs_err"],
        "ms": q1["ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes per-token quantization
    }, {
        "name": "maxsim_epilogue",
        "route": "cuda",
        "source": "capreolus_tpu_torch/csrc/maxsim_epilogue.cu",
        # no TPU kernel: the JAX searcher's int8 MaxSim after its bf16 dot (mask, max, sum, scales), left to XLA
        "replaces": "capreolus_tpu/searcher/late_interaction.py:414 (chunk_scores_q, no pl.pallas_call)",
        "shape": epilogue["shape"] + ", a served 64-query chunk",
        # ColBERT's int8 run and its int4 + rescore query: one per X1 launch of the engine
        "launches": colbert_int8_launches["maxsim_epilogue"] + colbert_int8_launches["maxsim_epilogue_int4"],
        "launches_colbert_int8": colbert_int8_launches["maxsim_epilogue"],
        "launches_colbert_int4": colbert_int8_launches["maxsim_epilogue_int4"],
        **{key: epilogue[key] for key in ("max_abs_err", "valid_token_share", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
    }]
    add_phase13_launches(kernels, p13, k3_fields)
    add_phase14_launches(kernels, p14)
    add_phase15_launches(kernels, p15)
    add_phase16_launches(kernels, p16)
    add_phase17_launches(kernels, p17)
    add_phase18_launches(kernels, p18)
    for entry in kernels:  # phase 9: launches inside training steps, and inside the trainer's predictions
        entry["launches_training"] = training_launches["train"].get(entry["name"], 0)
        entry["launches_training_predict"] = training_launches["predict"].get(entry["name"], 0)
        if entry["name"] in training_held:  # against the plain version on phase 9's own batches
            entry["max_abs_err_training"] = training_held[entry["name"]]
    print(f"[7 done] every phase passed in {time.perf_counter() - t_start:.1f} s; seconds by phase: "
          f"{json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(last_line(name))
    return 0


def only18(workdir, name):
    """``--only 18``: the kernels' build and phase 18 alone (the quickest proof
    that multi-device training still runs on the card, on four cards where
    the machine has them)."""
    phase_build()
    p18 = phase_training_mesh(workdir, card_peaks(name))
    return {"phase18": {k: p18[k] for k in ("devices", "distinct_cards", "modes", "k2", "checkpoint")}}


def only19(workdir, name):
    """``--only 19``: phase 19 alone (the irds bridge through the rank task on
    the card, with the native helpers it builds its index with)."""
    phase_native()
    return {"phase19": phase_irds(workdir)}


ONLY = {"18": only18, "19": only19}


def main_only(phase):
    """``--only <phase>``: ``ONLY[phase]`` in a work directory of its own, what
    it returns as one JSON line, then the last line as ``main``'s."""
    name = phase_device()
    workdir = smoke_workdir(f"capreolus_tpu_torch_smoke{phase}_")
    try:
        result = ONLY[phase](workdir, name)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result, default=str))
    print(last_line(name))
    return 0


if __name__ == "__main__":
    sys.exit(main_only(sys.argv[2]) if sys.argv[1:2] == ["--only"] else main())
