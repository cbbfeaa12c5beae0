"""Dense retrieval on the GPU: exact MIPS over BERT embeddings (the JAX
package's ``searcher/dense.py``).

Documents are embedded once with a BERT encoder (mean or CLS pooling,
L2-normalised; K2 in every layer on the card), cached on disk as an f32
``[N, D]`` matrix, and searched by one ``[Q, D] x [D, N]`` product and a top-k.
The engines, as ``build_topk`` selects them:

- resident bf16: the corpus on the device as bf16, scored by a bf16 product
  with f32 scores (``ivf.bf16_sims``: never a bf16 output, which would round
  the scores to 8 bits);
- ``quantize=int8`` / ``int4``: per-doc symmetric codes and scales, the int8 x
  int8 -> int32 product on X1 (``ops/quantization.int8_mips_scores`` /
  ``int4_mips_scores``); int4 retrieves ``rescore`` candidates and re-scores
  them at full precision on the host from the memory-mapped cache;
- host streaming above ``hbmbudget`` (``streamed.py``): fixed-shape chunks
  uploaded per query batch into a running top-k merge; its bf16 and int8
  results equal the resident engine's bit for bit, because both score the
  corpus in blocks of the same ``score_block`` rows;
- IVF (``clusters > 0``, ``ivf.py``): cells from spherical k-means, the
  layout cached as the JAX searcher's ``.npz``; a query batch scores the
  centroids, probes ``nprobe`` cells per query, scores the union of the
  probed cells in one product, and selects each query's top ``hits`` among
  its own ``nprobe`` cells in the JAX candidate order (probe rank, then slab
  position), with the sentinel ordinal ``n`` and -inf placeholders;
- ``prf > 0``: Rocchio in embedding space over the first pass's top ``prf``.

Selection is exact with ties to the lower ordinal (``jax.lax.top_k``'s
order), in every engine and in the streamed merge. ``topkmode=approx``
selects exactly too: ``jax.lax.approx_max_k`` has no torch counterpart, and
exact selection has recall 1.0. Embedding batches are not padded to
``batch`` rows (rows are independent; the results are the same).

The searcher runs on ``self.device`` (set by the service or the caller;
``None`` means "cuda"); the encoder and k-means run under
``reranker.common.matmul_f32``, whatever TF32 setting the process made.
``pretrained="tiny"`` is a seeded random init of the
port's own (the JAX searcher draws flax's at ``PRNGKey(0)``): the two
packages give the same embeddings only from the same weights, a checkpoint
directory or a ``checkpointfile``. A ``checkpointfile`` is a trained
biencoder's ``dev.best.params`` (its ``bert`` submodule) from either
package's trainer, its ``dev.best`` stem, a ``trainer.ckpt=sharded``
directory, or the port's ``.npz``. ``shards > 1`` (the JAX
``_sharded_topk``) splits the corpus by row range over ``self.devices`` and
merges the shards' top-k on the first device (bf16 or int8; the refusals of
streaming, IVF and int4 with shards are JAX's). The caches follow the index's generations
(``embedding_cache.py``): an incremental merge encodes only the added docs.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker.common import matmul_f32
from capreolus_tpu_torch.searcher import Searcher, _hbm_budget_mb
from capreolus_tpu_torch.searcher.streamed import topk_lower_ordinal_first
from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file, done_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

SCORE_BLOCK = 32768  # corpus rows per bf16 product: every engine scores blocks of one shape
UPLOAD_ROWS = 65536  # f32 cache rows per host-to-device copy of the resident corpus


class _HostCorpus:
    """Host-resident corpus for the streaming path (corpus bytes >
    hbmbudget): the memory-mapped f32 cache (chunks convert to bf16 at
    upload), or int8 codes / packed int4 nibbles with f32 per-doc scales."""

    def __init__(self, emb, scale=None, packed4=False):
        self.emb, self.scale = emb, scale
        self.packed4 = packed4
        self.n = emb.shape[0]


def _quantized_disk_cache(cache_fn, emb, qmode):
    """Slab-wise int8/int4 corpus built next to the f32 embedding cache and
    memory-mapped back (per-row scales make slabs independent, so host RAM
    holds one slab). Returns (quantized rows, [N] f32 scales)."""
    from numpy.lib.format import open_memmap

    from capreolus_tpu_torch.ops.quantization import quantize_rows, quantize_rows_int4

    stem = str(cache_fn)[: -len(".npy")] if str(cache_fn).endswith(".npy") else str(cache_fn)
    qfn, sfn = f"{stem}.{qmode}.npy", f"{stem}.{qmode}.scale.npy"
    if not (os.path.exists(qfn) and os.path.exists(sfn)):
        n, d = emb.shape
        qdtype = np.int8 if qmode == "int8" else np.uint8
        qcols = d if qmode == "int8" else (d + d % 2) // 2
        tmpq, tmps = f"{qfn}.tmp{os.getpid()}", f"{sfn}.tmp{os.getpid()}"
        try:
            qmm = open_memmap(tmpq, mode="w+", dtype=qdtype, shape=(n, qcols))
            smm = open_memmap(tmps, mode="w+", dtype=np.float32, shape=(n,))
            slab = max(1, (1 << 27) // max(4 * d, 1))
            quantize = quantize_rows if qmode == "int8" else quantize_rows_int4
            for s0 in range(0, n, slab):
                q, sc = quantize(np.asarray(emb[s0 : s0 + slab], dtype=np.float32))
                qmm[s0 : s0 + len(q)] = q
                smm[s0 : s0 + len(q)] = sc
            qmm.flush()
            smm.flush()
            del qmm, smm
            os.replace(tmpq, qfn)
            os.replace(tmps, sfn)
        except BaseException:
            for tmp in (tmpq, tmps):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            raise
    return np.load(qfn, mmap_mode="r"), np.load(sfn, mmap_mode="r")


def score_block(n):
    """Rows per bf16 product for a corpus of ``n`` docs: ``SCORE_BLOCK``, or
    ``n`` rounded up to 8 for a smaller corpus. The resident and streamed
    engines score the same blocks' shape, so their scores are equal bit for
    bit."""
    return min(SCORE_BLOCK, max(8, -(-n // 8) * 8))


def bf16_scores(q_emb, docs, block):
    """[Q, D] queries x [R, D] bf16 corpus -> [Q, R] f32, one ``bf16_sims``
    product per ``block`` rows (a partial block zero-padded to the shape)."""
    from capreolus_tpu_torch.searcher.ivf import bf16_sims

    qb = q_emb.to(torch.bfloat16)
    rows = docs.shape[0]
    out = torch.empty((qb.shape[0], rows), dtype=torch.float32, device=docs.device)
    for b0 in range(0, rows, block):
        part = docs[b0 : b0 + block]
        if part.shape[0] < block:
            part = torch.cat([part, part.new_zeros((block - part.shape[0], part.shape[1]))])
        out[:, b0 : b0 + block] = bf16_sims(qb, part)[:, : min(block, rows - b0)]
    return out


def _dense_scores(q_emb, docs, block):
    """[Q, D] float queries x corpus -> [Q, R] f32 scores. The corpus is the
    bf16 [R, D] matrix, the int8 {"emb", "scale"} pair, or the packed-int4
    {"emb4", "scale"} pair."""
    if isinstance(docs, dict):
        from capreolus_tpu_torch.ops.quantization import int4_mips_scores, int8_mips_scores

        if "emb4" in docs:
            return int4_mips_scores(q_emb, docs["emb4"], docs["scale"])
        return int8_mips_scores(q_emb, docs["emb"], docs["scale"])
    return bf16_scores(q_emb, docs, block)




@Searcher.register
class DenseSearcher(Searcher):
    """Exact dense retrieval (bi-encoder + matmul top-k)."""

    module_name = "dense"
    dependencies = [
        Dependency(key="index", module="index", name="tpu"),
        Dependency(key="tokenizer", module="tokenizer", name="berttokenizer"),
    ]
    config_spec = [
        ConfigOption("pretrained", "tiny", "encoder checkpoint (bert/electra names; 'tiny' for offline smoke)"),
        ConfigOption("checkpointfile", None, "framework checkpoint (e.g. a trained biencoder's "
                     "dev.best.params) whose 'bert' submodule overrides the encoder weights"),
        ConfigOption("pooling", "mean", "doc/query embedding pooling: mean or cls"),
        ConfigOption("maxdoclen", 256, "document tokens fed to the encoder"),
        ConfigOption("maxqlen", 32, "query tokens fed to the encoder"),
        ConfigOption("batch", 128, "embedding batch size"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("allowrandominit", False, "allow a randomly-initialized encoder when the "
                     "checkpoint cannot be loaded (smoke tests only)"),
        ConfigOption("shards", 1, "devices to shard the embedding matrix across (doc-partitioned; "
                     "per-shard top-k merged on the first device; the searcher's devices attribute "
                     "lists them)"),
        ConfigOption("topkmode", "exact", "exact or approx (the JAX package's approx_max_k; the port "
                     "selects exactly in both modes: recall 1.0)"),
        ConfigOption("recalltarget", 0.95, "approx_max_k per-operation recall target (topkmode=approx)"),
        ConfigOption("quantize", "none", "corpus-embedding quantization: none (bf16), int8 "
                     "(per-doc symmetric scales, int8 x int8 -> int32 products on X1, half the "
                     "device bytes), or int4 (packed nibble pairs, a quarter of bf16's bytes; "
                     "docs unpack to int8 a chunk at a time; exact and streamed engines)"),
        ConfigOption("hbmbudget", 12000.0, "device budget (MB) for the resident embedding matrix; "
                     "corpora above it stream host-resident chunks through the device with a "
                     "running top-k merge"),
        ConfigOption("clusters", 0, "IVF cells: 0 = exact brute force; K > 0 partitions the corpus "
                     "with spherical k-means (searcher/ivf.py) and each query scores only its "
                     "nprobe best cells. nprobe=clusters is exactly brute force"),
        ConfigOption("nprobe", 8, "IVF cells probed per query (clusters>0)"),
        ConfigOption("kmeansiters", 10, "Lloyd iterations for IVF cell training"),
        ConfigOption("rescore", 200, "quantize=int4 two-stage depth: the packed engine "
                     "retrieves this many candidates and a full-precision host rescore "
                     "from the memory-mapped embedding cache restores the exact ranking. "
                     "0 = raw int4 scores (candidate-generation only)", value_type="int"),
        ConfigOption("prf", 0, "dense pseudo-relevance feedback depth (Rocchio in "
                     "embedding space): a first pass retrieves prf docs per query, the query "
                     "embedding is remixed as alpha*q + beta*mean(top-prf doc embeddings) "
                     "(full-precision rows from the memory-mapped embedding cache) and "
                     "re-normalized, then the final pass runs with the expanded query. "
                     "0 = off", value_type="int"),
        ConfigOption("prfalpha", 1.0, "PRF weight on the original query embedding"),
        ConfigOption("prfbeta", 0.75, "PRF weight on the feedback centroid"),
    ]
    config_keys_not_in_path = ["batch", "shards", "hbmbudget"]  # none changes results

    device = None  # set by the service or the caller; None means "cuda"
    devices = None  # the shards' devices when shards > 1; None means the first ``shards`` cards

    def build(self):
        if self.config["pooling"] not in ("mean", "cls"):
            raise ConfigError(f"dense pooling must be 'mean' or 'cls', got {self.config['pooling']!r}")
        if self.config["topkmode"] not in ("exact", "approx"):
            raise ConfigError(f"dense topkmode must be 'exact' or 'approx', got {self.config['topkmode']!r}")
        if self.config["quantize"] not in (None, "none", "int8", "int4"):  # "none" casts to None
            raise ConfigError(f"dense quantize must be 'none', 'int8', or 'int4', "
                              f"got {self.config['quantize']!r}")
        if int(self.config["prf"]) > int(self.config["hits"]):
            raise ConfigError(f"dense prf depth ({self.config['prf']}) cannot exceed hits "
                              f"({self.config['hits']}): the first pass reuses the compiled "
                              f"top-k engine")
        self.setup_seconds = {"tokenize": 0.0, "encode": 0.0, "quantize": 0.0, "upload": 0.0}
        self.docs_encoded = 0  # documents this searcher's encoder embedded for the cache

    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    # ------------------------------------------------------------------ encoder
    def _encoder(self):
        """The BERT encoder on the searcher's device, in eval mode: a seeded
        random init for ``tiny`` or ``allowrandominit``, the pretrained
        checkpoint's weights when one was read, a ``checkpointfile``'s
        ``bert`` submodule over both."""
        if getattr(self, "_enc", None) is None:
            from capreolus_tpu_torch.convert import bert_state_dict, load_params
            from capreolus_tpu_torch.reranker.bert import BertEncoder, load_pretrained_encoder

            name = self.config["pretrained"]
            cfg, params = load_pretrained_encoder(
                name, allow_random_init=bool(self.config["allowrandominit"]) or name == "tiny")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = BertEncoder(cfg)
            self._random_init = params is None
            if params is not None:
                model.load_state_dict(params)
            elif name != "tiny":
                logger.warning("dense encoder %s running from RANDOM init", name)
            ckpt = self.config.get("checkpointfile")
            if ckpt:
                flat = load_params(ckpt)
                tree = {key.split("/")[1] for key in flat if key.startswith("params/") and key.count("/") >= 2}
                if "bert" not in tree:
                    raise ValueError(f"checkpoint {ckpt} has no 'bert' submodule "
                                     f"(top-level keys: {sorted(tree)[:8]})")
                state = bert_state_dict(flat)
                model.load_state_dict({k[len("bert."):]: v for k, v in state.items() if k.startswith("bert.")})
                self._random_init = False
                logger.info("dense encoder weights restored from %s", ckpt)
            self._enc = model.to(self._device()).eval()
        return self._enc

    def _tokenize(self, texts, maxlen):
        """([n, maxlen] ids, [n, maxlen] mask) as the JAX searcher lays them out."""
        tok = self.tokenizer
        inp = np.zeros((len(texts), maxlen), dtype=np.int64)
        mask = np.zeros((len(texts), maxlen), dtype=np.int64)
        for i, text in enumerate(texts):
            ids = [tok.cls_id] + tok.convert_tokens_to_ids(tok.tokenize(text)[: maxlen - 2]) + [tok.sep_id]
            inp[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return inp, mask

    def encode(self, inp, mask):
        """[B, L] ids and mask (numpy or tensors) -> [B, D] f32 unit embeddings
        on the device: the encoder, then mean (or CLS) pooling and L2
        normalisation, as the JAX searcher's jitted ``encode``."""
        model = self._encoder()
        device = self._device()
        inp = torch.as_tensor(inp).to(device)
        mask = torch.as_tensor(mask).to(device)
        with torch.inference_mode(), matmul_f32():
            hidden, _ = model(inp, mask, torch.zeros_like(inp))
            if self.config["pooling"] == "cls":
                vec = hidden[:, 0]
            else:
                m = mask[..., None].to(hidden.dtype)
                vec = (hidden * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
            vec = vec.float()
            return vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 1e-9)

    def _embed_device(self, texts, maxlen, to_host=False):
        """Tokenize + encode + pool + normalize -> [N, D] f32, ``batch`` texts
        a forward (the last batch not padded), on the device, or copied to the
        host a batch at a time (``to_host``: the doc encoding, whose
        ``setup_seconds["encode"]`` then holds the device's work)."""
        batch = int(self.config["batch"])
        out = []
        for start in range(0, len(texts), batch):
            t0 = time.perf_counter()
            inp, mask = self._tokenize(texts[start : start + batch], maxlen)
            t1 = time.perf_counter()
            emb = self.encode(inp, mask)
            out.append(emb.cpu() if to_host else emb)
            self.setup_seconds["tokenize"] += t1 - t0
            self.setup_seconds["encode"] += time.perf_counter() - t1
        if not out:
            return torch.zeros((0, self._encoder().config.hidden_size), device="cpu" if to_host else self._device())
        return torch.cat(out)

    def _embed_texts(self, texts):
        """Tokenize + encode + pool + normalize a list of strings -> [N, D] f32
        numpy, at ``self._embed_maxlen`` tokens (the JAX searcher's method)."""
        if not texts:
            return np.zeros((0, 1), np.float32)
        return self._embed_device(list(texts), int(self._embed_maxlen)).cpu().numpy()

    def embed_queries(self, texts):
        """[Q, D] f32 query embeddings on the device, at ``maxqlen`` tokens."""
        return self._embed_device(list(texts), int(self.config["maxqlen"]))

    # ------------------------------------------------------------------ doc embeddings
    def _doc_cache_file(self):
        """Keyed as the JAX searcher keys it: encoder identity (checkpoint
        content through its size and mtime), pooling, maxdoclen, the tokenizer
        in use and a random-init marker, so that a random-init run never
        serves a cache a real-weights run would read."""
        self._encoder()
        parts = [self.config["pretrained"], self.config["pooling"], str(self.config["maxdoclen"]),
                 self.tokenizer.fingerprint,
                 "randominit" if getattr(self, "_random_init", False) else "pretrained"]
        ckpt = self.config.get("checkpointfile")
        if ckpt:
            from capreolus_tpu_torch.convert import params_file

            st = os.stat(params_file(ckpt))
            parts += [ckpt, str(st.st_size), str(st.st_mtime_ns)]
        key = hashlib.md5("|".join(parts).encode()).hexdigest()[:16]
        return self.index.get_cache_path() / "dense" / f"doc_embeddings_{key}.npy"

    def _current_doc_cache_file(self):
        """The cache the loaded corpus came from (PRF, the int4 rescore and the
        IVF layout read and key on it)."""
        fn = getattr(self, "_active_cache_fn", None)
        return fn if fn is not None else self._doc_cache_file()

    def _doc_embeddings(self):
        """The [N, D] f32 doc embeddings of the index's loaded generation,
        memory-mapped from the disk cache (written on first use, atomically):
        from the previous generation's cache where one exists (the surviving
        docs' rows copied, or the file hardlinked when no doc changed),
        encoding only the docs it lacks (``embedding_cache.py``, the JAX
        searcher's rule; ``docs_encoded`` counts the encoded docs)."""
        from capreolus_tpu_torch.searcher import embedding_cache as ec

        self.index.create_index()
        docid_strings = self.index.data.docid_strings  # merges pending index ops first
        gen = getattr(self.index, "_loaded_generation", 0)
        base_fn = self._doc_cache_file()
        cache_fn = ec.generation_path(base_fn, gen)
        self._active_cache_fn = cache_fn
        maxlen = int(self.config["maxdoclen"])

        def encode(docids):
            logger.info("embedding %d documents with the %s encoder", len(docids), self.config["pretrained"])
            self.docs_encoded += len(docids)
            return self._embed_device([self.index.get_doc(d) for d in docids], maxlen, to_host=True).numpy()

        if not cache_fn.exists():
            emb = None
            prev, prev_gen = ec.find_previous(base_fn, gen)
            if prev is not None:
                old = np.load(prev, mmap_mode="r")
                src = ec.row_sources(ec.read_docids(prev), docid_strings)
                if ec.identity_remap(src, old.shape[0]):
                    ec.link_identical(prev, cache_fn)
                else:
                    emb = np.empty((len(docid_strings), old.shape[1]), dtype=old.dtype)
                    reused = ec.fill_kept_rows([emb], [old], src)
                    new_idx = np.flatnonzero(src < 0)
                    if len(new_idx):
                        emb[new_idx] = encode([docid_strings[i] for i in new_idx])
                    logger.info("dense cache gen %d built from gen %d: reused %d rows, encoded %d new documents",
                                gen, prev_gen, reused, len(new_idx))
            else:
                emb = encode(docid_strings)
            if emb is not None:
                try:
                    with cached_file(cache_fn, "wb") as f:
                        np.save(f, emb)
                except TargetFileExists:
                    pass  # a concurrent process won the race with identical content
        ec.write_docids(cache_fn, docid_strings)
        ec.prune_old_generations(base_fn, gen)
        return np.load(cache_fn, mmap_mode="r")

    def _qmode(self):
        return self.config.get("quantize", "none") or "none"

    def _device_bytes(self, n, d):
        """Device bytes of an [n, d] corpus in the configured representation."""
        return n * {"int8": d + 4, "int4": (d + d % 2) // 2 + 4}.get(self._qmode(), 2 * d)

    def _doc_matrix(self):
        """The search-time corpus: bf16 on the device, int8 / int4 dicts on the
        device, or a ``_HostCorpus`` above ``hbmbudget``. The bf16 matrix is
        zero-padded to whole ``score_block`` blocks (the rows past N never
        reach a selection)."""
        self.index.create_index()
        _ = self.index.data  # merges pending index ops; sets _loaded_generation
        gen = getattr(self.index, "_loaded_generation", 0)
        if getattr(self, "_docs_emb", None) is not None and getattr(self, "_docs_emb_gen", 0) == gen:
            return self._docs_emb
        self._docs_emb = None
        self._docs_emb_gen = gen
        emb = self._doc_embeddings()
        qmode = self._qmode()
        n, d = emb.shape
        dev_bytes = self._device_bytes(n, d)
        budget_bytes = float(_hbm_budget_mb(self.config)) * 1e6
        device = self._device()
        t0 = time.perf_counter()
        if qmode in ("int8", "int4"):
            from capreolus_tpu_torch.ops.quantization import quantize_rows, quantize_rows_int4

            if dev_bytes > budget_bytes:
                q, scale = _quantized_disk_cache(self._current_doc_cache_file(), emb, qmode)
                self._docs_emb = _HostCorpus(q, scale, packed4=(qmode == "int4"))
            else:
                q, scale = (quantize_rows_int4 if qmode == "int4" else quantize_rows)(np.asarray(emb))
                t1 = time.perf_counter()
                self.setup_seconds["quantize"] += t1 - t0
                t0 = t1
                key = "emb4" if qmode == "int4" else "emb"
                self._docs_emb = {key: torch.from_numpy(q).to(device), "scale": torch.from_numpy(scale).to(device)}
        elif dev_bytes > budget_bytes:
            self._docs_emb = _HostCorpus(emb)
        else:
            block = score_block(n)
            rows = -(-n // block) * block
            docs = torch.zeros((rows, d), dtype=torch.bfloat16, device=device)
            for s0 in range(0, n, UPLOAD_ROWS):
                part = np.array(emb[s0 : s0 + UPLOAD_ROWS], dtype=np.float32)
                docs[s0 : s0 + len(part)] = torch.from_numpy(part).to(device)
            self._docs_emb = docs
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_seconds["upload"] += time.perf_counter() - t0
        self._n_docs = n
        if isinstance(self._docs_emb, _HostCorpus):
            logger.info("dense corpus (%d docs, %.0f MB device bytes) exceeds hbmbudget=%.0f MB: "
                        "host-streaming mode (chunked uploads + running top-k merge)",
                        n, dev_bytes / 1e6, budget_bytes / 1e6)
        return self._docs_emb

    # ------------------------------------------------------------------ search
    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if not already:
                self._search_all(Path(topicsfn), output_path)
        return output_path

    def build_topk(self, hits):
        """``(topk(q_emb, docs) -> (scores, ordinals), docs, n_corpus)`` of the
        engine the config selects. Shared by the batch pipeline
        (``_search_all``) and ``serving.DenseRetrievalService``, which keeps
        the engine warm across calls. IVF engines are memoized per requested
        ``hits`` and index generation (the build permutes the corpus and
        drops the original)."""
        self.index.create_index()
        _ = self.index.data  # merges pending index ops; sets _loaded_generation
        gen = getattr(self.index, "_loaded_generation", 0)
        requested_hits = int(hits)
        clusters = int(self.config.get("clusters", 0) or 0)
        cached = getattr(self, "_ivf_engine", None)
        if cached is not None and cached[0] == (requested_hits, gen) and clusters > 0:
            _, topk, meta, n_corpus = cached
            return topk, meta, n_corpus

        shards = int(self.config["shards"])
        if shards > 1:
            return self._sharded_engine(hits, shards, clusters)
        docs = self._doc_matrix()
        n_corpus = self._n_docs
        hits = min(int(hits), n_corpus)
        int4 = (isinstance(docs, dict) and "emb4" in docs) or (isinstance(docs, _HostCorpus) and docs.packed4)
        rescore = int(self.config.get("rescore", 200) or 0) if int4 else 0
        engine_hits = min(max(rescore, hits), n_corpus) if rescore else hits
        if isinstance(docs, _HostCorpus):
            if clusters > 0:
                raise ConfigError("searcher.clusters (IVF) needs the corpus device-resident; raise "
                                  "hbmbudget or drop clusters (streaming is already FLOP-bounded "
                                  "per chunk)")
            topk = self._streamed_topk(docs, engine_hits)
        elif clusters > 0:
            if isinstance(docs, dict) and "emb4" in docs:
                raise ConfigError("searcher.clusters (IVF) supports quantize=none/int8; "
                                  "int4 is the capacity tier — use it with the exact or "
                                  "streamed engines")
            topk, docs = self._ivf_topk(docs, n_corpus, hits, cache_file=self._ivf_cache_file())
            self._ivf_engine = ((requested_hits, gen), topk, docs, n_corpus)
        else:
            topk = self._resident_topk(n_corpus, engine_hits)
        if rescore:
            topk = self._rescore_wrap(topk, n_corpus, hits)
        return topk, docs, n_corpus

    def _sharded_engine(self, hits, shards, clusters):
        """``build_topk`` under ``shards > 1``: JAX's refusals in JAX's order
        (a corpus over ``hbmbudget``, IVF, int4), then ``_sharded_topk`` over
        the shards' row ranges, built from the host cache without a resident
        copy of the whole corpus."""
        self.index.create_index()
        _ = self.index.data  # merges pending index ops; sets _loaded_generation
        gen = getattr(self.index, "_loaded_generation", 0)
        emb = self._doc_embeddings()
        n, d = emb.shape
        if self._device_bytes(n, d) > float(_hbm_budget_mb(self.config)) * 1e6:
            raise ConfigError("searcher.shards>1 already partitions the corpus across chips; "
                              "raise hbmbudget or use shards alone (streaming is single-chip)")
        if clusters > 0:
            raise ConfigError("searcher.clusters (IVF) cannot be combined with shards>1 yet")
        if self._qmode() == "int4":
            raise ConfigError("searcher.shards supports quantize=none/int8; int4 is the "
                              "single-chip capacity tier (exact or streamed engines)")
        from capreolus_tpu_torch.parallel.distributed import shard_devices
        from capreolus_tpu_torch.parallel.sharded_search import cached_shards

        devices = shard_devices(shards, self.devices)
        parts = cached_shards(self, gen, devices, lambda: self._upload_shards(emb, devices))
        self._n_docs = n
        return self._sharded_topk(n, min(int(hits), n), devices), parts, n

    def _upload_shards(self, emb, devices):
        """Each shard's row range [s*per, (s+1)*per), per = ceil(n/S), on its
        device: bf16 rows zero-padded to whole ``score_block(n)`` blocks (the
        resident engine's product shape), or int8 codes padded with zero rows
        of scale 1. A shard past the corpus end holds pad rows only."""
        n, d = emb.shape
        per = -(-n // len(devices))
        t0 = time.perf_counter()
        parts = []
        if self._qmode() == "int8":
            from capreolus_tpu_torch.ops.quantization import quantize_rows
            from capreolus_tpu_torch.searcher.streamed import pad_rows

            q, scale = quantize_rows(np.asarray(emb))
            t1 = time.perf_counter()
            self.setup_seconds["quantize"] += t1 - t0
            t0 = t1
            for s, dev in enumerate(devices):
                rows = slice(s * per, min(n, (s + 1) * per))
                parts.append({"emb": torch.from_numpy(pad_rows(q[rows], per)).to(dev),
                              "scale": torch.from_numpy(pad_rows(scale[rows], per, fill=1)).to(dev)})
        else:
            block = score_block(n)
            for s, dev in enumerate(devices):
                lo, hi = min(n, s * per), min(n, (s + 1) * per)
                part = torch.zeros((-(-per // block) * block, d), dtype=torch.bfloat16, device=dev)
                for s0 in range(lo, hi, UPLOAD_ROWS):
                    rows = np.array(emb[s0 : min(hi, s0 + UPLOAD_ROWS)], dtype=np.float32)
                    part[s0 - lo : s0 - lo + len(rows)] = torch.from_numpy(rows).to(dev)
                parts.append(part)
        for dev in {dev for dev in devices if dev.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self.setup_seconds["upload"] += time.perf_counter() - t0
        return parts

    def _sharded_topk(self, n, hits, devices):
        """The JAX ``_sharded_topk``: each shard scores its rows (the bf16
        product in ``score_block(n)`` blocks, or X1's int32 product and
        epilogue), masks rows at or past ``n`` to -inf BEFORE its local top
        ``min(hits, per)`` (a zero pad row scores 0, above real negative
        cosines), every shard launched before any result is copied; the
        candidates merge shard-major on the first device, ties to the lower
        ordinal."""
        from capreolus_tpu_torch.parallel.sharded_search import merge_shard_candidates

        per = -(-n // len(devices))
        local_k = min(hits, per)
        block = score_block(n)

        def topk(q_emb, parts):
            cands = []
            for s, (dev, part) in enumerate(zip(devices, parts)):
                scores = _dense_scores(q_emb.to(dev), part, block)[:, :per].float()
                ords = torch.arange(per, device=dev) + s * per
                scores = torch.where(ords[None, :] < n, scores, float("-inf"))
                sv, so = topk_lower_ordinal_first(scores, local_k)
                cands.append((sv, so + s * per))
            return merge_shard_candidates(cands, hits, devices[0])

        return topk

    def _resident_topk(self, n, hits):
        """The exact resident engine: every doc scored, rows past ``n`` (the
        bf16 matrix's block padding) masked, the top ``hits``, ties to the
        lower ordinal. ``approx`` selects exactly too (no torch counterpart of
        ``approx_max_k``; recall 1.0)."""
        block = score_block(n)

        def topk(q_emb, docs):
            scores = _dense_scores(q_emb, docs, block)
            if scores.shape[1] > n:
                scores = scores[:, :n]
            return topk_lower_ordinal_first(scores, hits)

        return topk

    def _rescore_wrap(self, base_topk, n, hits):
        """Two-stage int4 search: the packed engine's candidates are
        re-scored at full precision from the memory-mapped f32 cache (host
        numpy, the JAX function's arithmetic) and the top ``hits`` returned,
        ties in the engine's candidate order."""
        emb_mm = np.load(self._current_doc_cache_file(), mmap_mode="r")

        def topk(q_emb, docs):
            s, o = base_topk(q_emb, docs)
            s, o = s.cpu().numpy(), o.cpu().numpy()
            qf = q_emb.float().cpu().numpy()
            valid = np.isfinite(s) & (o < n)
            safe = np.where(valid, o, 0)
            cand = np.asarray(emb_mm[safe.reshape(-1)], np.float32).reshape(o.shape[0], o.shape[1], -1)
            exact = np.einsum("qd,qrd->qr", qf, cand)
            exact = np.where(valid, exact, -np.inf)
            k = min(hits, exact.shape[1])
            idx = np.argsort(-exact, kind="stable", axis=1)[:, :k]
            return (torch.from_numpy(np.take_along_axis(exact, idx, 1).astype(np.float32)),
                    torch.from_numpy(np.take_along_axis(o, idx, 1)))

        return topk

    def _search_all(self, topicsfn, output_path):
        from capreolus_tpu_torch.searcher.tpu import _load_topics_tsv

        topics = _load_topics_tsv(topicsfn)
        topk, docs, n_docs = self.build_topk(int(self.config["hits"]))
        docid_strings = self.index.data.docid_strings
        run = OrderedDict()
        batch = int(self.config["batch"])
        for start in range(0, len(topics), batch):
            chunk = topics[start : start + batch]
            q_emb = self.embed_queries([t for _, t in chunk])
            if int(self.config["prf"]) > 0:
                q_emb = self._prf_expand(q_emb, topk, docs)
            scores, ords = (x.cpu().numpy() for x in topk(q_emb, docs))
            for qi, (qid, _) in enumerate(chunk):
                # out-of-range ordinals and -inf placeholders never reach the run
                run[qid] = {docid_strings[int(o)]: float(s)
                            for s, o in zip(scores[qi], ords[qi])
                            if int(o) < n_docs and np.isfinite(s)}
        outfn = output_path / f"searcher_dense_pooling-{self.config['pooling']}"
        with open(outfn, "wt", encoding="utf-8") as f:
            for qid, docs_ in run.items():
                for rank, (docid, score) in enumerate(docs_.items(), start=1):
                    f.write(f"{qid} Q0 {docid} {rank} {score:.6f} capreolus_tpu\n")
        logger.info("wrote dense run file %s (%d queries)", outfn, len(run))

    def _prf_expand(self, q_emb, topk, docs):
        """Rocchio expansion in embedding space (host numpy, the JAX
        function's arithmetic): the first pass's top ``prf`` docs' full-precision
        rows, in ascending ordinal, averaged and mixed into the query, then
        re-normalised. Returns the expanded [Q, D] f32 queries on the device."""
        prf = int(self.config["prf"])
        alpha = float(self.config["prfalpha"])
        beta = float(self.config["prfbeta"])
        scores, ords = (x.cpu().numpy() for x in topk(q_emb, docs))
        emb = np.load(self._current_doc_cache_file(), mmap_mode="r")
        n = emb.shape[0]
        out = np.array(q_emb.float().cpu().numpy(), dtype=np.float32, copy=True)
        for qi in range(len(out)):
            valid = [int(o) for s, o in zip(scores[qi][:prf], ords[qi][:prf]) if int(o) < n and np.isfinite(s)]
            if not valid:
                continue
            centroid = np.asarray(emb[sorted(valid)], dtype=np.float32).mean(axis=0)
            mixed = alpha * out[qi] + beta * centroid
            out[qi] = mixed / (np.linalg.norm(mixed) + 1e-9)
        return torch.from_numpy(out).to(q_emb.device)

    def _streamed_topk(self, host, hits):
        """Host-streaming exact search for corpora above hbmbudget: per query
        batch, fixed-shape chunks (two in flight fit the budget) are uploaded
        and folded into a running top-k (``streamed.streamed_topk``). bf16
        chunks convert from the f32 cache at upload, in torch's round to
        nearest even, as ml_dtypes rounds them in JAX."""
        from capreolus_tpu_torch.searcher.streamed import pad_rows, streamed_topk

        budget_bytes = float(_hbm_budget_mb(self.config)) * 1e6
        to_bf16 = host.scale is None and host.emb.dtype == np.float32
        upload_itemsize = 2 if to_bf16 else host.emb.dtype.itemsize
        row_bytes = host.emb.shape[1] * upload_itemsize + (4 if host.scale is not None else 0)
        chunk = int(max(1, min(host.n, budget_bytes // 2 // row_bytes)))
        if chunk >= 8:
            chunk -= chunk % 8
        device = self._device()
        block = score_block(host.n)

        def make_chunk(start):
            rows = torch.from_numpy(pad_rows(np.array(host.emb[start : start + chunk]), chunk))
            if to_bf16:
                rows = rows.to(torch.bfloat16)  # half the stream bytes; disk stays full-precision
            cd = rows.to(device, non_blocking=True)
            if host.scale is not None:
                key = "emb4" if host.packed4 else "emb"
                scale = pad_rows(np.array(host.scale[start : start + chunk]), chunk, fill=1)
                cd = {key: cd, "scale": torch.from_numpy(scale).to(device, non_blocking=True)}
            return cd

        logger.info("streaming dense search: %d-doc chunks (%.0f MB each), %d chunks/query-batch",
                    chunk, chunk * row_bytes / 1e6, -(-host.n // chunk))
        self.stream_chunks = -(-host.n // chunk)
        return streamed_topk(make_chunk, lambda q, cd: _dense_scores(q, cd, block), host.n, chunk, hits)

    def _ivf_cache_file(self):
        """The trained IVF layout's cache: the doc-embedding cache's key plus
        clusters, kmeansiters and the corpus representation (int8 rounds the
        rows k-means sees), named as the JAX searcher names it."""
        emb_fn = self._current_doc_cache_file()
        tag = (f"{int(self.config['clusters'])}_{int(self.config['kmeansiters'])}_"
               f"{self.config.get('quantize') or 'none'}")
        return emb_fn.parent / f"{emb_fn.stem}_ivf_{tag}.npz"

    def _ivf_topk(self, docs, n, hits, cache_file=None):
        """IVF probe-limited search (``searcher/ivf.py``). The layout
        (centroids, assignment) is read from ``cache_file`` or trained and
        written there; the corpus is permuted cluster-major once. A query
        batch: bf16 centroid scores, each query's top ``nprobe`` cells (ties to
        the lower cell), one product of every query against the rows of the
        union of probed cells, then per query its [nprobe * msz] candidates
        laid out as JAX's slabs (probe rank, slab position; lanes past a
        cell's size -inf), the top ``hits`` of them, mapped back to original
        ordinals (the sentinel ``n`` on every -inf slot). Returns (topk, meta)."""
        from capreolus_tpu_torch.searcher import ivf

        k = max(1, min(int(self.config["clusters"]), n))
        nprobe = max(1, min(int(self.config["nprobe"]), k))
        quantized = isinstance(docs, dict)
        device = self._device()
        if not quantized:
            docs = docs[:n]  # the block padding never enters the layout
        if cache_file is not None and cache_file.exists():
            z = np.load(cache_file)
            centroids, assign = torch.from_numpy(z["centroids"]).to(device), z["assign"]
            logger.info("IVF layout restored from %s", cache_file)
        else:
            kdocs = (docs["emb"], docs["scale"]) if quantized else docs
            with matmul_f32():
                centroids, assign = ivf.spherical_kmeans(kdocs, k, int(self.config["kmeansiters"]))
            if cache_file is not None:
                try:
                    with cached_file(cache_file, "wb") as f:
                        np.savez(f, centroids=centroids.cpu().numpy(), assign=assign)
                except TargetFileExists:
                    pass
        order, starts, sizes, max_size = ivf.build_cells(assign, k)
        logger.info("IVF: %d cells over %d docs (max cell %d, mean %.1f), nprobe=%d",
                    k, n, max_size, n / max(k, 1), nprobe)
        order_d = torch.from_numpy(order).to(device)
        if quantized:
            sorted_docs = {"emb": docs["emb"][order_d], "scale": docs["scale"][order_d]}
        else:
            sorted_docs = docs[order_d]
        self._docs_emb = None  # one (cluster-major) corpus copy stays on the device
        del docs
        msz = max_size
        meta = {"docs": sorted_docs, "order": torch.cat([order_d, torch.full((1,), n, device=device)]),
                "starts": torch.from_numpy(starts.astype(np.int64)).to(device),
                "sizes": torch.from_numpy(sizes.astype(np.int64)).to(device),
                "cell_of_row": torch.from_numpy(np.sort(assign).astype(np.int64)).to(device),
                "centroids": centroids}
        block = score_block(n)

        def topk(q_emb, meta):
            from capreolus_tpu_torch.ops.quantization import int8_mips_scores

            nq = q_emb.shape[0]
            cs = ivf.bf16_sims(q_emb, meta["centroids"])
            _, probes = topk_lower_ordinal_first(cs, nprobe)            # [Q, nprobe]
            in_union = torch.zeros((k,), dtype=torch.bool, device=device)
            in_union[probes.reshape(-1)] = True
            rows = torch.nonzero(in_union[meta["cell_of_row"]]).reshape(-1)  # union rows, cluster-major
            union_sizes = torch.where(in_union, meta["sizes"], 0)
            union_starts = torch.cumsum(union_sizes, 0) - union_sizes
            if quantized:
                s_u = int8_mips_scores(q_emb, meta["docs"]["emb"][rows], meta["docs"]["scale"][rows])
            else:
                s_u = bf16_scores(q_emb, meta["docs"][rows], block)
            lane = torch.arange(msz, device=device)
            cols = union_starts[probes][:, :, None] + lane                 # [Q, nprobe, msz]
            valid = lane < meta["sizes"][probes][:, :, None]
            cols = torch.where(valid, cols, 0).reshape(nq, -1)
            s_all = torch.where(valid.reshape(nq, -1), torch.gather(s_u, 1, cols), float("-inf"))
            idx_all = torch.where(valid, meta["starts"][probes][:, :, None] + lane, n).reshape(nq, -1)
            k_out = min(hits, s_all.shape[1])
            ms, sel = topk_lower_ordinal_first(s_all, k_out)
            orig = meta["order"][torch.gather(idx_all, 1, sel)]
            if k_out < hits:  # fewer candidates than hits: -inf placeholders
                ms = torch.cat([ms, torch.full((nq, hits - k_out), float("-inf"), device=device)], dim=1)
                orig = torch.cat([orig, torch.full((nq, hits - k_out), n, dtype=orig.dtype, device=device)], dim=1)
            return ms, torch.where(torch.isfinite(ms), orig, n)

        return topk, meta
