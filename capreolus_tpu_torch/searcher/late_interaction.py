"""Late-interaction (ColBERT) retrieval on the GPU: the JAX package's
``searcher/late_interaction.py``: the exact resident engine, the two-stage
``prefilter`` and host streaming.

Every document's tokens are embedded once with a ColBERT encoder, cached on
disk as f16, and uploaded to the device as one token-major bf16 tensor
[Ld, N, dim] with its mask bias [Ld, N] and doc-validity flags [N]: the layout
K3 (``ops/maxsim.py``, ``csrc/maxsim.cu``) reads, held once. A query batch is
scored against the whole corpus by one K3 call (the plain version on the CPU),
then the top ``hits`` are taken with ties to the lower doc ordinal, as
``jax.lax.top_k`` breaks them. ``chunk`` stays a config key and changes no
result, as in the JAX searcher: it bounded XLA's similarity tensor, which K3
never materialises.

``quantize=int8`` holds the corpus as int8 [N, Ld, dim] with one f32 scale per
doc (``ops/quantization.quantize_rows`` of the f16 cache); ``quantize=int4``
as packed nibbles [N, Ld*dim/2], unpacked to int8 a chunk at a time. Queries
quantize per query on the device, and each chunk of docs is one int8 product
[Q*Lq, dim] x [C*Ld, dim]^T (X1, ``ops/int8_matmul.py``, on the card) whose
int32 similarities are rounded to bf16, as the JAX scorer's
``preferred_element_type=bfloat16`` rounds them, then masked, maxed over doc
tokens and summed over query tokens in f32, times the query and doc scales:
one pass of the epilogue kernel over the valid tokens' similarities on the
card (``ops/maxsim_epilogue.py``, ``csrc/maxsim_epilogue.cu``).
A chunk holds as many docs as keep its int32 similarities near
``SIM_CHUNK_BYTES``; the chunk size changes no result. int4 retrieves
``rescore`` candidates and re-scores them at full precision from the f16 disk
cache, as the JAX ``_rescore_wrap`` does.

``prefilter > 0`` is the JAX searcher's two-stage mode (``_prefilter_topk``):
stage 1 scores every doc by one bf16 product of the query's summed token
embeddings against the doc's mean valid-token embedding (``pooled``, computed
once per uploaded corpus; int8 dequantized inside the pooling, as JAX does),
keeps each query's top ``prefilter`` candidates with ties to the lower
ordinal, and stage 2 scores exact MaxSim over that query's own candidates:
K3 on the gathered token-major slab (bf16) or X1 over the gathered int8 rows,
one launch per query. A candidate's stage-2 score equals the exact engine's
score for that doc, and the final order is a stable descending sort in
candidate order (``jax.lax.top_k`` over stage 2). No candidate repeats, so
no docid is dropped as a duplicate.

A corpus above ``hbmbudget`` streams from the host (``_streamed_topk``):
slices of ``budget // 2 // row_bytes`` docs, a multiple of ``chunk``, from the
f16 memmap (converted to bf16 and transposed to K3's token-major layout on
the host) or from the int8 disk cache beside it (``dense._quantized_disk_cache``,
rows flattened to [N, Ld*dim]), folded into a running top-k
(``streamed.streamed_topk``). Its hits equal the resident engine's bit for
bit: every doc's score is computed by the same arithmetic whatever the other
docs of its call. int4 is resident-only and refuses ``prefilter``, ``shards``
and a corpus above the budget, with the JAX searcher's messages.

The doc-embedding cache follows the index's generations
(``embedding_cache.py``): after an incremental merge the surviving docs' rows
are copied from the previous generation's cache and only the added docs are
encoded (``docs_encoded`` counts them).

The searcher runs on ``self.device``, an attribute (not a config option, so
the device never enters the module path) that the service or the caller sets;
``None`` means "cuda", which raises without a card. ``shards > 1`` (the JAX
``_sharded_topk``) splits the corpus by doc range over ``self.devices``
(``None``: the first ``shards`` cards), one MaxSim call per shard and a
shard-major merge on the first device; prefilter, int4 and streaming refuse
shards with JAX's messages. A ``checkpointfile`` is a
trained ``colbert`` reranker's ``dev.best.params`` from either package's
trainer (flax's msgpack bytes, ``utils/flax_msgpack.py``), its ``dev.best``
stem, a ``trainer.ckpt=sharded`` directory, or the port's ``.npz``
(``convert.save_params``); each must hold the ``bert`` and ``linear``
submodules, as the JAX searcher checks.
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
from capreolus_tpu_torch.ops.maxsim_epilogue import MASKED_BIAS, chunk_scores
from capreolus_tpu_torch.reranker.common import matmul_f32
from capreolus_tpu_torch.searcher import Searcher, _hbm_budget_mb
from capreolus_tpu_torch.searcher.streamed import topk_lower_ordinal_first
from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file, done_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

UPLOAD_BYTES = 64 << 20  # f16 bytes per host-to-device copy of the corpus
SIM_CHUNK_BYTES = 1 << 29  # int32 similarities per chunk of the quantized engine (512 MB)
POOL_DOCS = 2048  # docs per step of prefilter's pooled embeddings (a [Ld, 2048, dim] f32 slice)


def quantized_chunk_docs(nq, lq, ld):
    """Docs per chunk of ``quantized_maxsim_scores`` for nq queries of lq
    tokens over docs of ld tokens: as many as keep a chunk's int32
    similarities within ``SIM_CHUNK_BYTES``, and its N = docs * ld within X1's
    limit, at least one."""
    from capreolus_tpu_torch.ops.int8_matmul import MAX_N

    return max(1, min(SIM_CHUNK_BYTES // (4 * nq * lq * ld), MAX_N // ld))


def quantized_maxsim_scores(q_emb, docs, mask, dscale):
    """MaxSim of q_emb [Q, Lq, dim] (float) over a quantized corpus -> [Q, N]
    f32, the JAX scorer's int8 path: docs int8 [N, Ld, dim] or int4 nibbles
    uint8 [N, ceil(Ld*dim/2)], mask [N, Ld] bool, dscale [N] f32 per-doc
    scales. Queries quantize per query (``quantize_rows_torch``), then
    ``quantized_maxsim_codes`` scores them."""
    from capreolus_tpu_torch.ops.quantization import quantize_rows_torch

    return quantized_maxsim_codes(*quantize_rows_torch(q_emb), docs, mask, dscale)


def quantized_maxsim_codes(q_i8, qscale, docs, mask, dscale):
    """``quantized_maxsim_scores`` of queries already quantized: q_i8 int8
    [Q, Lq, dim] with f32 [Q] scales. Each chunk of docs is one ``int8_mm``
    (X1 on the card) whose int32 similarities round to bf16, masked tokens at
    bf16(-1e9), the max over doc tokens in bf16, the sum over query tokens in
    f32 (``ops.maxsim.sum_query_tokens``), times the query and doc scales; a
    doc with no valid token scores -inf: ``ops.maxsim_epilogue.chunk_scores``,
    the epilogue kernel on the card."""
    from capreolus_tpu_torch.ops.int8_matmul import int8_mm
    from capreolus_tpu_torch.ops.quantization import unpack_int4

    nq, lq, dim = q_i8.shape
    n, ld = mask.shape
    q2d = q_i8.reshape(nq * lq, dim)
    step = quantized_chunk_docs(nq, lq, ld)
    out = torch.empty((nq, n), dtype=torch.float32, device=q_i8.device)
    for c0 in range(0, n, step):
        d = docs[c0 : c0 + step]
        c = d.shape[0]
        if d.dtype == torch.uint8:  # int4: this chunk alone unpacks to int8
            d = unpack_int4(d)[:, : ld * dim]
        chunk_scores(int8_mm(q2d, d.reshape(c * ld, dim).contiguous()), mask[c0 : c0 + c], qscale,
                     dscale[c0 : c0 + c], out, c0)
    return out


class _HostTokens:
    """A host-resident corpus for the streamed engine (device bytes above
    ``hbmbudget``): the f16 memmap [N, Ld, dim], or int8 codes [N, Ld*dim]
    with f32 [N] per-doc scales, and the int8 masks [N, Ld]."""

    def __init__(self, emb, mask, scale=None):
        self.emb, self.mask, self.scale = emb, mask, scale
        self.n = emb.shape[0]


def prefilter_candidates(q_emb, pooled, n_cand):
    """Prefilter's stage 1: [Q, n_cand] ordinals, each query's top
    ``n_cand`` docs by one bf16 product (f32 scores) of its summed bf16 token
    embeddings (``q_emb`` [Q, Lq, dim]; the sum in f32, rounded once) against
    ``pooled`` [N, dim] bf16, ties to the lower ordinal."""
    from capreolus_tpu_torch.searcher.ivf import bf16_sims

    qsum = q_emb.to(torch.bfloat16).float().sum(dim=1).to(torch.bfloat16)
    return topk_lower_ordinal_first(bf16_sims(qsum, pooled), n_cand)[1]


@Searcher.register
class LateInteractionSearcher(Searcher):
    """Exact ColBERT MaxSim retrieval over per-token embeddings."""

    module_name = "colbert"
    dependencies = [
        Dependency(key="index", module="index", name="tpu"),
        Dependency(key="tokenizer", module="tokenizer", name="berttokenizer"),
    ]
    config_spec = [
        ConfigOption("pretrained", "tiny", "encoder checkpoint (bert/electra names; 'tiny' for offline smoke)"),
        ConfigOption("checkpointfile", None, "trained colbert reranker checkpoint "
                     "(dev.best.params with 'bert' + 'linear' submodules)"),
        ConfigOption("dim", 128, "per-token embedding dimension (must match the checkpoint)"),
        ConfigOption("maxdoclen", 180, "document tokens fed to the encoder"),
        ConfigOption("maxqlen", 32, "query tokens (ColBERT pads to this with [MASK])"),
        ConfigOption("batch", 64, "embedding / query batch size"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("chunk", 256, "docs scored per MaxSim chunk (bounds the similarity "
                     "tensor to batch*chunk*maxqlen*maxdoclen bf16)"),
        ConfigOption("allowrandominit", False, "allow a randomly-initialized encoder when the "
                     "checkpoint cannot be loaded (smoke tests only)"),
        ConfigOption("shards", 1, "devices to shard the token-embedding tensor across "
                     "(doc-partitioned; per-shard top-k merged over ICI, like searcher.shards "
                     "on BM25 and dense)"),
        ConfigOption("prefilter", 0, "two-stage mode (PLAID-style candidate generation, "
                     "Santhanam et al. 2022): 0 = exact MaxSim over the whole corpus; N > 0 = "
                     "a cheap pooled-embedding first pass selects N candidates per query "
                     "([Q, dim] x [dim, N] matmul), exact MaxSim reranks only those. "
                     "Approximate: measured top-10 overlap vs exact in tests/test_colbert.py"),
        ConfigOption("quantize", "none", "token-embedding quantization: none (bf16), int8 "
                     "(per-doc symmetric scales, int8 MXU MaxSim at double rate, half the HBM "
                     "per corpus; the per-doc scale factors out of MaxSim's max/sum exactly — "
                     "ops/quantization.py, overlap referee'd in tests/test_colbert.py), or int4 "
                     "(packed nibble pairs: 4x the docs per HBM byte vs bf16 — the capacity "
                     "tier; chunks unpack to int8 on device and ride the same int8 MXU path; "
                     "resident exact engine only — exclusive with shards/prefilter/streaming)"),
        ConfigOption("rescore", 200, "quantize=int4 two-stage depth: the packed engine "
                     "retrieves this many candidates and a full-precision MaxSim rescore "
                     "from the memory-mapped token-embedding disk cache restores the exact "
                     "ranking (0 disables: rank by the 4-bit scores directly)"),
        ConfigOption("hbmbudget", 12000.0, "HBM budget (MB) for the resident token-embedding "
                     "tensor; corpora above it stream host-resident chunks through the device "
                     "with a running on-device top-k merge (the late-interaction analogue of the "
                     "sparse engine's host-streaming postings; composes with quantize=int8)"),
    ]
    config_keys_not_in_path = ["batch", "chunk", "shards", "hbmbudget"]  # none change results

    device = None  # set by the service or the caller; None means "cuda"
    devices = None  # the shards' devices when shards > 1; None means the first ``shards`` cards

    def build(self):
        if int(self.config["dim"]) <= 0 or int(self.config["chunk"]) <= 0:
            raise ConfigError("colbert searcher dim and chunk must be positive")
        if int(self.config["prefilter"]) > 0 and int(self.config["shards"]) > 1:
            raise ConfigError("colbert searcher prefilter is single-device; use shards=1 "
                              "(the exact sharded path) or prefilter=0")
        if self.config["quantize"] not in (None, "none", "int8", "int4"):  # "none" casts to None
            raise ConfigError(f"colbert quantize must be 'none', 'int8', or 'int4', "
                              f"got {self.config['quantize']!r}")
        if self.config["quantize"] == "int4" and (int(self.config["shards"]) > 1
                                                  or int(self.config["prefilter"]) > 0):
            raise ConfigError("colbert quantize=int4 runs the resident exact engine only: "
                              "set shards=1 and prefilter=0 (use int8 for those combos)")
        self.setup_seconds = {"tokenize": 0.0, "encode": 0.0, "quantize": 0.0, "upload": 0.0}
        self.docs_encoded = 0  # documents this searcher's encoder embedded for the cache

    # ------------------------------------------------------------------ encoder
    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    def _encoder(self):
        """The ColBERT model on the searcher's device, in eval mode: random
        init (seeded, so a random-init cache key always means the same
        weights) for ``tiny`` or ``allowrandominit``, the pretrained
        encoder's when its checkpoint was read, the ``checkpointfile``'s
        weights over both when one is given."""
        if getattr(self, "_enc", None) is None:
            from capreolus_tpu_torch.convert import bert_state_dict, load_params
            from capreolus_tpu_torch.reranker.bert import load_pretrained_encoder
            from capreolus_tpu_torch.reranker.colbert import ColBERTModel

            name = self.config["pretrained"]
            cfg, bert_params = load_pretrained_encoder(
                name, allow_random_init=bool(self.config["allowrandominit"]) or name == "tiny")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = ColBERTModel(cfg, dim=int(self.config["dim"]))
            self._random_init = bert_params is None
            if bert_params is not None:
                model.bert.load_state_dict(bert_params)
            ckpt = self.config.get("checkpointfile")
            if ckpt:
                flat = load_params(ckpt)
                tree = {key.split("/")[1] for key in flat if key.startswith("params/") and key.count("/") >= 2}
                for sub in ("bert", "linear"):
                    if sub not in tree:
                        raise ValueError(f"checkpoint {ckpt} has no '{sub}' submodule "
                                         f"(top-level keys: {sorted(tree)[:8]}) — expected a "
                                         f"trained colbert reranker checkpoint")
                model.load_state_dict(bert_state_dict(flat))
                self._random_init = False
                logger.info("colbert searcher weights restored from %s", ckpt)
            self._enc = model.to(self._device()).eval()
        return self._enc

    def _tokenize(self, texts, maxlen):
        tok = self.tokenizer
        inp = np.zeros((len(texts), maxlen), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [tok.cls_id] + tok.convert_tokens_to_ids(tok.tokenize(text)[: maxlen - 2]) + [tok.sep_id]
            inp[i, : len(ids)] = ids
        return inp

    def encode_queries(self, toks):
        """[B, maxqlen] ids -> [B, maxqlen, dim] f32 query embeddings on the device."""
        model = self._encoder()
        with torch.inference_mode(), matmul_f32():
            q_emb, _ = model.encode_query(torch.from_numpy(np.asarray(toks)).to(self._device()))
        return q_emb

    # ------------------------------------------------------------------ doc embeddings
    def _doc_cache_file(self):
        """Keyed as the JAX searcher keys it: encoder identity + checkpoint
        identity + tokenizer fingerprint + random-init marker + dim/maxdoclen."""
        self._encoder()
        parts = [self.config["pretrained"], str(self.config["dim"]), str(self.config["maxdoclen"]),
                 self.tokenizer.fingerprint,
                 "randominit" if getattr(self, "_random_init", False) else "pretrained"]
        ckpt = self.config.get("checkpointfile")
        if ckpt:
            from capreolus_tpu_torch.convert import params_file

            st = os.stat(params_file(ckpt))
            parts += [ckpt, str(st.st_size), str(st.st_mtime_ns)]
        key = hashlib.md5("|".join(parts).encode()).hexdigest()[:16]
        return self.index.get_cache_path() / "colbert" / f"doc_token_embeddings_{key}.emb.npy"

    @staticmethod
    def _mask_for(emb_fn):
        return Path(str(emb_fn)[: -len(".emb.npy")] + ".mask.npy")

    def _mask_file(self):
        return self._mask_for(self._doc_cache_file())

    def _current_doc_cache_file(self):
        """The generation's cache the loaded corpus came from (set by
        ``_doc_tensors``): the int4 rescore and the streamed int8 cache read
        this one, never the generation-0 name."""
        fn = getattr(self, "_active_cache_fn", None)
        return fn if fn is not None else self._doc_cache_file()

    def _encode_doc_batches(self, docids, maxlen):
        """Encode the given docids' tokens, ``batch`` docs at a time. Returns
        ([n, Ld, dim] f16 embeddings, [n, Ld] int8 masks); adds the host's
        tokenization and the encoder's time to ``setup_seconds``."""
        model = self._encoder()
        device = self._device()
        batch = int(self.config["batch"])
        embs, masks = [], []
        for start in range(0, len(docids), batch):
            t0 = time.perf_counter()
            texts = [self.index.get_doc(d) for d in docids[start : start + batch]]
            toks = torch.from_numpy(self._tokenize(texts, maxlen))
            t1 = time.perf_counter()
            with torch.inference_mode(), matmul_f32():
                e, m = model.encode_doc(toks.to(device))
                embs.append(e.cpu().numpy().astype(np.float16))
                masks.append(m.cpu().numpy().astype(np.int8))
            self.setup_seconds["tokenize"] += t1 - t0
            self.setup_seconds["encode"] += time.perf_counter() - t1
        self.docs_encoded += len(docids)
        dim = int(self.config["dim"])
        emb = np.concatenate(embs) if embs else np.zeros((0, maxlen, dim), np.float16)
        mask = np.concatenate(masks) if masks else np.zeros((0, maxlen), np.int8)
        return emb, mask

    def _qmode(self):
        return self.config["quantize"] or "none"  # "none" casts to None

    def _token_cache(self, docid_strings, gen):
        """The generation's [N, Ld, dim] f16 embeddings and [N, Ld] int8 masks,
        memory-mapped from the disk cache, written on first use: from the
        previous generation's cache where one exists (the surviving docs' rows
        copied, or the files hardlinked when no doc changed), encoding only
        the docs it lacks (``embedding_cache.py``, the JAX searcher's rule)."""
        from capreolus_tpu_torch.searcher import embedding_cache as ec

        base_fn = self._doc_cache_file()
        cache_fn = ec.generation_path(base_fn, gen)
        mask_fn = self._mask_for(cache_fn)
        self._active_cache_fn = cache_fn
        if not (cache_fn.exists() and mask_fn.exists()):
            maxlen = int(self.config["maxdoclen"])
            emb = None
            prev, prev_gen = ec.find_previous(base_fn, gen)
            if prev is not None:
                old_e = np.load(prev, mmap_mode="r")
                old_m = np.load(self._mask_for(prev), mmap_mode="r")
                src = ec.row_sources(ec.read_docids(prev), docid_strings)
                if ec.identity_remap(src, old_e.shape[0]):
                    ec.link_identical(self._mask_for(prev), mask_fn)
                    ec.link_identical(prev, cache_fn)
                else:
                    emb = np.empty((len(docid_strings),) + old_e.shape[1:], dtype=old_e.dtype)
                    mask = np.empty((len(docid_strings),) + old_m.shape[1:], dtype=old_m.dtype)
                    reused = ec.fill_kept_rows([emb, mask], [old_e, old_m], src)
                    new_idx = np.flatnonzero(src < 0)
                    if len(new_idx):
                        emb[new_idx], mask[new_idx] = self._encode_doc_batches(
                            [docid_strings[i] for i in new_idx], maxlen)
                    logger.info("colbert cache gen %d built from gen %d: reused %d rows, encoded %d new documents",
                                gen, prev_gen, reused, len(new_idx))
            else:
                logger.info("embedding %d documents' tokens with the %s colbert encoder",
                            len(docid_strings), self.config["pretrained"])
                emb, mask = self._encode_doc_batches(docid_strings, maxlen)
            if emb is not None:
                # mask first, emb last: the existence check needs both, and
                # each write is atomic with its own race guard
                for fn, arr in ((mask_fn, mask), (cache_fn, emb)):
                    try:
                        with cached_file(fn, "wb") as f:
                            np.save(f, arr)
                    except TargetFileExists:
                        pass
        ec.write_docids(cache_fn, docid_strings)
        ec.prune_old_generations(base_fn, gen)
        return np.load(cache_fn, mmap_mode="r"), np.load(mask_fn, mmap_mode="r")

    def _doc_tensors(self):
        """The search-time corpus of the index's loaded generation: on the
        device (docs_t [Ld, N, dim] bf16, bias_t [Ld, N] f32, valid [N] bool),
        the f16 values rounded to bf16 on upload (the two roundings of the
        JAX searcher); or, quantized, (codes, mask [N, Ld] bool, scales [N]
        f32) from ``_upload_quantized``; or above ``hbmbudget`` a
        ``_HostTokens`` that the streamed engine reads slice by slice."""
        self.index.create_index()
        docid_strings = self.index.data.docid_strings  # merges pending index ops first
        gen = getattr(self.index, "_loaded_generation", 0)
        if getattr(self, "_docs_emb", None) is not None and getattr(self, "_docs_emb_gen", 0) == gen:
            return self._docs_emb
        self._docs_emb = None
        self._docs_emb_gen = gen
        emb, mask = self._token_cache(docid_strings, gen)
        n_docs, ld, dim = emb.shape
        qmode = self._qmode()
        dev_bytes = self._device_bytes(emb, mask)
        budget_bytes = float(_hbm_budget_mb(self.config)) * 1e6
        if dev_bytes <= budget_bytes:
            self._docs_emb = self._upload(emb, mask) if qmode == "none" else self._upload_quantized(emb, mask, qmode)
            return self._docs_emb
        if qmode == "int4":
            raise ConfigError("colbert quantize=int4 is resident-only; the packed corpus "
                              f"({dev_bytes / 1e6:.0f} MB) exceeds hbmbudget — raise the "
                              "budget or use quantize=int8 (which composes with streaming)")
        logger.info("colbert corpus (%d docs, %.0f MB device bytes) exceeds hbmbudget=%.0f MB: "
                    "host-streaming mode (chunked uploads + running top-k merge)",
                    n_docs, dev_bytes / 1e6, budget_bytes / 1e6)
        if qmode == "int8":
            from capreolus_tpu_torch.searcher.dense import _quantized_disk_cache

            t0 = time.perf_counter()
            q2d, scale = _quantized_disk_cache(self._current_doc_cache_file(), emb.reshape(n_docs, ld * dim), "int8")
            self.setup_seconds["quantize"] += time.perf_counter() - t0
            self._docs_emb = _HostTokens(q2d, mask, scale)
        else:
            self._docs_emb = _HostTokens(emb, mask)
        return self._docs_emb

    def _device_bytes(self, emb, mask):
        """Device bytes of the [N, Ld, dim] corpus in the configured representation."""
        n_docs, ld, dim = emb.shape
        qmode = self._qmode()
        per_doc = {"int8": ld * dim, "int4": (ld * dim + (ld * dim) % 2) // 2}.get(qmode, 2 * ld * dim)
        return n_docs * per_doc + mask.size + (4 * n_docs if qmode != "none" else 0)

    def _upload_quantized(self, emb, mask, qmode, device=None):
        """The f16 host cache quantized per doc, as the JAX searcher quantizes
        it, then on ``device`` (the searcher's by default): (int8 [N, Ld, dim]
        or int4 nibbles [N, ceil(Ld*dim/2)] uint8, mask [N, Ld] bool, scales
        [N] f32)."""
        from capreolus_tpu_torch.ops.quantization import quantize_rows, quantize_rows_int4

        t0 = time.perf_counter()
        n_docs, ld, dim = emb.shape
        if qmode == "int4":
            codes, scale = quantize_rows_int4(np.asarray(emb).reshape(n_docs, ld * dim))
        else:
            codes, scale = quantize_rows(np.asarray(emb))
        t1 = time.perf_counter()
        device = device or self._device()
        corpus = (torch.from_numpy(codes).to(device), torch.from_numpy(np.asarray(mask) > 0).to(device),
                  torch.from_numpy(scale).to(device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_seconds["quantize"] += t1 - t0
        self.setup_seconds["upload"] += time.perf_counter() - t1
        return corpus

    def _upload(self, emb, mask, device=None):
        """The [N, Ld, dim] f16 host cache as the token-major corpus on
        ``device`` (the searcher's by default), copied a few tokens at a time
        so that no second full copy exists."""
        t0 = time.perf_counter()
        device = device or self._device()
        n_docs, ld, dim = emb.shape
        docs_t = torch.empty((ld, n_docs, dim), dtype=torch.bfloat16, device=device)
        step = max(1, UPLOAD_BYTES // max(1, 2 * n_docs * dim))
        for k0 in range(0, ld, step):
            part = np.ascontiguousarray(np.swapaxes(emb[:, k0 : k0 + step], 0, 1))  # [step, N, dim] f16
            docs_t[k0 : k0 + part.shape[0]] = torch.from_numpy(part).to(device).to(torch.bfloat16)
        mask_t = torch.from_numpy(np.ascontiguousarray(np.asarray(mask).T)).to(device)  # [Ld, N]
        bias_t = torch.where(mask_t > 0, 0.0, MASKED_BIAS)  # f32, the default dtype
        valid = (mask_t > 0).any(dim=0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_seconds["upload"] += time.perf_counter() - t0
        return docs_t, bias_t, valid

    # ------------------------------------------------------------------ search
    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if not already:
                self._search_all(Path(topicsfn), output_path)
        return output_path

    def build_topk(self, hits):
        """``(topk(q_emb, *corpus) -> (scores, ordinals), corpus, n_corpus)``
        of the engine the config selects: the host stream above ``hbmbudget``
        (``corpus`` is then empty), the two-stage ``prefilter``, or the exact
        resident engine: one MaxSim call over the whole corpus (K3 on the
        card), or ``quantized_maxsim_scores`` over a quantized one, then the
        top ``hits`` with ties to the lower ordinal. int4 takes the top
        ``rescore`` and re-scores them (``_rescore_wrap``). Shared by the
        batch pipeline (``_search_all``) and the serving layer
        (``serving.ColbertRetrievalService``)."""
        from capreolus_tpu_torch.ops.maxsim import maxsim_scores

        shards = int(self.config["shards"])
        if shards > 1:
            return self._sharded_engine(hits, shards)
        corpus = self._doc_tensors()
        prefilter = int(self.config["prefilter"])
        if isinstance(corpus, _HostTokens):
            if prefilter > 0:
                raise ConfigError("colbert streaming (corpus > hbmbudget) runs the exact "
                                  "single-chip path: set shards=1 and prefilter=0, or raise "
                                  "hbmbudget (shards already partition the corpus across chips)")
            return self._streamed_topk(corpus, min(int(hits), corpus.n)), (), corpus.n
        qmode = self._qmode()
        n = corpus[0].shape[1] if qmode == "none" else corpus[0].shape[0]
        hits = min(int(hits), n)
        if prefilter > 0:
            return self._prefilter_topk(corpus, n, hits, min(prefilter, n)), corpus, n
        if qmode == "none":
            def topk(q_emb, docs_t, bias_t, valid):
                return topk_lower_ordinal_first(maxsim_scores(q_emb, docs_t, bias_t, valid), hits)

            return topk, corpus, n

        rescore = int(self.config["rescore"] or 0) if qmode == "int4" else 0
        engine_hits = min(max(rescore, hits), n) if rescore else hits

        def topk(q_emb, docs, mask, dscale):
            return topk_lower_ordinal_first(quantized_maxsim_scores(q_emb, docs, mask, dscale), engine_hits)

        return (self._rescore_wrap(topk, n, hits) if rescore else topk), corpus, n

    def _sharded_engine(self, hits, shards):
        """``build_topk`` under ``shards > 1`` (the JAX ``_sharded_topk``):
        shard s holds docs [s*per, (s+1)*per), per = ceil(N/S), on the s-th of
        ``self.devices``, uploaded from the host cache as the resident engine
        uploads the whole corpus (bf16 token-major, or int8 codes, masks and
        scales), with no resident copy of the whole. A corpus over
        ``hbmbudget`` raises JAX's message (streaming is single-device)."""
        from capreolus_tpu_torch.parallel.distributed import shard_devices
        from capreolus_tpu_torch.parallel.sharded_search import cached_shards

        self.index.create_index()
        docid_strings = self.index.data.docid_strings  # merges pending index ops first
        gen = getattr(self.index, "_loaded_generation", 0)
        emb, mask = self._token_cache(docid_strings, gen)
        n = emb.shape[0]
        qmode = self._qmode()
        if self._device_bytes(emb, mask) > float(_hbm_budget_mb(self.config)) * 1e6:
            raise ConfigError("colbert streaming (corpus > hbmbudget) runs the exact "
                              "single-chip path: set shards=1 and prefilter=0, or raise "
                              "hbmbudget (shards already partition the corpus across chips)")
        devices = shard_devices(shards, self.devices)
        per = -(-n // shards)
        ranges = [(min(n, s * per), min(n, (s + 1) * per)) for s in range(shards)]
        parts = cached_shards(self, gen, devices, lambda: tuple(
            None if lo == hi else  # a shard with no docs contributes nothing
            (self._upload(emb[lo:hi], mask[lo:hi], dev) if qmode == "none"
             else self._upload_quantized(emb[lo:hi], mask[lo:hi], qmode, dev))
            for (lo, hi), dev in zip(ranges, devices)))
        return self._sharded_topk(n, min(int(hits), n), devices, ranges), parts, n

    def _sharded_topk(self, n, hits, devices, ranges):
        """Per shard, one MaxSim call over its docs (K3 on a card, or X1 over
        int8 codes through ``quantized_maxsim_scores``) and its local top
        ``min(hits, docs)``, ties to the lower ordinal; every shard is
        launched before any result is copied; the candidates merge
        shard-major on the first device, ties to the lower ordinal. A doc's
        score does not depend on the other docs of its call, so it equals the
        resident engine's bit for bit. An int8 query batch is quantized once
        and its codes and scales serve every shard. Shards are not padded to a
        multiple of ``chunk``: K3 and X1 take any number of docs."""
        from capreolus_tpu_torch.ops.maxsim import maxsim_scores
        from capreolus_tpu_torch.ops.quantization import quantize_rows_torch
        from capreolus_tpu_torch.parallel.sharded_search import merge_shard_candidates

        quantized = self._qmode() != "none"

        def topk(q_emb, *parts):
            codes = quantize_rows_torch(q_emb) if quantized else None
            cands = []
            for dev, (lo, hi), part in zip(devices, ranges, parts):
                if part is None:
                    continue
                if quantized:
                    scores = quantized_maxsim_codes(*(t.to(dev) for t in codes), *part)
                else:
                    scores = maxsim_scores(q_emb.to(dev), *part)
                sv, so = topk_lower_ordinal_first(scores, min(hits, hi - lo))
                cands.append((sv, so + lo))
            return merge_shard_candidates(cands, hits, devices[0])

        return topk

    def pooled_docs(self, corpus):
        """[N, dim] bf16: each doc's mean valid-token embedding, the JAX
        stage 1's arithmetic (``m = (dmask > 0)`` in bf16, int8 codes times
        their bf16 scale in bf16, the sum over tokens, then a bf16 division by
        the count, at least 1). The sum is taken in f32 and rounded once, as
        XLA may widen a bf16 reduction. Computed a slice of docs at a time."""
        quantized = self._qmode() != "none"
        n = corpus[0].shape[0] if quantized else corpus[0].shape[1]
        dim = corpus[0].shape[-1]
        out = torch.empty((n, dim), dtype=torch.bfloat16, device=corpus[0].device)
        for d0 in range(0, n, POOL_DOCS):
            if quantized:
                codes, mask, scale = (t[d0 : d0 + POOL_DOCS] for t in corpus)
                d = codes.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None, None]  # [c, Ld, dim]
                m = mask.to(torch.bfloat16)[..., None]
                axis = 1
            else:
                docs_t, bias_t, _ = corpus
                d = docs_t[:, d0 : d0 + POOL_DOCS]  # [Ld, c, dim]
                m = (bias_t[:, d0 : d0 + POOL_DOCS] >= 0).to(torch.bfloat16)[..., None]
                axis = 0
            total = (d * m).float().sum(dim=axis).to(torch.bfloat16)
            count = torch.clamp_min(m.float().sum(dim=axis).to(torch.bfloat16), 1.0)
            out[d0 : d0 + total.shape[0]] = total / count
        return out

    def _prefilter_topk(self, corpus, n, hits, n_cand):
        """The JAX ``_prefilter_topk``: stage 1 is one bf16 product of each
        query's summed bf16 token embeddings against ``pooled_docs`` (f32
        scores), whose top ``n_cand`` (ties to the lower ordinal) are the
        query's candidates; stage 2 scores exact MaxSim over them, one call
        per query (K3 over the gathered token-major slab, or X1 over the
        gathered int8 rows), each candidate's score the exact engine's for
        that doc; the top ``min(hits, n_cand)`` by a stable descending sort in
        candidate order."""
        from capreolus_tpu_torch.ops.maxsim import maxsim_scores

        quantized = self._qmode() != "none"
        pooled = self.pooled_docs(corpus)
        hits = min(hits, n_cand)

        def topk(q_emb, *corpus_args):
            cand = prefilter_candidates(q_emb, pooled, n_cand)  # [Q, n_cand]
            s2 = torch.empty(cand.shape, dtype=torch.float32, device=q_emb.device)
            for qi in range(q_emb.shape[0]):
                c = cand[qi]
                if quantized:
                    codes, mask, scale = corpus_args
                    s2[qi] = quantized_maxsim_scores(q_emb[qi : qi + 1], codes[c], mask[c], scale[c])[0]
                else:
                    docs_t, bias_t, valid = corpus_args
                    s2[qi] = maxsim_scores(q_emb[qi : qi + 1], docs_t[:, c].contiguous(), bias_t[:, c].contiguous(),
                                           valid[c])[0]
            values, order = torch.sort(s2, dim=1, descending=True, stable=True)
            return values[:, :hits], torch.gather(cand, 1, order[:, :hits])

        self.prefilter_candidates = n_cand
        return topk

    def _streamed_topk(self, host, hits):
        """The JAX ``_streamed_topk`` for a corpus above ``hbmbudget``: per
        query batch, slices of ``budget // 2 // row_bytes`` docs (JAX's
        ``row_bytes``), rounded down to a multiple of ``chunk``, are uploaded
        and folded into a running top-k (``streamed.streamed_topk``, the
        running list first on ties). A bf16 slice is the f16 memmap's rows
        converted to bf16 and transposed to [Ld, slice, dim] on the host, then
        scored by K3; an int8 slice is the disk cache's rows, scored by
        ``quantized_maxsim_scores``. ``stream_slices`` counts the slices of
        one query batch, ``stream_slice_docs`` the docs of a slice."""
        from capreolus_tpu_torch.ops.maxsim import maxsim_scores
        from capreolus_tpu_torch.searcher.streamed import streamed_topk

        ld = host.mask.shape[1]
        dim = int(self.config["dim"])
        quantized = host.scale is not None
        row_bytes = ld * dim * (1 if quantized else 2) + ld + (4 if quantized else 0)
        chunk = min(int(self.config["chunk"]), max(host.n, 1))
        per_upload = int(max(1, float(_hbm_budget_mb(self.config)) * 1e6 // 2 // row_bytes))
        upload = max(chunk, per_upload - per_upload % chunk)
        device = self._device()

        def to_device(array):
            return torch.from_numpy(np.array(array)).to(device)

        def make_chunk(start):
            mask = np.asarray(host.mask[start : start + upload]) > 0  # [u, Ld]
            if quantized:
                rows = np.asarray(host.emb[start : start + upload]).reshape(-1, ld, dim)
                return to_device(rows), to_device(mask), to_device(host.scale[start : start + upload])
            rows = torch.from_numpy(np.array(host.emb[start : start + upload]))  # [u, Ld, dim] f16
            docs_t = torch.empty((ld, rows.shape[0], dim), dtype=torch.bfloat16)
            docs_t.copy_(rows.transpose(0, 1))  # bf16 and K3's token-major layout in one host pass
            mask_t = torch.from_numpy(np.ascontiguousarray(mask.T)).to(device)  # [Ld, u], K3's layout
            return docs_t.to(device), torch.where(mask_t, 0.0, MASKED_BIAS), mask_t.any(dim=0)

        def score_chunk(q_emb, chunk_tensors):
            if quantized:
                return quantized_maxsim_scores(q_emb, *chunk_tensors)
            return maxsim_scores(q_emb, *chunk_tensors)

        self.stream_slices, self.stream_slice_docs = -(-host.n // upload), upload
        logger.info("streaming colbert search: %d-doc upload slices (%.0f MB each), %d/query-batch",
                    upload, upload * row_bytes / 1e6, self.stream_slices)
        return streamed_topk(make_chunk, score_chunk, host.n, upload, hits)

    def _rescore_wrap(self, base_topk, n, hits):
        """Two-stage int4 MaxSim (the JAX ``_rescore_wrap``): the packed
        engine's candidates are re-scored at full precision from the
        memory-mapped f16 doc-embedding cache (per query: f32 [Lq, dim] x [dim,
        r*Ld] on the query's device, masked max, sum), and the top ``hits`` of
        those scores come back, ties in the engine's candidate order."""
        cache_fn = self._current_doc_cache_file()
        emb_mm = np.load(cache_fn, mmap_mode="r")
        mask_mm = np.load(self._mask_for(cache_fn), mmap_mode="r")

        def topk(q_emb, *corpus):
            s, o = base_topk(q_emb, *corpus)
            valid = torch.isfinite(s) & (o < n)
            safe = torch.where(valid, o, 0).cpu().numpy()
            qf = q_emb.float()
            exact = torch.full(s.shape, float("-inf"), device=s.device)
            for qi in range(o.shape[0]):
                cand = torch.from_numpy(emb_mm[safe[qi]]).to(qf.device).float()  # [r, Ld, dim]
                cmask = torch.from_numpy(np.asarray(mask_mm[safe[qi]]) > 0).to(qf.device)
                r, ld, dim = cand.shape
                sim = qf[qi] @ cand.reshape(r * ld, dim).T  # [Lq, r*Ld]
                sim = torch.where(cmask.reshape(1, r * ld), sim, MASKED_BIAS)
                per_tok = sim.reshape(-1, r, ld).amax(dim=-1)  # [Lq, r]
                exact[qi] = torch.where(valid[qi], per_tok.sum(dim=0), float("-inf"))
            values, order = torch.sort(exact, dim=1, descending=True, stable=True)
            k = min(hits, exact.shape[1])
            return values[:, :k], torch.gather(o, 1, order[:, :k])

        return topk

    def _search_all(self, topicsfn, output_path):
        from capreolus_tpu_torch.searcher.tpu import _load_topics_tsv

        topics = _load_topics_tsv(topicsfn)
        topk, corpus, n = self.build_topk(int(self.config["hits"]))
        docid_strings = self.index.data.docid_strings
        run = OrderedDict()
        batch = int(self.config["batch"])
        maxqlen = int(self.config["maxqlen"])
        for start in range(0, len(topics), batch):
            chunk_topics = topics[start : start + batch]
            q_emb = self.encode_queries(self._tokenize([t for _, t in chunk_topics], maxqlen))
            scores, ords = (x.cpu().numpy() for x in topk(q_emb, *corpus))
            for qi, (qid, _) in enumerate(chunk_topics):
                run[qid] = {docid_strings[int(o)]: float(s)
                            for s, o in zip(scores[qi], ords[qi])
                            if int(o) < n and np.isfinite(s)}

        outfn = output_path / f"searcher_colbert_dim-{self.config['dim']}"
        self._write_run(run, outfn)

    def _write_run(self, run, outfn):
        with open(outfn, "wt", encoding="utf-8") as f:
            for qid, docs_ in run.items():
                for rank, (docid, score) in enumerate(docs_.items(), start=1):
                    f.write(f"{qid} Q0 {docid} {rank} {score:.6f} capreolus_tpu\n")
        logger.info("wrote colbert run file %s (%d queries)", outfn, len(run))
