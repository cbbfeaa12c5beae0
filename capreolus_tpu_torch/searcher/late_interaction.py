"""Late-interaction (ColBERT) retrieval on the GPU: the JAX package's
``searcher/late_interaction.py``, exact resident engine.

Every document's tokens are embedded once with a ColBERT encoder, cached on
disk as f16, and uploaded to the device as one token-major bf16 tensor
[Ld, N, dim] with its mask bias [Ld, N] and doc-validity flags [N]: the layout
K3 (``ops/maxsim.py``, ``csrc/maxsim.cu``) reads, held once. A query batch is
scored against the whole corpus by one K3 call (the plain version on the CPU),
then the top ``hits`` are taken with ties to the lower doc ordinal, as
``jax.lax.top_k`` breaks them. ``chunk`` stays a config key and changes no
result, as in the JAX searcher: it bounded XLA's similarity tensor, which K3
never materialises.

The searcher runs on ``self.device``, an attribute (not a config option, so
the device never enters the module path) that the service or the caller sets;
``None`` means "cuda", which raises without a card.

Not ported yet; each raises ``ConfigError`` naming its ROADMAP item:
``quantize`` int8/int4, ``prefilter > 0``, ``shards > 1``, and corpora above
``hbmbudget`` (host streaming). The doc-embedding cache covers generation 0
only: the port's index has no generations, and incremental reuse comes with
``refresh``. Reading flax msgpack checkpoints comes with the trainer; a
``checkpointfile`` is the port's ``.npz`` (``convert.save_params``).
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
from capreolus_tpu_torch.searcher import Searcher, _hbm_budget_mb
from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file, done_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

MASKED_BIAS = -1e9  # additive bias of a masked doc token in bias_t, as in the JAX searcher
UPLOAD_BYTES = 64 << 20  # f16 bytes per host-to-device copy of the corpus


def topk_lower_ordinal_first(scores, k):
    """(values, indices) of the ``k`` largest scores per row, ties to the lower
    index, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no tie
    order on CUDA; a stable descending sort does)."""
    values, indices = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


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
        unported = (
            ("quantize", self.config["quantize"] in ("int8", "int4"),
             "quantized corpora; ROADMAP.md item 2, 'int8 with X1/X2'"),
            ("prefilter", int(self.config["prefilter"]) > 0,
             "two-stage candidate generation; ROADMAP.md item 6, 'ColBERT options'"),
            ("shards", int(self.config["shards"]) > 1,
             "the doc-sharded engine; ROADMAP.md item 6, 'ColBERT options'"),
        )
        for key, selects, what in unported:
            if selects:
                raise ConfigError(f"colbert searcher: {key}={self.config[key]!r} selects {what} "
                                  f"(not ported to PyTorch yet)")
        self.setup_seconds = {"tokenize": 0.0, "encode": 0.0, "upload": 0.0}

    # ------------------------------------------------------------------ encoder
    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    def _encoder(self):
        """The ColBERT model on the searcher's device, in eval mode: random
        init (seeded, so a random-init cache key always means the same
        weights) for ``tiny`` or ``allowrandominit``, the ``checkpointfile``'s
        weights when one is given."""
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
        with torch.inference_mode():
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
            st = os.stat(ckpt)
            parts += [ckpt, str(st.st_size), str(st.st_mtime_ns)]
        key = hashlib.md5("|".join(parts).encode()).hexdigest()[:16]
        return self.index.get_cache_path() / "colbert" / f"doc_token_embeddings_{key}.emb.npy"

    @staticmethod
    def _mask_for(emb_fn):
        return Path(str(emb_fn)[: -len(".emb.npy")] + ".mask.npy")

    def _mask_file(self):
        return self._mask_for(self._doc_cache_file())

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
            with torch.inference_mode():
                e, m = model.encode_doc(toks.to(device))
                embs.append(e.cpu().numpy().astype(np.float16))
                masks.append(m.cpu().numpy().astype(np.int8))
            self.setup_seconds["tokenize"] += t1 - t0
            self.setup_seconds["encode"] += time.perf_counter() - t1
        dim = int(self.config["dim"])
        emb = np.concatenate(embs) if embs else np.zeros((0, maxlen, dim), np.float16)
        mask = np.concatenate(masks) if masks else np.zeros((0, maxlen), np.int8)
        return emb, mask

    def _doc_tensors(self):
        """(docs_t [Ld, N, dim] bf16, bias_t [Ld, N] f32, valid [N] bool) on the
        device, from the disk cache of f16 embeddings and int8 masks (written
        on first use). The f16 values are rounded to bf16 on upload, the two
        roundings of the JAX searcher."""
        self.index.create_index()
        if getattr(self, "_docs_emb", None) is not None:
            return self._docs_emb
        docid_strings = self.index.data.docid_strings
        cache_fn = self._doc_cache_file()
        mask_fn = self._mask_for(cache_fn)
        if cache_fn.exists() and mask_fn.exists():
            emb = np.load(cache_fn, mmap_mode="r")
            mask = np.load(mask_fn, mmap_mode="r")
        else:
            logger.info("embedding %d documents' tokens with the %s colbert encoder",
                        len(docid_strings), self.config["pretrained"])
            emb, mask = self._encode_doc_batches(docid_strings, int(self.config["maxdoclen"]))
            # mask first, emb last: the existence check needs both, and each
            # write is atomic with its own race guard
            for fn, arr in ((mask_fn, mask), (cache_fn, emb)):
                try:
                    with cached_file(fn, "wb") as f:
                        np.save(f, arr)
                except TargetFileExists:
                    pass
        n_docs, ld, dim = emb.shape
        dev_bytes = n_docs * 2 * ld * dim + mask.size
        budget_bytes = float(_hbm_budget_mb(self.config)) * 1e6
        if dev_bytes > budget_bytes:
            raise ConfigError(f"colbert corpus ({n_docs} docs, {dev_bytes / 1e6:.0f} MB device bytes) exceeds "
                              f"hbmbudget={budget_bytes / 1e6:.0f} MB: host streaming is not ported to PyTorch "
                              f"yet (ROADMAP.md item 6, 'ColBERT options'); raise searcher.hbmbudget")
        self._docs_emb = self._upload(emb, mask)
        return self._docs_emb

    def _upload(self, emb, mask):
        """The [N, Ld, dim] f16 host cache as the token-major device corpus,
        copied a few tokens at a time so that no second full copy exists."""
        t0 = time.perf_counter()
        device = self._device()
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
        of the exact resident engine: one MaxSim call over the whole corpus
        (K3 on the card), then the top ``hits`` with ties to the lower ordinal.
        Shared by the batch pipeline (``_search_all``) and the serving layer
        (``serving.ColbertRetrievalService``)."""
        from capreolus_tpu_torch.ops.maxsim import maxsim_scores

        corpus = self._doc_tensors()
        n = corpus[0].shape[1]
        hits = min(int(hits), n)

        def topk(q_emb, docs_t, bias_t, valid):
            return topk_lower_ordinal_first(maxsim_scores(q_emb, docs_t, bias_t, valid), hits)

        return topk, corpus, n

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
