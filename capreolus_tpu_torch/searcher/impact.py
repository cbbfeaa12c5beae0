"""Learned-sparse impact retrieval (uniCOIL / SPLADE) on the GPU: the JAX
package's ``searcher/impact.py``.

A trained term-weighting encoder's document impacts are quantized into an
inverted index and served by the port's sparse engine (``scoring.py``) with
its ``impact`` model (score = sum over terms of qweight(t) * impact(t, d)), on
the exact or tiered path, with ``maxpostings`` early termination and host
streaming above ``hbmbudget``, as BM25 is served.

- Encoders (K2 in every layer on the card): ``unicoil``'s token weights (MAX
  over a document's occurrences, SUM over a query's), the ``unicoil``
  reranker's exact-match score up to the impact quantization; ``splade``'s
  vocabulary expansion (``SpladeModel.rep``, its max over positions taken a
  chunk at a time), each text keeping its ``topterms`` highest entries.
- The cache holds RAW f32 impacts in doc-major order (``.npz``: doc_offsets,
  term_ids, raw_impacts, the JAX searcher's format and key), so that a cache
  either package writes loads in the other.
- ``_csr_from_doc_major``: Anserini-style linear quantization over the corpus
  maximum, ``rint(raw * (2^b - 1) / max)``, zero postings dropped, the CSR
  sorted by term, then impact descending, then doc ascending. ``rint`` is a
  step function: a raw impact a rounding apart from the JAX one can straddle
  a .5 boundary, so the two packages' CSRs are equal from the same raw
  impacts, and within a level from their own encoders.
- Queries: the dequantization is folded into the query weights (``w /
  scale``), so the scores are the true quantized-impact dot products; terms
  outside the indexed vocabulary are dropped.

``pretrained="tiny"`` is a seeded random init of the port's own (encoder and
head); a ``checkpointfile`` is a trained ``unicoil`` / ``splade`` reranker's
``dev.best.params`` from either trainer (``bert`` and ``tokweight`` / ``mlm``),
or a ``trainer.ckpt=sharded`` directory. The raw cache follows the index's
generations (``embedding_cache.py``): an incremental merge encodes only the
added docs, and the CSR is re-quantized over the new corpus as a fresh build
would be. The searcher runs on ``self.device`` (``None`` means "cuda").
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker.common import matmul_f32
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.utils.caching import TargetFileExists, cached_file, done_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

# the submodules of each head, as the JAX searcher checks a checkpoint's head
HEAD_SUBMODULES = {"tokweight": ["bias", "kernel"], "mlm": ["decoder", "transform", "transform_ln"]}


@Searcher.register
class ImpactSearcher(Searcher):
    """End-to-end learned-sparse retrieval over a quantized impact index."""

    module_name = "impact"
    dependencies = [
        Dependency(key="index", module="index", name="tpu"),
        Dependency(key="tokenizer", module="tokenizer", name="berttokenizer"),
    ]
    config_spec = [
        ConfigOption("pretrained", "tiny", "encoder checkpoint (bert names; 'tiny' for offline smoke)"),
        ConfigOption("encoder", "unicoil", "weighting family: 'unicoil' (exact-match token "
                     "weights, reranker/unicoil.py) or 'splade' (vocab-expansion "
                     "representations, reranker/splade.py — docs may be indexed under "
                     "terms they never contain)"),
        ConfigOption("topterms", 256, "splade only: per-document expansion terms kept "
                     "(highest-weight vocab entries); queries keep at most the same count",
                     value_type="int"),
        ConfigOption("checkpointfile", None, "trained unicoil/splade checkpoint (dev.best.params) "
                     "providing the 'bert' encoder and the weighting head "
                     "('tokweight' for unicoil, 'mlm' for splade)"),
        ConfigOption("maxdoclen", 256, "document tokens fed to the encoder"),
        ConfigOption("maxqlen", 32, "query tokens fed to the encoder"),
        ConfigOption("batch", 128, "encoding batch size"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("quantbits", 8, "impact quantization bits (Anserini-style linear "
                     "quantization to 2^b - 1 levels over the corpus max impact)", value_type="int"),
        ConfigOption("maxpostings", 0, "impact-ordered early termination: score only each "
                     "term's N highest-impact postings (0 = exact)", value_type="int"),
        ConfigOption("hbmbudget", 12000.0, "device budget (MB) for the resident impact tiles; "
                     "corpora above it host-stream per-batch working sets, same engine "
                     "machinery as BM25 (searcher/scoring.py streaming mode)"),
        ConfigOption("allowrandominit", False, "allow a randomly-initialized encoder when the "
                     "checkpoint cannot be loaded (smoke tests only)"),
        ConfigOption("gelu", "tanh", "GELU variant — must match the checkpoint's training "
                     "config (reranker.gelu) or serving weights diverge from the trained model"),
    ]
    config_keys_not_in_path = ["batch", "hbmbudget"]  # results-invariant (streaming equality pinned)

    device = None  # set by the service or the caller; None means "cuda"

    def build(self):
        if not 1 <= int(self.config["quantbits"]) <= 16:
            raise ConfigError(f"impact quantbits must be in [1, 16], got {self.config['quantbits']}")
        if self.config["encoder"] not in ("unicoil", "splade"):
            raise ConfigError(f"impact encoder must be 'unicoil' or 'splade', "
                              f"got {self.config['encoder']!r}")
        if self.config["gelu"] not in ("tanh", "erf"):
            raise ConfigError(f"impact gelu must be 'tanh' or 'erf', got {self.config['gelu']!r}")
        self.setup_seconds = {"tokenize": 0.0, "encode": 0.0, "csr": 0.0}
        self.docs_encoded = 0  # documents this searcher's encoder weighted for the cache

    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    # ------------------------------------------------------------------ encoder
    def _encoder(self):
        """The weighting model on the searcher's device, in eval mode: a
        ``UniCoilModel`` (``weights``: [B, L] token weights) or a
        ``SpladeModel`` (``rep``: [B, V] expansions); flax's initial draws from
        a generator seeded with 0 (none with a ``checkpointfile``, which
        overwrites every weight), the pretrained encoder over ``bert``, and a
        ``checkpointfile``'s ``bert`` and head over both."""
        if getattr(self, "_enc", None) is None:
            from capreolus_tpu_torch.convert import bert_state_dict, init_flax_, load_params
            from capreolus_tpu_torch.reranker.bert import load_pretrained_encoder
            from capreolus_tpu_torch.reranker.splade import SpladeModel
            from capreolus_tpu_torch.reranker.unicoil import UniCoilModel

            name = self.config["pretrained"]
            splade = self.config["encoder"] == "splade"
            cfg, params = load_pretrained_encoder(
                name, allow_random_init=bool(self.config["allowrandominit"]) or name == "tiny")
            cfg = dataclasses.replace(cfg, gelu_approximate=(self.config["gelu"] == "tanh"))
            tok = self.tokenizer
            if splade:
                model = SpladeModel(cfg, vocab_size=int(tok.vocab_size), cls_id=int(tok.cls_id),
                                    sep_id=int(tok.sep_id))
            else:
                model = UniCoilModel(cfg, cls_id=int(tok.cls_id), sep_id=int(tok.sep_id))
            ckpt = self.config.get("checkpointfile")
            if not ckpt:  # a checkpoint overwrites every weight: its draws would be discarded
                init_flax_(model, torch.Generator().manual_seed(0))
            self._random_init = params is None
            if params is not None:
                model.bert.load_state_dict(params)
            elif name != "tiny":
                logger.warning("impact encoder %s running from RANDOM init", name)
            head_key = "mlm" if splade else "tokweight"
            if ckpt:
                flat = load_params(ckpt)
                tree = {key.split("/")[1] for key in flat if key.startswith("params/") and key.count("/") >= 2}
                missing = [k for k in ("bert", head_key) if k not in tree]
                if missing:
                    raise ValueError(f"checkpoint {ckpt} lacks {missing} (top-level keys: "
                                     f"{sorted(tree)[:8]}); expected a trained "
                                     f"{self.config['encoder']} checkpoint")
                restored_head = sorted({key.split("/")[2] for key in flat if key.startswith(f"params/{head_key}/")})
                if restored_head != HEAD_SUBMODULES[head_key]:
                    raise ValueError(
                        f"checkpoint {ckpt}'s '{head_key}' head has submodules "
                        f"{restored_head} but this version expects "
                        f"{HEAD_SUBMODULES[head_key]}; the checkpoint predates the current "
                        f"head architecture — retrain or use the matching version")
                state = bert_state_dict({k: v for k, v in flat.items()
                                         if k.startswith(("params/bert/", f"params/{head_key}/"))})
                model.load_state_dict(state)
                self._random_init = False
                logger.info("impact encoder + %s head restored from %s", head_key, ckpt)
            self._enc = model.to(self._device()).eval()
        return self._enc

    def _encode_batches(self, texts, maxlen):
        """Tokenize + run the weighting head; yields (n, inp, out) per batch of
        ``batch`` texts (the last one not padded): out is [n, L] token weights
        (unicoil) or [n, V] reps (splade), numpy f32."""
        model = self._encoder()
        device = self._device()
        tok = self.tokenizer
        batch = int(self.config["batch"])
        splade = self.config["encoder"] == "splade"
        for start in range(0, len(texts), batch):
            t0 = time.perf_counter()
            chunk = texts[start : start + batch]
            inp = np.zeros((len(chunk), maxlen), dtype=np.int64)
            for i, text in enumerate(chunk):
                ids = [tok.cls_id] + tok.convert_tokens_to_ids(tok.tokenize(text or "")[: maxlen - 2]) + [tok.sep_id]
                inp[i, : len(ids)] = ids
            t1 = time.perf_counter()
            with torch.inference_mode(), matmul_f32():
                toks = torch.from_numpy(inp).to(device)
                out = model.rep(toks) if splade else model.weights(toks)[1]
                out = out.float().cpu().numpy()
            self.setup_seconds["tokenize"] += t1 - t0
            self.setup_seconds["encode"] += time.perf_counter() - t1
            yield len(chunk), inp, out

    def _token_weights(self, texts, maxlen):
        """unicoil: list of (ids [L], weights [L] f32) per text with
        [CLS]/[SEP]/[PAD] positions zeroed (they never score)."""
        tok = self.tokenizer
        out = []
        for n, inp, w in self._encode_batches(texts, maxlen):
            special = (inp == tok.cls_id) | (inp == tok.sep_id) | (inp == tok.pad_id)
            w = np.where(special, 0.0, w)
            out.extend((inp[i], w[i]) for i in range(n))
        return out

    def _sparse_reps(self, texts, maxlen):
        """splade: list of (term_ids, weights) per text — the top ``topterms``
        nonzero vocab entries of the expansion representation."""
        cap = max(1, int(self.config["topterms"]))
        out = []
        for n, _, reps in self._encode_batches(texts, maxlen):
            for i in range(n):
                row = reps[i]
                nz = np.nonzero(row > 0)[0]
                if len(nz) > cap:
                    nz = nz[np.argpartition(-row[nz], cap - 1)[:cap]]
                order = np.argsort(nz)
                out.append((nz[order].astype(np.int64), row[nz[order]].astype(np.float32)))
        return out

    def _doc_term_weights(self, texts):
        """Per-document (term_ids, impacts): unicoil aggregates MAX over token
        occurrences; splade representations are already per-term maxes."""
        maxdoclen = int(self.config["maxdoclen"])
        if self.config["encoder"] == "splade":
            return self._sparse_reps(texts, maxdoclen)
        out = []
        for ids, w in self._token_weights(texts, maxdoclen):
            keep = w > 0
            ids, w = ids[keep], w[keep]
            if len(ids):
                order = np.argsort(ids, kind="stable")
                ids, w = ids[order], w[order]
                uniq, start = np.unique(ids, return_index=True)
                impacts = np.maximum.reduceat(w, start).astype(np.float32)
            else:
                uniq = np.zeros(0, np.int64)
                impacts = np.zeros(0, np.float32)
            out.append((uniq.astype(np.int64), impacts))
        return out

    # ------------------------------------------------------------------ impact index
    def _cache_file(self):
        """Keyed as the JAX searcher keys it: encoder identity (checkpoint
        content through its size and mtime), family, gelu, topterms, maxdoclen,
        the raw doc-major format, the tokenizer and a random-init marker."""
        self._encoder()
        parts = [self.config["pretrained"], self.config["encoder"], self.config["gelu"],
                 str(self.config["topterms"]), str(self.config["maxdoclen"]),
                 "rawdocmajor", self.tokenizer.fingerprint,
                 "randominit" if getattr(self, "_random_init", False) else "pretrained"]
        ckpt = self.config.get("checkpointfile")
        if ckpt:
            from capreolus_tpu_torch.convert import params_file

            st = os.stat(params_file(ckpt))
            parts += [str(ckpt), str(st.st_size), str(st.st_mtime_ns)]
        key = hashlib.md5("|".join(parts).encode()).hexdigest()[:16]
        return self.index.get_cache_path() / "impact" / f"impact_raw_{key}.npz"

    def _encode_doc_major(self, docids):
        """Encode documents into doc-major raw-impact arrays:
        (doc_offsets [n+1], term_ids [P], raw_impacts f32 [P])."""
        texts = [self.index.get_doc(d) for d in docids]
        self.docs_encoded += len(texts)
        logger.info("encoding %d documents for the impact index (%s, %s)",
                    len(texts), self.config["encoder"], self.config["pretrained"])
        per_doc = self._doc_term_weights(texts)
        offs = np.zeros(len(texts) + 1, dtype=np.int64)
        terms, raws = [], []
        for i, (uniq, impacts) in enumerate(per_doc):
            offs[i + 1] = offs[i] + len(uniq)
            terms.append(np.asarray(uniq, np.int64))
            raws.append(np.asarray(impacts, np.float32))
        return (offs,
                np.concatenate(terms) if terms else np.zeros(0, np.int64),
                np.concatenate(raws) if raws else np.zeros(0, np.float32))

    def _raw_doc_major(self, docid_strings, gen):
        """Load or build the generation's raw doc-major cache, reusing the
        previous generation's rows for surviving documents (only added docs
        are encoded; the JAX searcher's rule for a variable-length layout)."""
        from capreolus_tpu_torch.searcher import embedding_cache as ec

        base_fn = self._cache_file()
        cache_fn = ec.generation_path(base_fn, gen)

        def load(fn):
            with np.load(fn) as z:
                return z["doc_offsets"], z["term_ids"], z["raw_impacts"]

        if cache_fn.exists():
            ec.write_docids(cache_fn, docid_strings)  # repairs a crash-orphaned sidecar
            return load(cache_fn)
        prev, prev_gen = ec.find_previous(base_fn, gen)
        if prev is None:
            offs, terms, raw = self._encode_doc_major(docid_strings)
        else:
            old_offs, old_terms, old_raw = load(prev)
            src = ec.row_sources(ec.read_docids(prev), docid_strings)
            if ec.identity_remap(src, len(old_offs) - 1):
                ec.link_identical(prev, cache_fn)
                ec.write_docids(cache_fn, docid_strings)
                ec.prune_old_generations(base_fn, gen)
                return load(cache_fn)
            keep = src >= 0
            new_idx = np.flatnonzero(~keep)
            if len(new_idx):
                e_offs, e_terms, e_raw = self._encode_doc_major([docid_strings[i] for i in new_idx])
            else:
                e_offs, e_terms, e_raw = np.zeros(1, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32)
            # one gather from [old ++ encoded]: per-doc source starts plus within-doc offsets
            n = len(docid_strings)
            lengths = np.zeros(n, dtype=np.int64)
            lengths[keep] = (old_offs[1:] - old_offs[:-1])[src[keep]]
            lengths[new_idx] = e_offs[1:] - e_offs[:-1]
            starts = np.zeros(n, dtype=np.int64)
            starts[keep] = old_offs[:-1][src[keep]]
            starts[new_idx] = len(old_terms) + e_offs[:-1]
            offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lengths, out=offs[1:])
            within = np.arange(int(offs[-1]), dtype=np.int64) - np.repeat(offs[:-1], lengths)
            gather = np.repeat(starts, lengths) + within
            terms = np.concatenate([old_terms, e_terms])[gather]
            raw = np.concatenate([old_raw, e_raw])[gather]
            logger.info("impact cache gen %d built from gen %d: reused %d docs, encoded %d new",
                        gen, prev_gen, int(keep.sum()), len(new_idx))
        try:
            with cached_file(cache_fn, "wb") as f:
                np.savez(f, doc_offsets=offs, term_ids=terms, raw_impacts=raw)
        except TargetFileExists:
            pass
        ec.write_docids(cache_fn, docid_strings)
        ec.prune_old_generations(base_fn, gen)
        return offs, terms, raw

    def _impact_index(self):
        """Build (or load) the quantized impact CSR of the index's loaded
        generation and wrap it in the sparse engine on the searcher's device.
        Returns (engine, docid_strings, scale), assigned in one statement so
        that a concurrent reader sees the old tuple or the new one."""
        from capreolus_tpu_torch.index.smallfloat import quantize_lengths
        from capreolus_tpu_torch.index.tpu import IndexData
        from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

        self.index.create_index()
        docid_strings = list(self.index.data.docid_strings)  # merges pending index ops first
        gen = getattr(self.index, "_loaded_generation", 0)
        cached = getattr(self, "_engine", None)
        if cached is not None and getattr(self, "_engine_gen", 0) == gen:
            return cached
        offs, term_ids_raw, raw = self._raw_doc_major(docid_strings, gen)
        t0 = time.perf_counter()
        term_offsets, doc_ids, q_impacts, doclens, scale = self._csr_from_doc_major(
            offs, term_ids_raw, raw, len(docid_strings))
        data = IndexData(
            term_offsets=term_offsets,
            doc_ids=doc_ids,
            tfs=q_impacts,
            doclens=doclens,
            norm_doclens=quantize_lengths(np.maximum(doclens, 1)),
            docid_strings=docid_strings,
            vocab=dict(getattr(self.tokenizer, "vocab", {}) or {}),
        )
        budget = float(self.config["hbmbudget"])
        engine = ScoringEngine(DeviceIndex(data, device=self._device(),
                                           hbm_budget=budget * 1e6 if budget > 0 else None))
        self.setup_seconds["csr"] += time.perf_counter() - t0
        self._engine_gen = gen
        self._engine = (engine, docid_strings, scale)
        return self._engine

    def _csr_from_doc_major(self, doc_offsets, term_ids, raw_impacts, num_docs):
        """Quantize raw impacts and build the (term-major, impact-desc) CSR:
        q = rint(w * scale), scale = (2^b - 1) / max_w, zero postings dropped,
        sorted by term, impact descending, doc ascending."""
        vocab_size = int(term_ids.max()) + 1 if len(term_ids) else 0
        max_w = float(raw_impacts.max()) if len(raw_impacts) else 0.0
        levels = (1 << int(self.config["quantbits"])) - 1
        scale = levels / max_w if max_w > 0 else 1.0
        quants = np.rint(raw_impacts * scale).astype(np.int32)
        lengths = doc_offsets[1:] - doc_offsets[:-1]
        docs = np.repeat(np.arange(num_docs, dtype=np.int32), lengths)
        keep = quants > 0
        terms, docs, quants = term_ids[keep], docs[keep], quants[keep]
        order = np.lexsort((docs, -quants, terms))
        terms, docs, quants = terms[order], docs[order], quants[order]
        term_offsets = np.zeros(vocab_size + 1, dtype=np.int64)
        np.add.at(term_offsets, terms + 1, 1)
        term_offsets = np.cumsum(term_offsets)
        doclens = np.zeros(num_docs, dtype=np.int32)
        ordc, counts = np.unique(docs, return_counts=True)
        doclens[ordc] = counts
        logger.info("impact index: %d postings over %d terms (scale %.3f, %d-bit)",
                    len(docs), vocab_size, scale, int(self.config["quantbits"]))
        return term_offsets, docs.astype(np.int32), quants, doclens, scale

    # ------------------------------------------------------------------ search
    def query_weights_batch(self, query_texts):
        """Per query, [(term_id, weight)], one encoder forward per batch:
        unicoil sums token weights per unique term; splade keeps the query's
        expansion representation."""
        maxqlen = int(self.config["maxqlen"])
        if self.config["encoder"] == "splade":
            return [list(zip(ids.tolist(), w.tolist())) for ids, w in self._sparse_reps(query_texts, maxqlen)]
        results = []
        for ids, w in self._token_weights(query_texts, maxqlen):
            keep = w > 0
            ids, w = ids[keep], w[keep]
            out = {}
            for t, x in zip(ids.tolist(), w.tolist()):
                out[t] = out.get(t, 0.0) + x
            results.append(sorted(out.items()))
        return results

    def query_weights(self, query_text):
        return self.query_weights_batch([query_text])[0]

    @staticmethod
    def term_lists(engine, scale, weights):
        """Query weights as the engine's term lists: dequantization folded in
        (``w / scale``), terms outside the indexed vocabulary dropped."""
        nt = engine.dindex.num_terms
        offs = engine.dindex.term_offsets
        return [[(t, w / scale) for t, w in qw if t < nt and offs[t + 1] > offs[t]] for qw in weights]

    def query_from_file(self, topicsfn, output_path):
        output_path = Path(output_path)
        with done_file(output_path) as already:
            if not already:
                self._search_all(Path(topicsfn), output_path)
        return output_path

    def _search_all(self, topicsfn, output_path):
        from capreolus_tpu_torch.searcher.tpu import _load_topics_tsv

        topics = _load_topics_tsv(topicsfn)
        engine, docid_strings, scale = self._impact_index()
        hits = int(self.config["hits"])
        n_docs = len(docid_strings)
        run = OrderedDict()
        batch = max(1, int(self.config["batch"]))
        for start in range(0, len(topics), batch):
            chunk = topics[start : start + batch]
            term_lists = self.term_lists(engine, scale, self.query_weights_batch([text for _, text in chunk]))
            scores, ords = engine.search(term_lists, model="impact", params={}, topk=hits,
                                         max_postings_per_term=int(self.config["maxpostings"]))
            for qi, (qid, _) in enumerate(chunk):
                run[qid] = {docid_strings[int(o)]: float(s)
                            for s, o in zip(scores[qi], ords[qi])
                            if int(o) < n_docs and s > 0.0}
        outfn = output_path / "searcher_impact"
        with open(outfn, "wt", encoding="utf-8") as f:
            for qid, docs_ in run.items():
                for rank, (docid, score) in enumerate(docs_.items(), start=1):
                    f.write(f"{qid} Q0 {docid} {rank} {score:.6f} capreolus_tpu\n")
        logger.info("wrote impact run file %s (%d queries)", outfn, len(run))
