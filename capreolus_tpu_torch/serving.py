"""Serving API: batched retrieve(-then-rerank) over a built index, on the GPU
(the ``RetrievalService`` and ``RerankingService`` of the JAX package's
``serving.py``).

    from capreolus_tpu_torch.serving import RetrievalService
    svc = RetrievalService.from_config(collection="dummy")         # on "cuda"
    hits = svc.search(["distant galaxies"], k=10)                  # [(docid, score)]

Services run on ``device="cuda"`` unless the caller passes another device; a
CUDA request without a card raises. The rerank stage serves KNRM (through K1)
and BERTMaxP (through K2 in every encoder layer, and X1 in every projection
and FFN matmul with ``quantize=int8``); ``ColbertRetrievalService`` serves
ColBERT late-interaction retrieval (K2 in the query encoder, K3 for MaxSim, or
X1 over an int8 / int4 corpus). ``RetrievalService`` serves BM25 through
exact block-max pruning by default (``pruning=True``, bit-identical to
exhaustive scoring) and streams postings above ``hbm_budget_mb``. Not ported
yet: ``shards``, ``refresh``, ``snippets``, the dense / impact / hybrid
services and the HTTP front end.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from capreolus_tpu_torch.core import ConfigError
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def resolve_device(device=None) -> torch.device:
    """``None`` means "cuda"; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    return dev


class RetrievalService:
    """The JAX service's parameters in its order, then ``device`` (keyword
    only). ``pruning`` serves a model that supports it through the engine's
    adaptive ``search_pruned``; ``hbm_budget_mb`` (0 = always resident) is the
    device budget above which the postings stream from the host. ``shards > 1``
    raises ``ConfigError`` until multi-device serving is ported."""

    def __init__(self, index, model: str = "bm25", params: Optional[dict] = None, batch_size: int = 64,
                 hbm_budget_mb: float = 12000.0, pruning: bool = True, shards: int = 0, *, device=None):
        from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

        self.shards = int(shards)
        if self.shards > 1:
            raise ConfigError(f"shards={self.shards}: multi-device serving is not ported to PyTorch yet "
                              f"(ROADMAP.md item 6, 'Multi-device')")
        self.device = resolve_device(device)
        index.create_index()
        self.index = index
        self.model = model
        self.params = dict(params or {"k1": 0.9, "b": 0.4})
        self.batch_size = batch_size
        self._hbm_budget_mb = hbm_budget_mb
        # exact block-max pruning; the engine's A/B probe turns it off where it does not pay
        self.pruning = bool(pruning)
        self.engine = ScoringEngine(DeviceIndex(index.data, device=self.device,
                                                hbm_budget=hbm_budget_mb * 1e6 if hbm_budget_mb > 0 else None))

    @classmethod
    def from_config(cls, collection: str = "dummy", collection_path: Optional[str] = None,
                    model: str = "bm25", params: Optional[dict] = None, shards: int = 0, device=None,
                    **index_config):
        import capreolus_tpu_torch

        capreolus_tpu_torch.load_all_modules()
        from capreolus_tpu_torch.index import Index

        coll_cfg = {"name": collection}
        if collection_path:
            coll_cfg["path"] = collection_path
        index = Index.create("tpu", {**index_config, "collection": coll_cfg})
        return cls(index, model=model, params=params, shards=shards, device=device)

    def _analyze(self, query: str, vocab):
        counts = Counter(self.index.analyze(query))
        return [(vocab[t], float(c)) for t, c in counts.items() if t in vocab]

    def search_async(self, queries: Sequence[str], k: int = 10):
        """Dispatch-now / collect-later variant of ``search`` (identical results):
        the device work is queued when this returns (on the tiered path its
        result copy too), and the returned zero-arg callable fetches the
        results and builds the hit lists."""
        from capreolus_tpu_torch.searcher.tpu import fetch

        engine = self.engine
        host = engine.dindex.host
        docids = host.docid_strings
        pending = []
        for start in range(0, len(queries), self.batch_size):
            batch = queries[start : start + self.batch_size]
            term_lists = [self._analyze(q, host.vocab) for q in batch]
            if self.pruning and engine.supports_pruning(self.model):
                res = engine.search_pruned(term_lists, model=self.model, params=self.params, topk=k,
                                           materialize=False)
            else:
                res = engine.search(term_lists, model=self.model, params=self.params, topk=k, materialize=False)
            pending.append((len(batch), res))

        def collect() -> List[List[Tuple[str, float]]]:
            results: List[List[Tuple[str, float]]] = []
            for n, res in pending:
                scores, ords = fetch(res)
                scores, ords = scores[0], ords[0]
                for qi in range(n):
                    hits = []
                    for s, o in zip(scores[qi], ords[qi]):
                        if s <= 0.0:
                            break
                        hits.append((docids[int(o)], float(s)))
                    results.append(hits)
            return results

        return collect

    def search(self, queries: Sequence[str], k: int = 10) -> List[List[Tuple[str, float]]]:
        """Returns, per query, the top-k (docid, score) pairs."""
        return self.search_async(queries, k)()

    def get_document(self, docid: str) -> Optional[str]:
        return self.index.get_doc(docid)


class RerankingService(RetrievalService):
    """Retrieve-then-rerank serving: first-stage engine + a trained reranker
    (KNRM over embedtext features, or a BERT cross-encoder such as BERTMaxP
    over bertpassage features, one batch of ``topn`` docs per query).

    ``checkpoint_path`` names the weights: a ``dev.best`` written by either
    trainer (its stem or its ``.params`` file, flax's msgpack bytes) or the
    flat ``params/...`` npz written by ``convert.save_params``. A BERT
    reranker with ``quantize=int8`` calibrates its activation scales once, on
    the first request's batch, before scoring it (the JAX ``_ensure_params``),
    unless the checkpoint carries its ``quant_stats``, which are then used as
    they are. ``extractor_state_path`` names the training-time extractor state
    (``extractor_state.pkl`` beside ``dev.best``), which the extractor restores
    in place of a preprocess over the whole corpus: a model with
    vocabulary-sized trained tables needs the training vocabulary.
    """

    def __init__(self, index, reranker, checkpoint_path, topn: int = 100,
                 extractor_state_path: Optional[str] = None, *, device=None, **kwargs):
        super().__init__(index, device=device, **kwargs)
        from capreolus_tpu_torch.convert import load_params
        from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

        self.reranker = reranker
        self.topn = topn
        self._collate = collate
        self._keys = ARRAY_KEYS
        t0 = time.perf_counter()
        if extractor_state_path:
            reranker.extractor.load_state(extractor_state_path)
        elif not getattr(reranker.extractor, "_preprocessed", False):
            # a fresh serving process: build the extractor state (vocab,
            # embeddings, doc tokens) over the whole corpus before the model,
            # whose embedding table is sized from it. Host time, reported apart
            # from the first request's
            reranker.extractor.preprocess([], list(index.data.docid_strings), {})
        self.extractor_seconds = time.perf_counter() - t0
        self.last_stage_ms = {}
        model = reranker.build_model()
        flat = load_params(checkpoint_path)
        model.load_state_dict(reranker.state_dict_from_params(flat))
        model.to(self.device).eval()  # in place: reranker.test runs reranker.model
        self._calibrate_pending = (getattr(reranker, "quantized", False)
                                   and not any(key.startswith("quant_stats/") for key in flat))

    def search_async(self, queries: Sequence[str], k: int = 10):
        """Two-stage dispatch/collect split: dispatch queues the first-stage
        retrieval; collect runs extraction and the reranker.

        Each collect sets ``last_stage_ms``: ``first_stage`` from dispatch until
        the first-stage hits are on the host, ``rerank`` from there until the
        reranked lists are built (both stages end in a device-to-host copy, so
        each span holds its own device work), and ``features``, the part of
        ``rerank`` the host spends building the reranker's input."""
        t0 = time.perf_counter()
        first_collect = RetrievalService.search_async(self, queries, k=max(self.topn, k))

        def collect():
            first_stage = first_collect()
            t1 = time.perf_counter()
            results, features_s = self._rerank_stage(queries, first_stage, k)
            self.last_stage_ms = {"first_stage": (t1 - t0) * 1e3, "rerank": (time.perf_counter() - t1) * 1e3,
                                  "features": features_s * 1e3}
            return results

        return collect

    def search(self, queries: Sequence[str], k: int = 10):
        return self.search_async(queries, k)()

    def rerank_batch(self, qid: str, query: str, docids: Sequence[str]) -> dict:
        """The reranker's collated input for one live query over ``docids``
        (numpy arrays; for a BERT reranker ``pos_bert_input``, ``pos_mask`` and
        ``pos_seg`` of shape [docs, numpassages, maxseqlen])."""
        extractor = self.reranker.extractor
        q_toks = extractor.tokenizer.tokenize(query)
        extractor.qid2toks[qid] = q_toks
        # live queries were never seen at preprocess time: fetch their idf
        # from the index now (idf-gated models read the query_idf feature)
        if hasattr(extractor, "idf") and extractor.config.get("calcidf", True):
            for tok in q_toks:
                if tok not in extractor.idf:
                    extractor.idf[tok] = self.index.get_idf(tok)
        samples = [extractor.id2vec(qid, docid, label=[1, 0], training=False) for docid in docids]
        return self._collate(samples, self._keys)

    def _rerank_stage(self, queries: Sequence[str], first_stage, k: int):
        """Returns (the reranked lists, host seconds spent building features)."""
        results, features_s = [], 0.0
        for qi, (query, hits) in enumerate(zip(queries, first_stage)):
            if not hits:
                results.append([])
                continue
            docids = [d for d, _ in hits]
            t0 = time.perf_counter()
            batch = self.rerank_batch(f"live{qi}", query, docids)
            features_s += time.perf_counter() - t0
            if self._calibrate_pending:
                self.reranker.prepare_inference(batch, self.device)
                self._calibrate_pending = False
            with torch.inference_mode():
                scores = self.reranker.test(batch, self.device).cpu().numpy()
            reranked = sorted(zip(docids, map(float, scores)), key=lambda kv: -kv[1])
            results.append(reranked[:k])
        return results, features_s


class _EmbeddingRetrievalService:
    """Shared serving core of the embedding searchers (the JAX package's;
    ColBERT late-interaction MaxSim is the one ported so far).

    Wraps the searcher's ``build_topk`` engine and keeps it warm across
    calls: the corpus stays on the device and the query encoder stays loaded.
    The JAX service pads every query batch to ``batch`` rows to keep one
    compiled shape; the port does not pad (every row is independent, so the
    results are the same, and a one-query request costs one query's work).
    Subclasses provide the searcher's registry name and the query-embedding
    hook; result filtering (-inf and out-of-corpus slots) lives here.
    """

    _searcher_name: str = ""

    def __init__(self, searcher, max_k: int = 100, device=None):
        self.device = resolve_device(device)
        searcher.device = self.device
        self.searcher = searcher
        self._topk, self._corpus, self._n = searcher.build_topk(max_k)
        self.max_k = min(int(max_k), self._n)
        self._docids = searcher.index.data.docid_strings
        self.batch_size = int(searcher.config["batch"])
        self._prepare()

    def refresh(self) -> bool:
        raise NotImplementedError("refresh (NRT reopen with incremental embedding caches) is not ported to "
                                  "PyTorch yet: ROADMAP.md item 6, 'ColBERT options'")

    def _prepare(self):
        """Subclass hook: warm the query encoder."""

    def _embed_batch(self, chunk: List[str]):
        """Subclass hook: encode <= batch_size queries."""
        raise NotImplementedError

    @classmethod
    def from_config(cls, collection: str = "dummy", collection_path: Optional[str] = None,
                    max_k: int = 100, device=None, **searcher_config):
        import capreolus_tpu_torch

        capreolus_tpu_torch.load_all_modules()
        from capreolus_tpu_torch.searcher import Searcher

        coll_cfg = {"name": collection}
        if collection_path:
            coll_cfg["path"] = collection_path
        index_cfg = searcher_config.pop("index", {})
        searcher = Searcher.create(cls._searcher_name,
                                   {**searcher_config, "index": {**index_cfg, "collection": coll_cfg}})
        return cls(searcher, max_k=max_k, device=device)

    def search_async(self, queries: Sequence[str], k: int = 10):
        """Dispatch-now / collect-later variant of ``search`` (identical results):
        the device work is queued when this returns."""
        k = min(int(k), self.max_k)
        topk, corpus, n, docids = self._topk, self._corpus, self._n, self._docids
        pending = []
        for start in range(0, len(queries), self.batch_size):
            chunk = list(queries[start : start + self.batch_size])
            scores, ords = topk(self._embed_batch(chunk), *corpus)
            pending.append((len(chunk), scores, ords))

        def collect() -> List[List[Tuple[str, float]]]:
            results: List[List[Tuple[str, float]]] = []
            for cn, dscores, dords in pending:
                scores, ords = dscores.cpu().numpy(), dords.cpu().numpy()
                for qi in range(cn):
                    hits = []
                    for s, o in zip(scores[qi][:k], ords[qi][:k]):
                        # -inf slots (fewer valid docs than k) never surface
                        if int(o) >= n or not np.isfinite(s):
                            continue
                        hits.append((docids[int(o)], float(s)))
                    results.append(hits)
            return results

        return collect

    def search(self, queries: Sequence[str], k: int = 10) -> List[List[Tuple[str, float]]]:
        """Returns, per query, the top-k (docid, score) pairs."""
        return self.search_async(queries, k)()

    def get_document(self, docid: str) -> Optional[str]:
        return self.searcher.index.get_doc(docid)


class ColbertRetrievalService(_EmbeddingRetrievalService):
    """Low-latency late-interaction (ColBERT MaxSim) serving over
    ``searcher/late_interaction.py``'s exact resident engine: MaxSim through
    K3 over a bf16 corpus, or through X1 over an int8 / int4 corpus
    (``quantize``), whose tuple (codes, mask, scales) the engine takes in place
    of (docs_t, bias_t, valid).

        svc = ColbertRetrievalService.from_config(collection="dummy", allowrandominit=True)
        hits = svc.search(["distant galaxies"], k=10)              # on "cuda"
    """

    _searcher_name = "colbert"

    def _prepare(self):
        self.maxqlen = int(self.searcher.config["maxqlen"])
        self.searcher._encoder()

    def _embed_batch(self, chunk):
        return self.searcher.encode_queries(self.searcher._tokenize(chunk, self.maxqlen))
