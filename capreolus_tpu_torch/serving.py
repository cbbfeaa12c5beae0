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
exhaustive scoring) and streams postings above ``hbm_budget_mb``.
``DenseRetrievalService`` serves the dense searcher's engines (K2 in the
query encoder; bf16, or X1 over an int8 / int4 corpus; IVF, streaming, PRF),
``ImpactRetrievalService`` the learned-sparse impact index on the sparse
engine, and ``HybridRetrievalService`` fuses two services' hit lists.

Every service has ``refresh()``, the NRT reopen (Lucene's
``SearcherManager.maybeRefresh``): it merges the index's pending incremental
ops (``TpuIndex.add_documents`` / ``delete_documents``) and, when the loaded
generation moved, swaps in an engine over it in one reference assignment, so
that an in-flight search keeps the engine it read; it returns True only when
the served generation changed. The embedding and impact caches are rebuilt
incrementally (only added docs are encoded). Every service has
``snippets(query, hits)`` (``analysis/highlight.py``) and ``_docids``, which
the HTTP front end (``serving_http.py``) reads.

``shards > 1`` serves a doc-sharded corpus (the JAX services' mesh of devices
in one process): ``RetrievalService`` (and ``RerankingService``'s first
stage) over ``parallel/sharded_search.py``, the dense and ColBERT services
over their searchers' sharded engines. The shards' devices are
``RetrievalService``'s ``devices`` (keyword only, beside ``device``) and an
embedding searcher's ``devices`` attribute: ``None`` takes the first
``shards`` cards, and too few raise; a list may repeat one device (several
shards on one card, or on the CPU). Results merge on the first of them.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from capreolus_tpu_torch.core import ConfigError
from capreolus_tpu_torch.reranker.common import matmul_f32
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.tracing import TimedSpan, span

logger = get_logger(__name__)


def resolve_device(device=None) -> torch.device:
    """``None`` means "cuda"; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _hit_lists(fetched, docids, keep) -> List[List[Tuple[str, float]]]:
    """Per query of each fetched (queries, scores, ords) batch, in rank order,
    its (docid, score) pairs at the slots ``keep(scores, ords)`` marks (a
    boolean array of the batch's shape)."""
    results: List[List[Tuple[str, float]]] = []
    with span("search.hits"):
        for n, scores, ords in fetched:
            kept = keep(scores, ords)
            for qi in range(n):
                row = kept[qi]
                results.append([(docids[int(o)], float(s)) for s, o in zip(scores[qi][row], ords[qi][row])])
    return results


def _positive_prefix(scores, ords):
    """Each row's slots before its first score <= 0 (scores descend; the zero
    or sentinel tail follows)."""
    return np.logical_and.accumulate(~(scores <= 0.0), axis=1)


class RetrievalService:
    """The JAX service's parameters in its order, then ``device`` and
    ``devices`` (keyword only). ``pruning`` serves a model that supports it
    through the engine's adaptive ``search_pruned``; ``hbm_budget_mb`` (0 =
    always resident) is the device budget above which the postings stream
    from the host. ``shards > 1`` partitions the postings by document range
    over ``devices`` (``None``: the first ``shards`` cards; a list may repeat
    one device), scores each shard on its device and merges the shards'
    candidates on the first (``parallel/sharded_search.py``); pruning does
    not apply there, as in JAX."""

    def __init__(self, index, model: str = "bm25", params: Optional[dict] = None, batch_size: int = 64,
                 hbm_budget_mb: float = 12000.0, pruning: bool = True, shards: int = 0, *, device=None,
                 devices=None):
        from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

        self.device = resolve_device(device)
        index.create_index()
        self.index = index
        self.model = model
        self.params = dict(params or {"k1": 0.9, "b": 0.4})
        self.batch_size = batch_size
        self._hbm_budget_mb = hbm_budget_mb
        # exact block-max pruning; the engine's A/B probe turns it off where it does not pay
        self.pruning = bool(pruning)
        self.shards = int(shards)
        self.devices = devices
        self._sharded = None  # (ShardedDeviceIndex, its IndexData), replaced in one assignment
        if self.shards > 1:
            self.engine = None
            self._build_sharded(index.data)
        else:
            self.engine = ScoringEngine(DeviceIndex(index.data, device=self.device,
                                                    hbm_budget=hbm_budget_mb * 1e6 if hbm_budget_mb > 0 else None))
        self._generation = getattr(index, "_loaded_generation", 0)

    def _build_sharded(self, data):
        from capreolus_tpu_torch.parallel.distributed import make_mesh, shard_devices
        from capreolus_tpu_torch.parallel.sharded_search import ShardedDeviceIndex

        devices = shard_devices(self.shards, self.devices, "shards={shards} but only {have} devices present")
        self._sharded = (ShardedDeviceIndex(data, make_mesh({"shard": self.shards}, devices)), data)

    @property
    def _sindex(self):
        return self._sharded[0] if self._sharded is not None else None

    @property
    def _docids(self):
        if self._sharded is not None:
            return self._sharded[1].docid_strings
        return self.engine.dindex.host.docid_strings

    def refresh(self) -> bool:
        """NRT reopen: merge the index's pending incremental ops and, when the
        loaded generation moved, swap in an engine (or a sharded index) over
        it (one reference assignment: a search in flight keeps the engine it
        read). Returns True when the served generation changed."""
        from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

        if hasattr(self.index, "refresh"):
            self.index.refresh()
        data = self.index.data
        gen = getattr(self.index, "_loaded_generation", 0)
        if gen == self._generation:
            return False
        if self._sharded is not None:
            self._build_sharded(data)
        else:
            budget = self._hbm_budget_mb * 1e6 if self._hbm_budget_mb > 0 else None
            self.engine = ScoringEngine(DeviceIndex(data, device=self.device, hbm_budget=budget))
        self._generation = gen
        return True

    @classmethod
    def from_config(cls, collection: str = "dummy", collection_path: Optional[str] = None,
                    model: str = "bm25", params: Optional[dict] = None, shards: int = 0, device=None,
                    devices=None, **index_config):
        import capreolus_tpu_torch

        capreolus_tpu_torch.load_all_modules()
        from capreolus_tpu_torch.index import Index

        coll_cfg = {"name": collection}
        if collection_path:
            coll_cfg["path"] = collection_path
        index = Index.create("tpu", {**index_config, "collection": coll_cfg})
        return cls(index, model=model, params=params, shards=shards, device=device, devices=devices)

    def _analyze(self, query: str, vocab):
        counts = Counter(self.index.analyze(query))
        return [(vocab[t], float(c)) for t, c in counts.items() if t in vocab]

    def search_async(self, queries: Sequence[str], k: int = 10):
        """Dispatch-now / collect-later variant of ``search`` (identical results):
        the device work is queued when this returns (on the tiered path its
        result copy too), and the returned zero-arg callable fetches the
        results and builds the hit lists."""
        from capreolus_tpu_torch.searcher.tpu import fetch

        if self._sharded is not None:
            return self._search_async_sharded(queries, k)
        engine = self.engine
        host = engine.dindex.host
        docids = host.docid_strings
        pending = []
        for start in range(0, len(queries), self.batch_size):
            batch = queries[start : start + self.batch_size]
            with span("search.analyze"):
                term_lists = [self._analyze(q, host.vocab) for q in batch]
            with span("search.score"):
                if self.pruning and engine.supports_pruning(self.model):
                    res = engine.search_pruned(term_lists, model=self.model, params=self.params, topk=k,
                                               materialize=False)
                else:
                    res = engine.search(term_lists, model=self.model, params=self.params, topk=k,
                                        materialize=False)
            pending.append((len(batch), res))

        def collect() -> List[List[Tuple[str, float]]]:
            with span("search.fetch"):
                fetched = [(n, fetch(res)) for n, res in pending]
            return _hit_lists(((n, scores[0], ords[0]) for n, (scores, ords) in fetched), docids, _positive_prefix)

        return collect

    def _search_async_sharded(self, queries: Sequence[str], k: int):
        """Doc-sharded dispatch: every batch scored on each shard and merged
        on the first device (``sharded_search``, unmaterialised); collect
        copies the merged lists. Same collect-later contract as ``search_async``."""
        from capreolus_tpu_torch.parallel.sharded_search import sharded_search

        sindex, host = self._sharded  # one read: a refresh never mixes generations
        docids = host.docid_strings
        pending = []
        for start in range(0, len(queries), self.batch_size):
            batch = queries[start : start + self.batch_size]
            with span("search.analyze"):
                term_lists = [self._analyze(q, host.vocab) for q in batch]
            with span("search.score"):
                units = sindex.build_work_units(term_lists, model=self.model)
                scores, ords = sharded_search(sindex, units, num_queries=len(batch), topk=k, model=self.model,
                                              params=self.params, materialize=False)
            pending.append((len(batch), scores, ords))

        def collect() -> List[List[Tuple[str, float]]]:
            with span("search.fetch"):
                fetched = [(n, scores.cpu().numpy(), ords.cpu().numpy()) for n, scores, ords in pending]
            return _hit_lists(fetched, docids, _positive_prefix)

        return collect

    def search(self, queries: Sequence[str], k: int = 10) -> List[List[Tuple[str, float]]]:
        """Returns, per query, the top-k (docid, score) pairs."""
        return self.search_async(queries, k)()

    def get_document(self, docid: str) -> Optional[str]:
        return self.index.get_doc(docid)

    def snippets(self, query: str, hits) -> List[str]:
        """Query-biased snippets of a hit list (``analysis/highlight.py``):
        the index's analyzer matches terms, idf weighs the window."""
        from capreolus_tpu_torch.analysis.highlight import snippets_for_hits

        return snippets_for_hits(self.index, query, hits)


class RerankingService(RetrievalService):
    """Retrieve-then-rerank serving: first-stage engine + a trained reranker
    (KNRM or another model of the zoo over embedtext, slowembedtext,
    bagofwords or deeptiles features, or a BERT cross-encoder such as BERTMaxP
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

        Each collect sets ``last_stage_ms``, read from the stages' spans
        (``utils/tracing.py``): ``first_stage`` from dispatch until the
        first-stage hits are on the host (the two ``rerank.first_stage``
        spans and the caller's time between them), ``rerank`` from there
        until the reranked lists are built (``rerank.stage``; both stages end
        in a device-to-host copy, so each holds its own device work), and
        ``features``, the part of ``rerank`` the host spends building the
        reranker's input (the ``rerank.features`` spans)."""
        with TimedSpan("rerank.first_stage") as dispatched:
            first_collect = RetrievalService.search_async(self, queries, k=max(self.topn, k))

        def collect():
            with TimedSpan("rerank.first_stage") as fetched:
                first_stage = first_collect()
            with TimedSpan("rerank.stage") as rerank:
                results, features_s = self._rerank_stage(queries, first_stage, k)
            self.last_stage_ms = {"first_stage": (fetched.stop - dispatched.start) * 1e3,
                                  "rerank": rerank.seconds * 1e3, "features": features_s * 1e3}
            return results

        return collect

    def search(self, queries: Sequence[str], k: int = 10):
        return self.search_async(queries, k)()

    def rerank_batch(self, qid: str, query: str, docids: Sequence[str]) -> dict:
        """The reranker's collated input for one live query over ``docids``
        (numpy arrays; for a BERT reranker ``pos_bert_input``, ``pos_mask`` and
        ``pos_seg`` of shape [docs, numpassages, maxseqlen])."""
        extractor = self.reranker.extractor
        with span("features.query"):
            q_toks = extractor.tokenizer.tokenize(query)
            extractor.qid2toks[qid] = q_toks
            # live queries were never seen at preprocess time: fetch their idf
            # from the index now (idf-gated models read the query_idf feature)
            if hasattr(extractor, "idf") and extractor.config.get("calcidf", True):
                for tok in q_toks:
                    if tok not in extractor.idf:
                        extractor.idf[tok] = self.index.get_idf(tok)
        samples = []
        for docid in docids:
            with span("features.inputs"):
                samples.append(extractor.id2vec(qid, docid, label=[1, 0], training=False))
        with span("features.collate"):
            return self._collate(samples, self._keys)

    def _rerank_stage(self, queries: Sequence[str], first_stage, k: int):
        """Returns (the reranked lists, host seconds spent building features)."""
        results, features = [], TimedSpan("rerank.features")
        for qi, (query, hits) in enumerate(zip(queries, first_stage)):
            if not hits:
                results.append([])
                continue
            docids = [d for d, _ in hits]
            with features:
                batch = self.rerank_batch(f"live{qi}", query, docids)
            with matmul_f32():
                if self._calibrate_pending:
                    with span("rerank.calibrate"):
                        self.reranker.prepare_inference(batch, self.device)
                    self._calibrate_pending = False
                with span("rerank.model"), torch.inference_mode():
                    scores = self.reranker.test(batch, self.device).cpu().numpy()
            with span("rerank.sort"):
                reranked = sorted(zip(docids, map(float, scores)), key=lambda kv: -kv[1])
            results.append(reranked[:k])
        return results, features.seconds


class _EmbeddingRetrievalService:
    """Shared serving core of the embedding searchers (the JAX package's):
    dense MIPS and ColBERT late-interaction MaxSim.

    Wraps the searcher's ``build_topk`` engine and keeps it warm across
    calls: the corpus stays on the device and the query encoder stays loaded.
    The JAX service pads every query batch to ``batch`` rows to keep one
    compiled shape; the port does not pad (every row is independent, so the
    results are the same, and a one-query request costs one query's work).
    Subclasses provide the searcher's registry name and the query-embedding
    hook; result filtering (-inf and out-of-corpus slots) lives here. The
    served engine is one tuple (top-k function, corpus, corpus size, docids,
    max_k), read once per search and replaced in one assignment by
    ``refresh``.
    """

    _searcher_name: str = ""

    def __init__(self, searcher, max_k: int = 100, device=None):
        self.device = resolve_device(device)
        searcher.device = self.device
        self.searcher = searcher
        self._requested_k = int(max_k)  # refresh re-clamps against the new corpus
        self._served = self._build_engine()
        self.batch_size = int(searcher.config["batch"])
        self._prepare()

    def _build_engine(self):
        topk, corpus, n = self.searcher.build_topk(self._requested_k)
        corpus = corpus if isinstance(corpus, tuple) else (corpus,)  # ColBERT's tuple, dense's one corpus
        index = self.searcher.index
        self._generation = getattr(index, "_loaded_generation", 0)
        return topk, corpus, n, index.data.docid_strings, min(self._requested_k, n)

    # the served engine's parts, each read from the one tuple
    _topk = property(lambda self: self._served[0])
    _corpus = property(lambda self: self._served[1])
    _n = property(lambda self: self._served[2])
    _docids = property(lambda self: self._served[3])
    max_k = property(lambda self: self._served[4])

    def refresh(self) -> bool:
        """NRT reopen: merge the index's pending incremental ops; on a new
        generation the searcher rebuilds its embedding cache incrementally
        (surviving docs' rows copied, only added docs encoded) and the
        service swaps in an engine over it at the requested ``max_k``, in one
        assignment. Returns True when the served generation changed."""
        index = self.searcher.index
        if hasattr(index, "refresh"):
            index.refresh()
        _ = index.data
        if getattr(index, "_loaded_generation", 0) == self._generation:
            return False
        self._served = self._build_engine()
        return True

    def snippets(self, query: str, hits) -> List[str]:
        from capreolus_tpu_torch.analysis.highlight import snippets_for_hits

        return snippets_for_hits(self.searcher.index, query, hits)

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
        topk, corpus, n, docids, max_k = self._served  # one read: a refresh never mixes two engines
        k = min(int(k), max_k)
        pending = []
        for start in range(0, len(queries), self.batch_size):
            chunk = list(queries[start : start + self.batch_size])
            q_emb = self._embed_batch(chunk)
            with span("search.score"):
                scores, ords = topk(q_emb, *corpus)
            pending.append((len(chunk), scores, ords))

        def collect() -> List[List[Tuple[str, float]]]:
            with span("search.fetch"):
                fetched = [(cn, scores.cpu().numpy()[:, :k], ords.cpu().numpy()[:, :k])
                           for cn, scores, ords in pending]
            # -inf slots (fewer valid docs than k) never surface
            return _hit_lists(fetched, docids, lambda scores, ords: (ords < n) & np.isfinite(scores))

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
        with span("search.tokenize"):
            toks = self.searcher._tokenize(chunk, self.maxqlen)
        with span("search.encode"):
            return self.searcher.encode_queries(toks)


class DenseRetrievalService(_EmbeddingRetrievalService):
    """Low-latency dense (bi-encoder MIPS) serving over ``searcher/dense.py``'s
    engines: the query encoder through K2, then the bf16 product, X1 over an
    int8 / int4 corpus (int4 with its host rescore), IVF or the host stream,
    with ``prf`` applied per request as in the batch pipeline.

        svc = DenseRetrievalService.from_config(collection="dummy", pretrained="tiny")
        hits = svc.search(["distant galaxies"], k=10)              # on "cuda"
    """

    _searcher_name = "dense"

    def _prepare(self):
        self.searcher._encoder()

    def _embed_batch(self, chunk):
        with span("search.encode"):  # the query's tokenization too
            q_emb = self.searcher.embed_queries(chunk)
        if int(self.searcher.config["prf"]) > 0:
            with span("search.prf"):
                q_emb = self.searcher._prf_expand(q_emb, self._topk, *self._corpus)
        return q_emb


class ImpactRetrievalService:
    """Low-latency learned-sparse (uniCOIL / SPLADE impact) serving over
    ``searcher/impact.py``: the quantized impact index on the sparse engine,
    the query-weighting encoder (K2) warm across calls. Scores are the true
    quantized-impact dot products (dequantization folded into the query
    weights); each hit list ends at its first score <= 0.

        svc = ImpactRetrievalService.from_config(collection="dummy", checkpointfile=".../dev.best.params")
        hits = svc.search(["distant galaxies"], k=10)              # on "cuda"
    """

    def __init__(self, searcher, *, device=None):
        self.device = resolve_device(device)
        searcher.device = self.device
        self.searcher = searcher
        self.batch_size = max(1, int(searcher.config["batch"]))
        # the (engine, docids, scale) tuple, read once: the hot path never re-derives it
        self._snapshot = searcher._impact_index()
        self._served_gen = getattr(searcher, "_engine_gen", 0)

    @property
    def index(self):
        return self.searcher.index

    @property
    def _docids(self):
        return self._snapshot[1]

    def refresh(self) -> bool:
        """NRT reopen: merge the index's pending incremental ops; on a new
        generation the searcher re-derives the quantized CSR from the
        incrementally maintained raw cache (only added docs encoded),
        re-quantized over the new corpus as a fresh build would be, and the
        snapshot tuple is swapped in one assignment. Returns True when the
        served generation changed."""
        index = self.searcher.index
        if hasattr(index, "refresh"):
            index.refresh()
        self._snapshot = self.searcher._impact_index()
        gen = getattr(self.searcher, "_engine_gen", 0)
        changed = gen != self._served_gen
        self._served_gen = gen
        return changed

    def snippets(self, query: str, hits) -> List[str]:
        from capreolus_tpu_torch.analysis.highlight import snippets_for_hits

        return snippets_for_hits(self.searcher.index, query, hits)

    @classmethod
    def from_config(cls, collection: str = "dummy", collection_path: Optional[str] = None, device=None,
                    **searcher_config):
        import capreolus_tpu_torch

        capreolus_tpu_torch.load_all_modules()
        from capreolus_tpu_torch.searcher import Searcher

        coll_cfg = {"name": collection}
        if collection_path:
            coll_cfg["path"] = collection_path
        index_cfg = searcher_config.pop("index", {})
        searcher = Searcher.create("impact", {**searcher_config, "index": {**index_cfg, "collection": coll_cfg}})
        return cls(searcher, device=device)

    def search_async(self, queries: Sequence[str], k: int = 10):
        """Dispatch-now / collect-later variant of ``search`` (identical
        results): the engine's device work is queued when this returns."""
        from capreolus_tpu_torch.searcher.tpu import fetch

        engine, docids, scale = self._snapshot
        maxpost = int(self.searcher.config["maxpostings"])
        pending = []
        for start in range(0, len(queries), self.batch_size):
            batch = list(queries[start : start + self.batch_size])
            with span("search.encode"):
                weights = self.searcher.query_weights_batch(batch)
            with span("search.analyze"):
                term_lists = self.searcher.term_lists(engine, scale, weights)
            with span("search.score"):
                res = engine.search(term_lists, model="impact", params={}, topk=k,
                                    max_postings_per_term=maxpost, materialize=False)
            pending.append((len(batch), res))

        def collect() -> List[List[Tuple[str, float]]]:
            with span("search.fetch"):
                fetched = [(n, fetch(res)) for n, res in pending]
            return _hit_lists(((n, scores[0], ords[0]) for n, (scores, ords) in fetched), docids,
                              lambda scores, ords: _positive_prefix(scores, ords) & (ords < len(docids)))

        return collect

    def search(self, queries: Sequence[str], k: int = 10) -> List[List[Tuple[str, float]]]:
        """Returns, per query, the top-k (docid, score) pairs."""
        return self.search_async(queries, k)()

    def get_document(self, docid: str) -> Optional[str]:
        return self.searcher.index.get_doc(docid)


class HybridRetrievalService:
    """Serving-level hybrid retrieval: two warm services' hit lists fused per
    query, ``rrf`` (reciprocal rank fusion, the default) or ``interp``
    (``searcher/fusion.py``'s math over live hit lists). Any two services with
    the ``search(queries, k)`` contract compose (a leg without
    ``search_async`` is searched at dispatch); an embedding service's
    ``max_k`` clamps ``depth`` for BOTH legs, so that fusion sees equal-depth
    lists."""

    def __init__(self, service1, service2, method: str = "rrf", k_rrf: int = 60,
                 alpha: float = 0.5, depth: int = 100):
        if method not in ("rrf", "interp"):
            raise ConfigError(f"hybrid method must be 'rrf' or 'interp', got {method!r}")
        self.services = (service1, service2)
        self.method = method
        self.k_rrf = int(k_rrf)
        self.alpha = float(alpha)
        self._depth_limit = min((int(svc.max_k) for svc in self.services if hasattr(svc, "max_k")), default=None)
        self.depth = int(depth)
        if self._depth_limit is not None and self.depth > self._depth_limit:
            logger.warning("hybrid depth %d exceeds an embedding service's max_k=%d; clamping BOTH legs "
                           "to %d (build the service with max_k>=%d for deeper fusion)",
                           self.depth, self._depth_limit, self._depth_limit, self.depth)
            self.depth = self._depth_limit
        self.batch_size = min(getattr(service1, "batch_size", 64), getattr(service2, "batch_size", 64))
        self._docids = getattr(service1, "_docids", [])  # the HTTP front end's /health corpus_size

    def search_async(self, queries: Sequence[str], k: int = 10):
        """Dispatch-now / collect-later variant of ``search`` (identical
        results): both legs are dispatched before either is collected; a leg
        without ``search_async`` is searched here."""
        depth = max(self.depth, k)
        if self._depth_limit is not None:
            depth = min(depth, self._depth_limit)
        collectors = []
        for svc in self.services:
            dispatch = getattr(svc, "search_async", None)
            if callable(dispatch):
                collectors.append(dispatch(queries, k=depth))
            else:
                hits = svc.search(queries, k=depth)
                collectors.append(lambda h=hits: h)

        def collect() -> List[List[Tuple[str, float]]]:
            from capreolus_tpu_torch.searcher.fusion import interp_fuse, rrf_fuse

            runs = [{str(i): dict(h) for i, h in enumerate(c())} for c in collectors]
            if self.method == "rrf":
                fused = rrf_fuse(runs, k=self.k_rrf, hits=k)
            else:
                fused = interp_fuse(runs[0], runs[1], alpha=self.alpha, hits=k)
            return [sorted(fused.get(str(i), {}).items(), key=lambda kv: (-kv[1], kv[0]))
                    for i in range(len(queries))]

        return collect

    def search(self, queries: Sequence[str], k: int = 10) -> List[List[Tuple[str, float]]]:
        return self.search_async(queries, k)()

    def get_document(self, docid: str) -> Optional[str]:
        return self.services[0].get_document(docid)

    def snippets(self, query: str, hits) -> List[str]:
        return self.services[0].snippets(query, hits)
