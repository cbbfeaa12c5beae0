"""ColBERT late-interaction retrieval through the port's
``ColbertRetrievalService``: the query encoder (BERT-base and a 768 -> dim
projection) and exact MaxSim over a resident corpus (K3 over bf16, or X1
over int8 with ``quantize``), then the top ``hits``.

The corpus is no text: its token embeddings are made on the device from the
seed (``lib/tokens.py``: unit vectors around seeded centres, doc lengths
from a lognormal of MS MARCO's mean passage length), rounded to f16 as the
searcher's disk cache holds them, and handed a token position at a time to
the searcher's own upload (``_upload``, or ``_upload_quantized`` over the
whole array), which puts them in the layout its engine reads; no document
is encoded and no cache file is written."""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch

from lib import corpus as corpus_lib
from lib import work
from lib.tokens import TokenCorpus, docid
from systems.maxp_rerank import load_seeded, sync, timer_parts


class SyntheticIndex:
    """The index of a corpus that exists only as token embeddings: its docids."""

    def __init__(self, n):
        self.data = SimpleNamespace(docid_strings=[docid(i) for i in range(n)])

    def create_index(self):
        pass


class System:
    def __init__(self, config, mix, seed, device, tmpdir, scale=None):
        import capreolus_tpu_torch
        from capreolus_tpu_torch.core import constants
        from capreolus_tpu_torch.searcher import Searcher
        from capreolus_tpu_torch.serving import ColbertRetrievalService

        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self.model = dict(config["model"], **(scale or {}).get("model", {}))
        spec = dict(config["corpus"], **(scale or {}).get("corpus", {}))
        s = config["searcher"]
        self.setup_parts = {}
        capreolus_tpu_torch.load_all_modules()
        constants["CACHE_BASE_PATH"] = os.path.join(tmpdir, "cache")
        with timer_parts(self.setup_parts, "encoder"):
            searcher = Searcher.create("colbert", {
                "pretrained": (scale or {}).get("pretrained", config["pretrained"]), "allowrandominit": True,
                "dim": self.model["dim"], "maxqlen": s["maxqlen"], "maxdoclen": s["maxdoclen"], "batch": s["batch"],
                "hits": s["hits"], "quantize": config["quantize"], "index": {"collection": {"name": "dummy"}}})
            searcher.device = self.device
            searcher.index = SyntheticIndex(spec["docs"])
            encoder = searcher._encoder()
        with timer_parts(self.setup_parts, "weights"):
            load_seeded(encoder, self.model, "colbert", seed, self.device)
            sync(self.device)
        with timer_parts(self.setup_parts, "corpus"):
            emb = TokenCorpus(spec, self.model["dim"], s["maxdoclen"], seed, self.device)
            mask = emb.mask
        with timer_parts(self.setup_parts, "upload"):
            if config["quantize"] in (None, "none"):
                corpus = searcher._upload(emb, mask)
            else:
                corpus = searcher._upload_quantized(emb, mask, config["quantize"])
            searcher._docs_emb, searcher._docs_emb_gen = corpus, 0
            self.svc = ColbertRetrievalService(searcher, max_k=s["hits"], device=self.device)
            sync(self.device)
        self.valid_tokens = emb.valid_tokens
        self.n_docs, self.ld = emb.shape[0], emb.shape[1]
        del mask
        with timer_parts(self.setup_parts, "queries"):
            self.pool = corpus_lib.query_pool(mix["queries"], seed)
        self.k = mix["k"]
        self.inputs = {"corpus": (spec, self.model["dim"], s["maxdoclen"]), "model": self.model, "seed": seed}
        self._queries = None

    def payloads(self):
        texts = corpus_lib.cycle(self.pool, self.seed, "requests")
        n = self.mix["queries_per_request"]
        while True:
            yield [next(texts) for _ in range(n)]

    def warm(self):
        """Three warm-up requests of the cell's own shapes, drawn in another order."""
        texts = corpus_lib.cycle(self.pool, self.seed, "warm")
        n = self.mix["queries_per_request"]
        with timer_parts(self.setup_parts, "warm"):
            for _ in range(3):
                self.svc.search([next(texts) for _ in range(n)], k=self.k)
            sync(self.device)

    def dispatch(self, payload):
        collect = self.svc.search_async(payload, k=self.k)
        return lambda: {"hits": collect()}

    def trace_on(self):
        """Nothing to record: every request's work follows from its size."""

    def trace_off(self):
        pass

    def ops(self, records):
        """Per request in the traced window: the query encoder over [Q, maxqlen]
        (every position attended), the projection and MaxSim over the corpus."""
        out = []
        m, s = self.model, self.config["searcher"]
        qmode = self.config["quantize"] or "none"
        for r in records:
            if not r["answers"]:
                continue
            q = len(r["payload"])
            out += work.bert_encoder_ops(m, q, s["maxqlen"], "none")
            out.append({"kind": "gemm", "m": q * s["maxqlen"], "k": m["hidden_size"], "n": m["dim"], "dtype": "f32",
                        "epilogue": "none"})
            out.append({"kind": "maxsim", "nq": q, "lq": s["maxqlen"], "dim": m["dim"], "tokens": self.valid_tokens,
                        "docs": self.n_docs, "ld": self.ld, "dtype": "bf16" if qmode == "none" else "int8"})
            if qmode == "int8":  # the int8 engine's product as it calls it: every doc token, int32 out
                out.append({"kind": "gemm", "m": q * s["maxqlen"], "k": m["dim"], "n": self.n_docs * self.ld,
                            "dtype": "int8", "epilogue": "int32", "mfu": False})
        return out

    def spans(self, records):
        return []

    def items(self, record):
        return len(record["answers"]["hits"]) if record["answers"] else 0

    def free(self):
        del self.svc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
