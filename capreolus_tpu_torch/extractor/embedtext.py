"""EmbedText extractor: padded token-id arrays + per-term idf for interaction
models (the JAX package's ``extractor/embedtext.py``).

OOV convention: index 0 is padding, in-embedding terms get positive ids (rows of
the embedding matrix), out-of-embedding terms get *negative* ids so models can
compute an exact-match channel for them. ``preprocess`` tokenizes every
candidate document up front and builds a vocabulary restricted to observed
terms, so ``id2vec`` is a lookup.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.extractor import Extractor
from capreolus_tpu_torch.extractor.embeddings import build_embedding_matrix
from capreolus_tpu_torch.utils.common import padlist
from capreolus_tpu_torch.utils.exceptions import MissingDocError
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Extractor.register
class EmbedText(Extractor):
    module_name = "embedtext"
    requires_random_seed = True
    dependencies = [
        Dependency(key="index", module="index", name="tpu",
                   default_config_overrides={"indexstops": True, "stemmer": "none"}),
        Dependency(key="tokenizer", module="tokenizer", name="lucene"),
    ]
    config_spec = [
        ConfigOption("embeddings", "glove6b", "embeddings: glove6b, glove6b.50d, w2vnews, fasttext "
                     "(read from the embeddings cache), or random, random8, random300"),
        ConfigOption("calcidf", True, "compute idf for query terms from the index"),
        ConfigOption("maxqlen", 4, "maximum query length"),
        ConfigOption("maxdoclen", 800, "maximum doc length"),
    ]

    def build(self):
        self.qid2toks = {}
        self.docid2toks = {}
        self.stoi = {}
        self.idf = {}
        self.embeddings = None
        self._preprocessed = False

    # ------------------------------------------------------------------ state cache
    def get_state(self):
        return {
            "qid2toks": self.qid2toks,
            "docid2toks": self.docid2toks,
            "stoi": self.stoi,
            "idf": self.idf,
            "embeddings": self.embeddings,
        }

    def set_state(self, state):
        self.qid2toks = state["qid2toks"]
        self.docid2toks = state["docid2toks"]
        self.stoi = state["stoi"]
        self.idf = state["idf"]
        self.embeddings = state["embeddings"]
        self._preprocessed = True

    # ------------------------------------------------------------------ preprocess
    def preprocess(self, qids, docids, topics):
        if self._load_state_from_cache(qids, docids):
            return
        self.index.create_index()

        for qid in qids:
            if qid not in self.qid2toks:
                self.qid2toks[qid] = self.tokenizer.tokenize(topics[qid])
        for docid in docids:
            if docid not in self.docid2toks:
                doc = self.index.get_doc(docid)
                self.docid2toks[docid] = self.tokenizer.tokenize(doc) if doc else []

        # vocabulary over observed terms; embedding rows for pretrained hits,
        # negative ids for the rest (exact-match channel)
        all_terms = sorted({t for toks in self.qid2toks.values() for t in toks}
                           | {t for toks in self.docid2toks.values() for t in toks})
        self.embeddings, self.stoi = build_embedding_matrix(self.config["embeddings"], all_terms)

        if self.config["calcidf"]:
            query_terms = {t for toks in self.qid2toks.values() for t in toks}
            self.idf = {t: self.index.get_idf(t) for t in query_terms}

        qlens = Counter(len(t) for t in self.qid2toks.values())
        if qlens and max(qlens) > self.config["maxqlen"]:
            logger.warning("some queries longer than maxqlen=%d (longest %d)", self.config["maxqlen"], max(qlens))
        self._preprocessed = True
        self._cache_state(qids, docids)

    def _tok2vec(self, toks):
        return [self.stoi.get(tok, 0) if tok != self.pad_tok else 0 for tok in toks]

    def _get_idf(self, toks):
        return [self.idf.get(tok, 0.0) for tok in toks]

    def get_doc_tokens(self, docid):
        if docid not in self.docid2toks:
            doc = self.index.get_doc(docid)
            self.docid2toks[docid] = self.tokenizer.tokenize(doc) if doc else []
        return self.docid2toks[docid]

    # ------------------------------------------------------------------ id2vec
    def id2vec(self, qid, posid, negid=None, label=None, training=True):
        if not self._preprocessed:
            raise RuntimeError("call preprocess() first")
        query = self.qid2toks[qid]
        qlen, doclen = self.config["maxqlen"], self.config["maxdoclen"]

        posdoc = self.get_doc_tokens(posid)
        if not posdoc:
            raise MissingDocError(qid, posid)

        idfs = padlist(self._get_idf(query), qlen, 0.0)
        query_ids = self._tok2vec(padlist(query, qlen, self.pad_tok))
        posdoc_ids = self._tok2vec(padlist(posdoc, doclen, self.pad_tok))

        data = {
            "qid": qid,
            "posdocid": posid,
            "idfs": np.array(idfs, dtype=np.float32),
            "query": np.array(query_ids, dtype=np.int64),
            "posdoc": np.array(posdoc_ids, dtype=np.int64),
            "query_idf": np.array(idfs, dtype=np.float32),
            "negdocid": "",
            "negdoc": np.zeros(doclen, dtype=np.int64),
            "label": np.array(label if label is not None else [1, 0], dtype=np.float32),
        }
        if negid:
            negdoc = self.get_doc_tokens(negid)
            if not negdoc:
                raise MissingDocError(qid, negid)
            data["negdocid"] = negid
            data["negdoc"] = np.array(self._tok2vec(padlist(negdoc, doclen, self.pad_tok)), dtype=np.int64)
        return data
