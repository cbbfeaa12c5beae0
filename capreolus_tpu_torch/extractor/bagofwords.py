"""BagOfWords extractor: unigram or letter-trigram count vectors, DSSM's
input (the JAX package's ``extractor/bagofwords.py``).

``preprocess`` tokenizes the queries and documents and builds the feature
vocabulary (``stoi``, sorted); ``feature_dim`` is the width of every vector,
``max(1, len(stoi))``, which sizes DSSM's first layer.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.extractor import Extractor
from capreolus_tpu_torch.utils.exceptions import MissingDocError
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def letter_trigrams(token: str):
    padded = f"#{token}#"
    return [padded[i : i + 3] for i in range(len(padded) - 2)]


@Extractor.register
class BagOfWords(Extractor):
    module_name = "bagofwords"
    requires_random_seed = True
    dependencies = [
        Dependency(key="index", module="index", name="tpu",
                   default_config_overrides={"indexstops": True, "stemmer": "none"}),
        Dependency(key="tokenizer", module="tokenizer", name="lucene"),
    ]
    config_spec = [
        ConfigOption("datamode", "unigram", "unigram or trigram features"),
        ConfigOption("maxqlen", 4, "maximum query length"),
        ConfigOption("maxdoclen", 800, "maximum doc length"),
        ConfigOption("usecache", False, "cache extracted features"),
    ]
    config_keys_not_in_path = ["usecache"]

    def build(self):
        self.qid2toks = {}
        self.docid2toks = {}
        self.stoi = {}
        self._preprocessed = False

    def get_state(self):
        return {"qid2toks": self.qid2toks, "docid2toks": self.docid2toks, "stoi": self.stoi}

    def set_state(self, state):
        self.qid2toks, self.docid2toks, self.stoi = state["qid2toks"], state["docid2toks"], state["stoi"]
        self._preprocessed = True

    def _features(self, toks):
        if self.config["datamode"] == "trigram":
            return [t for tok in toks for t in letter_trigrams(tok)]
        return list(toks)

    @property
    def feature_dim(self):
        """The width of every vector ``id2vec`` gives (one slot when the vocabulary is empty)."""
        return max(1, len(self.stoi))

    def preprocess(self, qids, docids, topics):
        if self._preprocessed:
            return
        self.index.create_index()
        if self.config["usecache"] and self._load_state_from_cache(qids, docids):
            return
        for qid in qids:
            self.qid2toks[qid] = self.tokenizer.tokenize(topics[qid])
        for docid in docids:
            doc = self.index.get_doc(docid)
            self.docid2toks[docid] = self.tokenizer.tokenize(doc) if doc else []
        vocab = sorted({f for toks in self.qid2toks.values() for f in self._features(toks)}
                       | {f for toks in self.docid2toks.values() for f in self._features(toks)})
        self.stoi = {f: i for i, f in enumerate(vocab)}
        self._preprocessed = True
        if self.config["usecache"]:
            self._cache_state(qids, docids)

    def _vectorize(self, toks):
        vec = np.zeros(self.feature_dim, dtype=np.float32)
        for feat, count in Counter(self._features(toks)).items():
            idx = self.stoi.get(feat)
            if idx is not None:
                vec[idx] += count
        return vec

    def id2vec(self, qid, posid, negid=None, label=None, training=True):
        if not self._preprocessed:
            raise RuntimeError("call preprocess() first")
        posdoc = self.docid2toks.get(posid)
        if not posdoc:
            raise MissingDocError(qid, posid)
        data = {
            "qid": qid,
            "posdocid": posid,
            "query": self._vectorize(self.qid2toks[qid]),
            "posdoc": self._vectorize(posdoc),
            "negdocid": "",
            "negdoc": np.zeros(self.feature_dim, dtype=np.float32),
            "query_idf": np.zeros(self.config["maxqlen"], dtype=np.float32),
            "label": np.array(label if label is not None else [1, 0], dtype=np.float32),
        }
        if negid:
            negdoc = self.docid2toks.get(negid)
            if not negdoc:
                raise MissingDocError(qid, negid)
            data["negdocid"] = negid
            data["negdoc"] = self._vectorize(negdoc)
        return data
