"""BertText extractor (the JAX package's ``extractor/berttext.py``): separate
WordPiece id arrays for the query and the whole document, the legacy BERT
input format before the passage extractors. With ``specialtokens`` each is
wrapped as ``[CLS] ... [SEP]``, the layout the ColBERT reranker trains on and
the late-interaction searcher serves.
"""

from __future__ import annotations

import numpy as np

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.extractor import Extractor
from capreolus_tpu_torch.utils.common import padlist
from capreolus_tpu_torch.utils.exceptions import MissingDocError


@Extractor.register
class BertText(Extractor):
    module_name = "berttext"
    requires_random_seed = True
    dependencies = [
        Dependency(key="index", module="index", name="tpu",
                   default_config_overrides={"indexstops": True, "stemmer": "none"}),
        Dependency(key="tokenizer", module="tokenizer", name="berttokenizer"),
    ]
    config_spec = [
        ConfigOption("maxqlen", 4, "maximum query length"),
        ConfigOption("maxdoclen", 800, "maximum doc length"),
        ConfigOption("specialtokens", False, "wrap sequences as [CLS] ... [SEP] (the bi-encoder trains with "
                     "the same layout the dense searcher serves)"),
        ConfigOption("usecache", False, "cache extracted features"),
    ]
    config_keys_not_in_path = ["usecache"]

    def build(self):
        self.qid2toks = {}
        self.docid2toks = {}
        self._preprocessed = False

    def get_state(self):
        return {"qid2toks": self.qid2toks, "docid2toks": self.docid2toks}

    def set_state(self, state):
        self.qid2toks = state["qid2toks"]
        self.docid2toks = state["docid2toks"]
        self._preprocessed = True

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
        self._preprocessed = True
        if self.config["usecache"]:
            self._cache_state(qids, docids)

    def _to_ids(self, toks, maxlen):
        if self.config["specialtokens"]:
            ids = ([self.tokenizer.cls_id]
                   + self.tokenizer.convert_tokens_to_ids(toks[: maxlen - 2])
                   + [self.tokenizer.sep_id])
        else:
            ids = self.tokenizer.convert_tokens_to_ids(toks[:maxlen])
        return np.array(padlist(ids, maxlen, self.tokenizer.pad_id), dtype=np.int64)

    def id2vec(self, qid, posid, negid=None, label=None, training=True):
        """One sample: ``query`` and ``posdoc`` ids, zero ``query_idf``, a
        ``negdoc`` (zeros without ``negid``) and ``label``."""
        if not self._preprocessed:
            raise RuntimeError("berttext.id2vec before preprocess")
        posdoc = self.docid2toks.get(posid)
        if not posdoc:
            raise MissingDocError(qid, posid)
        data = {
            "qid": qid,
            "posdocid": posid,
            "query": self._to_ids(self.qid2toks[qid], self.config["maxqlen"]),
            "posdoc": self._to_ids(posdoc, self.config["maxdoclen"]),
            "query_idf": np.zeros(self.config["maxqlen"], dtype=np.float32),
            "negdocid": "",
            "negdoc": np.zeros(self.config["maxdoclen"], dtype=np.int64),
            "label": np.array(label if label is not None else [1, 0], dtype=np.float32),
        }
        if negid:
            negdoc = self.docid2toks.get(negid)
            if not negdoc:
                raise MissingDocError(qid, negid)
            data["negdocid"] = negid
            data["negdoc"] = self._to_ids(negdoc, self.config["maxdoclen"])
        return data
