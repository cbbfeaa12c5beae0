"""BertPassage extractor: passage decomposition for BERT cross-encoders (the
JAX package's ``extractor/bertpassage.py``).

Sliding-window passages (``passagelen`` / ``stride``) or sentence passages
(``sentences=True``: punkt sentences, each cut into whole chunks of
``passagelen`` tokens), ``numpassages`` per doc, ``[CLS] query [SEP] passage
[SEP]`` inputs with mask and segment ids. Training samples one random valid
passage per doc (a draw of the extractor's own seeded ``rng``, as in JAX),
while inference keeps all passages (shape [numpassages, maxseqlen]); a list of
negatives (``sampler.name=LCE``) stacks them on a leading axis.
``pooledbertpassage`` (PARADE, CEDR-KNRM) and ``birchbertpassage`` (Birch,
with a bert-large tokenizer by default) keep every passage in training too.

The JAX extractor creates a punkt tokenizer for every document it splits into
sentences; this one creates it once, at its first sentence split. The
tokenizer holds no state between calls, so the passages are the same.
"""

from __future__ import annotations

import numpy as np

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.extractor import Extractor
from capreolus_tpu_torch.utils.common import padlist
from capreolus_tpu_torch.utils.exceptions import MissingDocError
from capreolus_tpu_torch.utils.tracing import span

PASSAGE_CACHE_DOCS = 200000  # docs whose passages stay tokenized in memory


@Extractor.register
class BertPassage(Extractor):
    module_name = "bertpassage"
    requires_random_seed = True
    dependencies = [
        Dependency(key="index", module="index", name="tpu",
                   default_config_overrides={"indexstops": True, "stemmer": "none"}),
        Dependency(key="tokenizer", module="tokenizer", name="berttokenizer"),
    ]
    config_spec = [
        ConfigOption("maxseqlen", 256, "maximum input length (query+passage)"),
        ConfigOption("maxqlen", 20, "maximum query length"),
        ConfigOption("padq", False, "always pad queries to maxqlen"),
        ConfigOption("usecache", False, "cache extracted features"),
        ConfigOption("passagelen", 150, "length of each passage"),
        ConfigOption("stride", 100, "sliding window stride"),
        ConfigOption("sentences", False, "use sentence segmentation to form passages"),
        ConfigOption("numpassages", 16, "number of passages per document"),
        ConfigOption("prob", 0.1, "probability of using a non-first passage for training"),
    ]
    config_keys_not_in_path = ["usecache"]

    #: at training time, emit a single randomly-chosen passage (bertpassage) or
    #: all passages together (the pooled and Birch extractors)
    single_training_passage = True

    def build(self):
        tok = self.tokenizer
        self.pad_tok = tok.pad_token
        self.cls_tok = tok.cls_token
        self.sep_tok = tok.sep_token
        self.qid2toks = {}
        self._doc_passage_cache = {}
        self._punkt = None

    # ------------------------------------------------------------------ state
    def get_state(self):
        return {"qid2toks": self.qid2toks}

    def set_state(self, state):
        self.qid2toks = state["qid2toks"]

    def exist(self):
        return bool(self.qid2toks)

    def preprocess(self, qids, docids, topics):
        if self.exist():
            return
        self.index.create_index()
        if self.config["usecache"] and self._load_state_from_cache(qids, docids):
            return
        self.qid2toks = {qid: self.tokenizer.tokenize(topics[qid]) for qid in qids}
        if self.config["usecache"]:
            self._cache_state(qids, docids)

    # ------------------------------------------------------------------ passages
    def _get_passages(self, docid):
        if docid in self._doc_passage_cache:
            return self._doc_passage_cache[docid]
        with span("features.doc_tokens"):  # a passage-cache miss: the doc read and tokenized
            doc = self.index.get_doc(docid)
            if doc is None:
                raise MissingDocError("?", docid)
            if self.config["sentences"]:
                passages = self._get_sent_passages(doc)
            else:
                passages = self._get_sliding_window_passages(doc)
        if len(self._doc_passage_cache) < PASSAGE_CACHE_DOCS:
            self._doc_passage_cache[docid] = passages
        return passages

    def _get_sliding_window_passages(self, doc):
        numpassages = self.config["numpassages"]
        toks = self.tokenizer.tokenize(doc)
        passages = []
        for i in range(0, max(1, len(toks)), self.config["stride"]):
            if i >= len(toks) and passages:
                break
            passages.append(toks[i : i + self.config["passagelen"]] or [self.pad_tok])
        if len(passages) > numpassages:
            passages = passages[:numpassages]
        else:
            passages.extend([[self.pad_tok] for _ in range(numpassages - len(passages))])
        return passages

    def _get_sent_passages(self, doc):
        if self._punkt is None:
            from capreolus_tpu_torch.tokenizer import PunktTokenizer

            self._punkt = PunktTokenizer.create("punkt")
        numpassages = self.config["numpassages"]
        passages = []
        for sentence in self._punkt.tokenize(doc):
            if len(passages) >= numpassages:
                break
            passages.extend(self._chunk_sent(sentence, self.config["passagelen"]))
        passages = passages[:numpassages]
        passages.extend([[self.pad_tok] for _ in range(numpassages - len(passages))])
        return passages

    def _chunk_sent(self, sent, max_len):
        """A sentence's tokens as one passage, or, when longer than
        ``max_len``, its whole ``max_len``-token chunks: the tail that does
        not fill a chunk is dropped, as in the reference."""
        words = self.tokenizer.tokenize(sent)
        if len(words) <= max_len:
            return [words]
        return [words[i * max_len : (i + 1) * max_len] for i in range(len(words) // max_len)]

    # ------------------------------------------------------------------ encoding
    def _prepare_bert_input(self, query_toks, psg_toks):
        maxseqlen, maxqlen = self.config["maxseqlen"], self.config["maxqlen"]
        if len(query_toks) > maxqlen:
            query_toks = query_toks[:maxqlen]
        elif self.config["padq"]:
            query_toks = padlist(query_toks, maxqlen, self.pad_tok)
        psg_toks = list(psg_toks)[: maxseqlen - len(query_toks) - 3]

        input_line = [self.cls_tok] + list(query_toks) + [self.sep_tok] + psg_toks + [self.sep_tok]
        padded = padlist(input_line, maxseqlen, self.pad_tok)
        inp = self.tokenizer.convert_tokens_to_ids(padded)
        mask = [1 if t != self.pad_tok else 0 for t in input_line] + [0] * (maxseqlen - len(input_line))
        seg = [0] * (len(query_toks) + 2) + [1] * (maxseqlen - len(query_toks) - 2)
        return inp, mask, seg

    def _encode_inputs(self, query_toks, passages):
        inputs, masks, segs = [], [], []
        n_valid = 0
        for psg in passages:
            if psg != [self.pad_tok]:
                n_valid += 1
            inp, mask, seg = self._prepare_bert_input(query_toks, psg)
            inputs.append(inp)
            masks.append(mask)
            segs.append(seg)
        return inputs, masks, segs, n_valid

    def _filter_inputs(self, inputs, masks, segs, n_valid):
        """Keep one random valid passage (training)."""
        valid = list(range(max(1, n_valid)))
        i = int(self.rng.choice(valid))
        return inputs[i], masks[i], segs[i]

    def _encode_doc(self, query_toks, docid, training):
        passages = self._get_passages(docid)
        inputs, masks, segs, n_valid = self._encode_inputs(query_toks, passages)
        if training and self.single_training_passage:
            inputs, masks, segs = self._filter_inputs(inputs, masks, segs, n_valid)
        return (np.array(inputs, dtype=np.int64), np.array(masks, dtype=np.int64),
                np.array(segs, dtype=np.int64))

    # ------------------------------------------------------------------ id2vec
    def id2vec(self, qid, posid, negid=None, label=None, training=True):
        if training and label is None:
            raise ValueError("label is required for training")
        query_toks = self.qid2toks[qid]

        pos_inp, pos_mask, pos_seg = self._encode_doc(query_toks, posid, training)
        data = {
            "qid": qid,
            "posdocid": posid,
            "pos_bert_input": pos_inp,
            "pos_mask": pos_mask,
            "pos_seg": pos_seg,
            "negdocid": "",
            "neg_bert_input": np.zeros_like(pos_inp),
            "neg_mask": np.zeros_like(pos_mask),
            "neg_seg": np.zeros_like(pos_seg),
            "label": np.array(label if label is not None else [1, 0], dtype=np.float32),
        }
        if not negid:
            return data
        if isinstance(negid, (list, tuple, np.ndarray)):
            # LCE-style multiple negatives -> an extra leading axis
            negs = [self._encode_doc(query_toks, n, training) for n in negid]
            data["negdocid"] = list(negid)
            data["neg_bert_input"] = np.stack([n[0] for n in negs])
            data["neg_mask"] = np.stack([n[1] for n in negs])
            data["neg_seg"] = np.stack([n[2] for n in negs])
            return data
        data["negdocid"] = negid
        data["neg_bert_input"], data["neg_mask"], data["neg_seg"] = self._encode_doc(query_toks, negid, training)
        return data


@Extractor.register
class PooledBertPassage(BertPassage):
    """bertpassage whose training features keep every passage, [numpassages,
    maxseqlen] (PARADE and CEDR-KNRM aggregate over all of a doc's passages)."""

    module_name = "pooledbertpassage"
    single_training_passage = False


@Extractor.register
class BirchBertPassage(BertPassage):
    """Every passage in training too, with a bert-large tokenizer by default
    (Birch's checkpoints are bert-large)."""

    module_name = "birchbertpassage"
    single_training_passage = False
    dependencies = [
        Dependency(key="index", module="index", name="tpu",
                   default_config_overrides={"indexstops": True, "stemmer": "none"}),
        Dependency(key="tokenizer", module="tokenizer", name="berttokenizer",
                   default_config_overrides={"pretrained": "bert-large-uncased"}),
    ]


@Extractor.register
class LCEBertPassage(BertPassage):
    """Multiple negatives per sample for LCE training (``sampler.name=LCE``):
    bertpassage itself, under the reference's module name."""

    module_name = "LCEbertpassage"
