"""Tokenizer modules, as in the JAX package's ``tokenizer/__init__.py``:
``lucene`` (the Lucene English analyzer) and its ``anserini`` alias, and
``berttokenizer`` (WordPiece from a vocab file, or the offline hash stand-in).
The punkt sentence tokenizer comes with sentence passages (ROADMAP)."""

from __future__ import annotations

import hashlib
import os
import re

from capreolus_tpu_torch.analysis import get_analyzer
from capreolus_tpu_torch.core import ConfigOption, ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@register_module_type
class Tokenizer(ModuleBase):
    """Base class for Tokenizer modules."""

    module_type = "tokenizer"

    def tokenize(self, sentences):
        raise NotImplementedError


@Tokenizer.register
class LuceneTokenizer(Tokenizer):
    """English analyzer with Lucene semantics."""

    module_name = "lucene"
    config_spec = [
        ConfigOption("keepstops", True, "keep stopwords"),
        ConfigOption("stemmer", "none", "stemmer: porter or none"),
    ]

    def build(self):
        self._analyzer = get_analyzer(stemmer=self.config["stemmer"], keep_stopwords=self.config["keepstops"])

    def tokenize(self, sentences):
        if not sentences:
            return []
        if isinstance(sentences, str):
            return self._analyzer.analyze(sentences)
        return [self._analyzer.analyze(s) for s in sentences]


@Tokenizer.register
class AnseriniTokenizerAlias(LuceneTokenizer):
    """Alias so configs using tokenizer.name=anserini keep working."""

    module_name = "anserini"


class _HashWordpieceFallback:
    """Deterministic offline stand-in for a pretrained wordpiece vocab: whitespace +
    lowercase tokens hashed into the BERT id space (a copy of the JAX package's,
    md5 ids included). Models served with it run on random or seeded weights."""

    vocab_size = 30522
    pad_token, cls_token, sep_token, unk_token = "[PAD]", "[CLS]", "[SEP]", "[UNK]"
    pad_token_id, cls_token_id, sep_token_id, unk_token_id = 0, 101, 102, 100
    _special = {"[PAD]": 0, "[CLS]": 101, "[SEP]": 102, "[UNK]": 100, "[MASK]": 103}

    def tokenize(self, text):
        return re.findall(r"[^\W_]+|[^\w\s]", text.lower())

    def convert_tokens_to_ids(self, tokens):
        out = []
        for tok in tokens:
            if tok in self._special:
                out.append(self._special[tok])
            else:
                h = int(hashlib.md5(tok.encode("utf-8")).hexdigest()[:8], 16)
                out.append(1000 + h % (self.vocab_size - 1000))
        return out


@Tokenizer.register
class BertTokenizer(Tokenizer):
    """BERT wordpiece tokenizer: the from-scratch WordPiece
    (``tokenizer/wordpiece.py``) when ``vocabfile`` names a vocab.txt, else the
    hash-vocab fallback.

    The JAX module first tries HuggingFace's ``AutoTokenizer`` for
    ``pretrained``; that branch is the one part left out here, because the port
    never imports ``transformers`` and never downloads. ``pretrained`` is kept
    so that configs load unchanged."""

    module_name = "berttokenizer"
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "pretrained tokenizer name"),
        ConfigOption("vocabfile", "", "path to a WordPiece vocab.txt for the from-scratch WordPiece "
                     "tokenizer; without it, the offline hash-wordpiece fallback"),
    ]

    def build(self):
        vocabfile = self.config["vocabfile"]
        if vocabfile:
            from capreolus_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer

            self.bert_tokenizer = WordPieceTokenizer(vocabfile)
        else:
            logger.warning("no tokenizer.vocabfile: using the offline hash-wordpiece fallback (ids are NOT "
                           "real WordPiece; supply tokenizer.vocabfile for real offline tokenization)")
            self.bert_tokenizer = _HashWordpieceFallback()

    # special-token accessors used by the bertpassage extractor
    @property
    def pad_token(self):
        return self.bert_tokenizer.pad_token

    @property
    def cls_token(self):
        return self.bert_tokenizer.cls_token

    @property
    def sep_token(self):
        return self.bert_tokenizer.sep_token

    @property
    def pad_id(self):
        return self.bert_tokenizer.pad_token_id

    @property
    def cls_id(self):
        return self.bert_tokenizer.cls_token_id

    @property
    def sep_id(self):
        return self.bert_tokenizer.sep_token_id

    @property
    def vocab_size(self):
        tok = self.bert_tokenizer
        return int(getattr(tok, "vocab_size", len(getattr(tok, "vocab", {})) or 30522))

    @property
    def fingerprint(self):
        """Identity of the tokenizer in use, for the cache keys of tokenized
        artifacts (the late-interaction doc embeddings): ``hashfallback``, or
        the vocab file with its size and mtime. The JAX module's ``hf:`` branch
        has no counterpart, because the port has no HuggingFace tokenizer."""
        if isinstance(self.bert_tokenizer, _HashWordpieceFallback):
            return "hashfallback"
        vf = self.config["vocabfile"]
        try:
            st = os.stat(vf)
            return f"wordpiece:{vf}:{st.st_size}:{st.st_mtime_ns}"
        except OSError:
            return f"wordpiece:{vf}"

    def convert_tokens_to_ids(self, tokens):
        return self.bert_tokenizer.convert_tokens_to_ids(tokens)

    def tokenize(self, sentences):
        if not sentences:
            return []
        if isinstance(sentences, str):
            return self.bert_tokenizer.tokenize(sentences)
        return [self.bert_tokenizer.tokenize(s) for s in sentences]


import_all_modules(__file__, __package__)
