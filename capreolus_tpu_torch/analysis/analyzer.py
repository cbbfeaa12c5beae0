"""Lucene-style English analysis chain (the JAX package's ``analysis/analyzer.py``):

    StandardTokenizer (UAX#29 word-break approximation)
    -> EnglishPossessiveFilter -> LowerCaseFilter
    -> StopFilter (Lucene English stopword set) -> PorterStemFilter

ASCII text goes through the native C++ analyzer (``native/analyzer.cpp``)
when it loads, unless the stemmer is krovetz; unicode text, krovetz and a
host without the native library take the Python chain below, whose output
the native analyzer's equals.
"""

from __future__ import annotations

import functools
import re
from typing import List

from capreolus_tpu_torch.analysis.kstem import kstem
from capreolus_tpu_torch.analysis.porter import porter_stem
from capreolus_tpu_torch.native import native_analyze

# Lucene's EnglishAnalyzer.ENGLISH_STOP_WORDS_SET (33 words)
LUCENE_ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such that
    the their then there these they this to was will with""".split()
)

_APOSTROPHES = "'’＇"

# UAX#29-approximate word tokens: runs of unicode letters/digits, allowing
# single ' . , : between alphanumerics (MidLetter / MidNum / MidNumLet rules),
# which keeps "don't", "3.14", "U.S.A" and "1,000" single tokens like Lucene does.
_TOKEN_RE = re.compile(
    r"[^\W_]+(?:[{ap}.,:][^\W_]+)*".format(ap=_APOSTROPHES),
    re.UNICODE,
)

_MAX_TOKEN_LENGTH = 255  # StandardTokenizer default

# stemming is a pure function of the word; a corpus repeats a small vocabulary
# millions of times, so a bounded memo keeps the Python stemmer off the hot path
_cached_porter_stem = functools.lru_cache(maxsize=1 << 18)(porter_stem)
_cached_kstem = functools.lru_cache(maxsize=1 << 18)(kstem)


def standard_tokenize(text: str) -> List[str]:
    """Approximate Lucene StandardTokenizer (UAX#29 word break) output."""
    return [t for t in _TOKEN_RE.findall(text) if len(t) <= _MAX_TOKEN_LENGTH]


def strip_possessive(token: str) -> str:
    """Lucene EnglishPossessiveFilter: remove a trailing 's (any apostrophe form)."""
    if len(token) >= 2 and token[-1] in ("s", "S") and token[-2] in _APOSTROPHES:
        return token[:-2]
    return token


class EnglishAnalyzer:
    """English analyzer with Anserini's options.

    Args:
        stemmer: "porter", "krovetz" (dictionary-less inflectional approximation), or "none"
        keep_stopwords: if True, skip stopword removal (Anserini's ``keepStopwords``)
    """

    def __init__(self, stemmer: str = "porter", keep_stopwords: bool = False):
        if stemmer not in ("porter", "krovetz", "none"):
            raise ValueError(f"unsupported stemmer {stemmer!r}; expected 'porter', 'krovetz', or 'none'")
        self.stemmer = stemmer
        self.keep_stopwords = keep_stopwords

    def analyze(self, text: str) -> List[str]:
        if text.isascii() and self.stemmer != "krovetz":
            result = native_analyze(text, self.stemmer == "porter", self.keep_stopwords)
            if result is not None:
                return result
        stem = {"porter": _cached_porter_stem, "krovetz": _cached_kstem}.get(self.stemmer)
        tokens = []
        for raw in standard_tokenize(text):
            tok = strip_possessive(raw).lower()
            if not tok:
                continue
            if not self.keep_stopwords and tok in LUCENE_ENGLISH_STOPWORDS:
                continue
            if stem is not None:
                tok = stem(tok)
            tokens.append(tok)
        return tokens

    def __call__(self, text: str) -> List[str]:
        return self.analyze(text)

    def cache_key(self) -> str:
        return f"english_stem-{self.stemmer}_keepstops-{self.keep_stopwords}"


class WhitespaceAnalyzer:
    """Trivial analyzer: lowercase + whitespace split (useful for tests/fixtures)."""

    def analyze(self, text: str) -> List[str]:
        return text.lower().split()

    __call__ = analyze

    def cache_key(self) -> str:
        return "whitespace"


def get_analyzer(stemmer: str = "porter", keep_stopwords: bool = False):
    if stemmer is None:
        stemmer = "none"
    if stemmer == "whitespace":
        return WhitespaceAnalyzer()
    return EnglishAnalyzer(stemmer=stemmer, keep_stopwords=keep_stopwords)
