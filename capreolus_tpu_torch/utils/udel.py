"""UDel query expansion for TREC-COVID topics.

Capability parity with the reference's udel expander
(capreolus/utils/common.py:160-591): the expanded title is the
query's tokens minus the published UDel stopword list, plus the salient terms
of the question field. The reference extracts the question's terms with
scispacy biomedical NER (``en_core_sci_lg`` entity spans); scispacy is used
here too when installed, with an offline fallback that extracts the question's
content spans with the from-scratch chunker (analysis/chunker.py: function
words + question-frame verbs removed, maximal content runs kept), so question
fields like "what is known about the origin of COVID-19" reduce to the same
span set scispacy yields ("origin", "COVID-19") without any model download.
The 419-word stopword list ships verbatim as DATA
(capreolus_tpu_torch/data/udel_stopwords.txt, published in the reference at
utils/common.py:161-581), like the published fold/qrel files.
"""

from __future__ import annotations

import functools
from pathlib import Path

from capreolus_tpu_torch.analysis import standard_tokenize
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@functools.lru_cache(maxsize=1)
def udel_stopwords() -> frozenset:
    fn = Path(__file__).parent.parent / "data" / "udel_stopwords.txt"
    return frozenset(fn.read_text(encoding="utf-8").split())


def _keywords(text: str):
    sw = udel_stopwords()
    return [tok for tok in standard_tokenize(text) if tok.lower() not in sw]


@functools.lru_cache(maxsize=1)
def _scispacy_nlp():
    try:
        import spacy

        return spacy.load("en_core_sci_sm")
    except Exception:
        logger.info("scispacy model unavailable: udel question expansion uses the "
                    "from-scratch content-span chunker (analysis/chunker.py)")
        return None


def _scispacy_entities(text: str):
    nlp = _scispacy_nlp()
    if nlp is None:
        return None
    return [ent.text for ent in nlp(text).ents]


def udel_expand(query: str, question: str = "", narrative: str = "") -> str:
    """Expand a query with the question field's salient terms (reference:
    covid.py:170-173 — stopword-filtered title + entity terms of the question)."""
    base = _keywords(query)
    extra_src = question or narrative
    entities = _scispacy_entities(extra_src) if extra_src else None
    if entities is None:
        # offline approximation of the entity spans: content-span chunker
        # (reference applies NO stopword filter in entity mode, and neither
        # does the chunker path — only function/frame words are removed)
        from capreolus_tpu_torch.analysis.chunker import content_terms

        extra = content_terms(extra_src) if extra_src else []
    else:
        extra = [t for ent in entities for t in ent.split()]
    seen = set()
    combined = []
    for tok in base + extra:
        low = tok.lower()
        if low not in seen:
            seen.add(low)
            combined.append(tok.lower())
    return " ".join(combined)
