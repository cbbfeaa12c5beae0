"""Content-span chunking: a from-scratch, offline approximation of the
entity-span extraction the reference's udel query expander gets from scispacy.

The reference expands TREC-COVID question fields with ``en_core_sci_lg``
entity spans (reference capreolus/utils/common.py:582-589: ``nlp(txt).ents``).
scispacy's sci-model mention detector is deliberately liberal — on question
text it marks essentially every noun-phrase-like content span and skips the
question frame ("what is known about X" -> ["X"]). That behavior is
approximated here without any model download:

- a closed-class lexicon (determiners, pronouns, prepositions, conjunctions,
  auxiliaries/modals, wh-words, frequency adverbs) marks tokens that can
  never be inside a mention span;
- a curated list of general-English *question-frame* verb forms (know/known,
  seek/seeking, describe, look for, learn, ...) marks the verbs scispacy's
  biomedical mention detector does not tag — chosen conservatively so that
  deverbal nouns that ARE retrieval content ("spread", "transmission",
  "findings", "response") are NOT excluded;
- maximal runs of the remaining tokens form the content spans.

This is an approximation, not scispacy: a skip-marked parity test
(tests/test_analysis.py) referees against scispacy when the model is
installed, mirroring how WordPiece is referee'd against ``transformers``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from capreolus_tpu_torch.analysis.analyzer import standard_tokenize

# Closed-class words: never part of a mention span. Deliberately restricted to
# true function words — no content nouns/adjectives (those belong to the udel
# stopword list, which the caller applies separately to the *title*).
FUNCTION_WORDS = frozenset("""
a an the this that these those such same other another each every either neither
any some all both few many much more most several certain various
i me my mine we us our ours you your yours he him his she her hers it its they
them their theirs one ones oneself myself yourself himself herself itself
ourselves yourselves themselves who whom whose which what whatever whichever
when where why how whether if because since although though while whereas
unless until before after during within without about above below under over
between among through throughout across against along around at by for from in
into of off on onto out outside per than to toward towards up upon via with
and or nor but so yet
am is are was were be been being
do does did doing done
have has had having
can could may might must shall should will would ought
not no nor never also too very quite rather somewhat then there here
etc eg ie vs
""".split())

# Question-frame verb forms (exact surface forms, not stems): the verbs that
# carry a question's phrasing rather than its topic. Conservative on purpose —
# ambiguous verb/noun forms that are retrieval content in biomedical text
# ("spread", "increase", "response", "studies", "findings", "results",
# "effects", "use" as a noun) are intentionally absent.
FRAME_VERBS = frozenset("""
know known knows knew knowing
seek seeking seeks sought
look looking looked looks
learn learned learnt learning learns
want wanted wanting wants
wish wishing wished wishes
describe described describing describes
discuss discussed discussing discusses
explain explained explaining explains
identify identified identifying identifies
determine determined determining determines
include included including includes
consider considered considering considers
regarding concerning
relate related relating relates
say said saying says
tell told telling tells
find finds
ask asked asking asks
answer answered answering answers
provide provided providing provides
contain contains contained containing
occur occurs occurred occurring
become becomes became becoming
make makes made making
take takes took taken taking
give gives gave given giving
get gets got gotten getting
go goes went gone going
come comes came coming
see sees saw seen seeing
appear appears appeared appearing
seem seems seemed seeming
happen happens happened happening
exist exists existed existing
remain remains remained remaining
""".split())


def content_spans(text: str, tokens: Optional[Sequence[str]] = None) -> List[List[str]]:
    """Maximal runs of content tokens — the entity-span approximation.

    ``tokens`` overrides tokenization (already-tokenized input); otherwise the
    Lucene-equivalent ``standard_tokenize`` is used, so spans align with what
    the downstream analyzer will index.
    """
    toks = list(tokens) if tokens is not None else standard_tokenize(text)
    spans: List[List[str]] = []
    current: List[str] = []
    for tok in toks:
        low = tok.lower()
        if low in FUNCTION_WORDS or low in FRAME_VERBS:
            if current:
                spans.append(current)
                current = []
        else:
            current.append(tok)
    if current:
        spans.append(current)
    return spans


def content_terms(text: str) -> List[str]:
    """Flat token list of all content spans (what udel expansion consumes)."""
    return [tok for span in content_spans(text) for tok in span]
