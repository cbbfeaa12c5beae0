"""Krovetz-style inflectional stemmer (dictionary-less approximation).

The reference exposes Anserini's ``krovetz`` stemmer option
(capreolus/index/anserini.py:17-20). The original KStem is a
dictionary-driven algorithm; this implementation reproduces its *inflectional*
behavior — plural, past-tense, and -ing removal with spelling recovery — using
Krovetz's published rule structure plus a small exception table, without the
(large, distribution-encumbered) head-word dictionary. It is deliberately more
conservative than Porter: derivational suffixes (-ness, -ation, ...) are left
intact, which is the property experiments choose krovetz for.
"""

from __future__ import annotations

_VOWELS = set("aeiouy")

# common irregular forms (KStem resolves these via its dictionary)
_IRREGULAR = {
    "men": "man", "women": "woman", "children": "child", "teeth": "tooth",
    "feet": "foot", "geese": "goose", "mice": "mouse", "people": "person",
    "went": "go", "gone": "go", "made": "make", "said": "say", "done": "do",
    "ran": "run", "came": "come", "saw": "see", "seen": "see", "took": "take",
    "taken": "take", "gave": "give", "given": "give", "found": "find",
    "brought": "bring", "bought": "buy", "thought": "think", "knew": "know",
    "known": "know", "grew": "grow", "grown": "grow", "left": "leave",
    "lives": "life", "wives": "wife", "knives": "knife", "leaves": "leaf",
    "selves": "self", "shelves": "shelf",
}

# words that look inflected but are not
_PROTECTED = {
    "news", "species", "series", "bus", "plus", "is", "was", "has", "this",
    "thus", "its", "as", "us", "gas", "yes", "analysis", "basis", "crisis",
    "focus", "status", "virus", "census", "campus", "lens", "corpus",
    "during", "thing", "something", "nothing", "anything", "everything",
    "sing", "king", "ring", "wing", "spring", "string", "bring", "morning",
    "evening", "being", "red", "bed", "shed", "wed", "need", "feed", "seed",
    "speed", "deed", "indeed", "used",
}


def _has_vowel(word: str) -> bool:
    return any(c in _VOWELS for c in word)


def _plural(word: str) -> str:
    """Step 1: -s / -es / -ies plural removal."""
    if word.endswith("ies") and len(word) > 4:
        # cities -> city (KStem prefers the -y form when plausible)
        return word[:-3] + "y"
    if word.endswith("es") and len(word) > 3:
        stem = word[:-2]
        # -ches, -shes, -sses, -xes, -zes drop 'es'; otherwise drop only 's'
        if stem.endswith(("ch", "sh", "ss", "x", "z")):
            return stem
        return word[:-1]
    if word.endswith("s") and not word.endswith(("ss", "us", "is")) and len(word) > 3:
        return word[:-1]
    return word


def _past(word: str) -> str:
    """Step 2: -ed removal with spelling recovery."""
    if not word.endswith("ed") or len(word) <= 4:
        return word
    stem = word[:-2]
    if not _has_vowel(stem):
        return word
    if word.endswith("ied"):
        return word[:-3] + "y"  # carried -> carry
    if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in "lsz":
        return stem[:-1]  # hopped -> hop
    if stem.endswith(("at", "iz", "bl", "u", "v", "c", "g")) and not stem.endswith("ng"):
        return stem + "e"  # created -> create, loved -> love
    return stem


def _ing(word: str) -> str:
    """Step 3: -ing removal with spelling recovery."""
    if not word.endswith("ing") or len(word) <= 5:
        return word
    stem = word[:-3]
    if not _has_vowel(stem):
        return word
    if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in "lsz":
        return stem[:-1]  # hopping -> hop
    if stem.endswith(("at", "iz", "u", "v", "c", "g")) and not stem.endswith("ng"):
        return stem + "e"  # creating -> create
    if len(stem) >= 3 and stem[-1] not in _VOWELS and stem[-2] in _VOWELS and stem[-3] not in _VOWELS:
        # CVC pattern: making -> make? KStem checks the dictionary; keep bare form
        return stem
    return stem


def kstem(word: str) -> str:
    """Inflectional stem of a lowercase word."""
    if len(word) <= 2 or word in _PROTECTED:
        return word
    if word in _IRREGULAR:
        return _IRREGULAR[word]
    word = _plural(word)
    if word in _PROTECTED:
        return word
    word = _past(word)
    word = _ing(word)
    return word
