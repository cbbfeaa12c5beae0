"""Porter stemmer (Martin Porter's algorithm, 1980).

Implemented from the published algorithm description, including the two departures
present in Porter's updated ANSI-C reference version (and therefore in the Lucene
PorterStemFilter behind Anserini's DefaultEnglishAnalyzer):
  - step 2: "bli" -> "ble" (instead of "abli" -> "able")
  - step 2: adds "logi" -> "log"

A copy of the JAX package's ``analysis/porter.py``: bit-for-bit stemming parity
matters because BM25 parity depends on identical term statistics.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiou")


class _Stem:
    __slots__ = ("b", "k", "j")

    def __init__(self, word: str):
        self.b = list(word)
        self.k = len(word) - 1  # index of last char of current stem
        self.j = 0  # general offset used by condition checks

    # -- character classification -------------------------------------------------
    def cons(self, i: int) -> bool:
        ch = self.b[i]
        if ch in _VOWELS:
            return False
        if ch == "y":
            return True if i == 0 else not self.cons(i - 1)
        return True

    def m(self) -> int:
        """Number of consonant-vowel sequences in b[0..j]."""
        n = 0
        i = 0
        j = self.j
        while True:
            if i > j:
                return n
            if not self.cons(i):
                break
            i += 1
        i += 1
        while True:
            while True:
                if i > j:
                    return n
                if self.cons(i):
                    break
                i += 1
            i += 1
            n += 1
            while True:
                if i > j:
                    return n
                if not self.cons(i):
                    break
                i += 1
            i += 1

    def vowel_in_stem(self) -> bool:
        return any(not self.cons(i) for i in range(self.j + 1))

    def double_c(self, j: int) -> bool:
        if j < 1:
            return False
        if self.b[j] != self.b[j - 1]:
            return False
        return self.cons(j)

    def cvc(self, i: int) -> bool:
        """cons-vowel-cons ending at i, where the final cons is not w, x or y."""
        if i < 2 or not self.cons(i) or self.cons(i - 1) or not self.cons(i - 2):
            return False
        return self.b[i] not in ("w", "x", "y")

    # -- suffix operations ----------------------------------------------------------
    def ends(self, s: str) -> bool:
        length = len(s)
        if length > self.k + 1:
            return False
        if "".join(self.b[self.k - length + 1 : self.k + 1]) != s:
            return False
        self.j = self.k - length
        return True

    def setto(self, s: str):
        self.b[self.j + 1 : self.k + 1] = list(s)
        self.k = self.j + len(s)

    def r(self, s: str):
        if self.m() > 0:
            self.setto(s)


def _step1ab(z: _Stem):
    if z.b[z.k] == "s":
        if z.ends("sses"):
            z.k -= 2
        elif z.ends("ies"):
            z.setto("i")
        elif z.b[z.k - 1] != "s":
            z.k -= 1
    if z.ends("eed"):
        if z.m() > 0:
            z.k -= 1
    elif (z.ends("ed") or z.ends("ing")) and z.vowel_in_stem():
        z.k = z.j
        if z.ends("at"):
            z.setto("ate")
        elif z.ends("bl"):
            z.setto("ble")
        elif z.ends("iz"):
            z.setto("ize")
        elif z.double_c(z.k):
            z.k -= 1
            if z.b[z.k] in ("l", "s", "z"):
                z.k += 1
        else:
            z.j = z.k
            if z.m() == 1 and z.cvc(z.k):
                z.setto("e")


def _step1c(z: _Stem):
    if z.ends("y") and z.vowel_in_stem():
        z.b[z.k] = "i"


_STEP2 = (
    ("ational", "ate"), ("tional", "tion"),
    ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"),
    ("bli", "ble"),  # -DEPARTURE- (published: abli -> able)
    ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
    ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ("logi", "log"),  # -DEPARTURE- (not in the published algorithm)
)

_STEP3 = (
    ("icate", "ic"), ("ative", ""), ("alize", "al"),
    ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""),
)

_STEP4 = (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
)


def _step2(z: _Stem):
    for suffix, repl in _STEP2:
        if z.ends(suffix):
            z.r(repl)
            return


def _step3(z: _Stem):
    for suffix, repl in _STEP3:
        if z.ends(suffix):
            z.r(repl)
            return


def _step4(z: _Stem):
    for suffix in _STEP4:
        if z.ends(suffix):
            if suffix == "ion" and not (z.j >= 0 and z.b[z.j] in ("s", "t")):
                continue
            if z.m() > 1:
                z.k = z.j
            return


def _step5(z: _Stem):
    z.j = z.k
    if z.b[z.k] == "e":
        a = z.m()
        if a > 1 or (a == 1 and not z.cvc(z.k - 1)):
            z.k -= 1
    if z.b[z.k] == "l" and z.double_c(z.k) and z.m() > 1:
        z.k -= 1


def porter_stem(word: str) -> str:
    """Stem a lowercase ASCII word with the Porter algorithm (Lucene-parity variant)."""
    if len(word) <= 2:
        return word
    z = _Stem(word)
    _step1ab(z)
    _step1c(z)
    _step2(z)
    _step3(z)
    _step4(z)
    _step5(z)
    return "".join(z.b[: z.k + 1])
