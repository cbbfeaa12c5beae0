"""Text segmentation (the JAX package's ``analysis/segmentation.py``):
TextTiling and an abbreviation-aware sentence splitter, pure Python and numpy.

``TextTilingSegmenter`` is Hearst's TextTiling (block comparison, depth
scores, the HC or LC cutoff, boundaries snapped to paragraph breaks), with the
observable behaviour of NLTK's ``TextTilingTokenizer`` at its defaults.
``split_sentences`` splits after ``.``, ``!`` and ``?`` except where the
period belongs to a known abbreviation, an initial, a decimal number or an
acronym: the sentence splitter of ``tokenizer.PunktTokenizer`` when NLTK's
punkt data is not installed. Both are copies of the JAX module's functions, so
they give the same segments.
"""

from __future__ import annotations

import math
import re

import numpy as np

# The standard English stopword list NLTK's TextTiling filters with (public,
# embedded so segmentation works offline). Callers can pass their own.
ENGLISH_STOPWORDS = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your yours
yourself yourselves he him his himself she she's her hers herself it it's its
itself they them their theirs themselves what which who whom this that that'll
these those am is are was were be been being have has had having do does did
doing a an the and but if or because as until while of at by for with about
against between into through during before after above below to from up down in
out on off over under again further then once here there when where why how all
any both each few more most other some such no nor not only own same so than
too very s t can will just don don't should should've now d ll m o re ve y ain
aren aren't couldn couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't
haven haven't isn isn't ma mightn mightn't mustn mustn't needn needn't shan
shan't shouldn shouldn't wasn wasn't weren weren't won won't wouldn wouldn't
""".split())

_MIN_PARAGRAPH = 100


def _paragraph_breaks(text):
    """Character offsets of paragraph starts: blank-line separators at least
    _MIN_PARAGRAPH chars apart (position 0 always included)."""
    breaks = [0]
    last = 0
    for m in re.finditer(r"[ \t\r\f\v]*\n[ \t\r\f\v]*\n[ \t\r\f\v]*", text):
        if m.start() - last >= _MIN_PARAGRAPH:
            breaks.append(m.start())
            last = m.start()
    return breaks


def _smooth_flat(x, window_len):
    """Moving-average smoothing with reflected ends (SciPy-cookbook semantics,
    the smoothing TextTiling's score plot uses)."""
    x = np.asarray(x, dtype=np.float64)
    if window_len < 3 or x.size < window_len:
        return list(x)
    s = np.r_[2 * x[0] - x[window_len:1:-1], x, 2 * x[-1] - x[-1:-window_len:-1]]
    w = np.ones(window_len) / window_len
    y = np.convolve(w, s, mode="same")
    return list(y[window_len - 1 : -window_len + 1])


class TextTilingSegmenter:
    """Topical segmentation via TextTiling (block-comparison variant).

    Drop-in for nltk.tokenize.TextTilingTokenizer's default configuration:
    ``tokenize(text)`` returns the text split at detected topic boundaries,
    normalized to paragraph breaks, and raises ValueError when the text has no
    paragraph breaks or too few pseudo-sentences — the same failure contract the
    reference's extractor catches (deeptileextractor.py:108-116).
    """

    def __init__(self, w=20, k=10, stopwords=None, smoothing_width=2, cutoff_policy="HC"):
        self.w = int(w)
        self.k = int(k)
        self.stopwords = frozenset(stopwords) if stopwords is not None else ENGLISH_STOPWORDS
        self.smoothing_width = int(smoothing_width)
        if cutoff_policy not in ("HC", "LC"):
            raise ValueError(f"cutoff_policy must be HC or LC, got {cutoff_policy!r}")
        self.cutoff_policy = cutoff_policy

    # ------------------------------------------------------------------ pipeline
    def tokenize(self, text):
        lowercase = text.lower()
        par_breaks = _paragraph_breaks(text)

        # keep only the characters the similarity computation sees
        nopunct = "".join(c for c in lowercase if re.match(r"[a-z\-' \n\t]", c))
        nopunct_breaks = _paragraph_breaks(nopunct)
        if len(nopunct_breaks) < 2:
            raise ValueError("no paragraph breaks were found (text too short?)")

        # pseudo-sentences: fixed w-word windows with character offsets
        words = [(m.group(), m.start()) for m in re.finditer(r"\w+", nopunct)]
        tokseqs = [words[i : i + self.w] for i in range(0, len(words), self.w)]
        # stopwords never participate in similarity
        tokseqs = [[wi for wi in ts if wi[0] not in self.stopwords] for ts in tokseqs]
        if len(tokseqs) < 2:
            raise ValueError("too few pseudo-sentences to segment")

        gap_scores = self._gap_scores(tokseqs)
        smooth_scores = _smooth_flat(gap_scores, self.smoothing_width + 1)
        depth = self._depth_scores(smooth_scores)
        boundaries = self._boundaries(depth)
        norm = self._normalize_to_paragraphs(text, boundaries, par_breaks)

        segments, prev = [], 0
        for b in norm:
            if b == 0:
                continue
            segments.append(text[prev:b])
            prev = b
        if prev < len(text):
            segments.append(text[prev:])
        return segments or [text]

    # ------------------------------------------------------------------ scores
    def _gap_scores(self, tokseqs):
        """Cosine similarity between the k-pseudo-sentence blocks on each side
        of every gap, over per-block term frequencies."""
        counts = []
        for ts in tokseqs:
            c = {}
            for w, _ in ts:
                c[w] = c.get(w, 0) + 1
            counts.append(c)
        numgaps = len(tokseqs) - 1
        scores = []
        for gap in range(numgaps):
            if gap < self.k - 1:
                window = gap + 1
            elif gap > numgaps - self.k:
                window = numgaps - gap
            else:
                window = self.k
            left, right = {}, {}
            for c in counts[gap - window + 1 : gap + 1]:
                for w, n in c.items():
                    left[w] = left.get(w, 0) + n
            for c in counts[gap + 1 : gap + window + 1]:
                for w, n in c.items():
                    right[w] = right.get(w, 0) + n
            dot = sum(n * right.get(w, 0) for w, n in left.items())
            n1 = sum(n * n for n in left.values())
            n2 = sum(n * n for n in right.values())
            scores.append(dot / math.sqrt(n1 * n2) if n1 and n2 else 0.0)
        return scores

    def _depth_scores(self, scores):
        """Depth of each gap: height of the nearest enclosing peaks on both
        sides minus twice the gap's own score; ends are clipped."""
        depth = [0.0] * len(scores)
        clip = min(max(len(scores) // 10, 2), 5)
        for i in range(clip, len(scores) - clip):
            lpeak = scores[i]
            for s in scores[i::-1]:
                if s >= lpeak:
                    lpeak = s
                else:
                    break
            rpeak = scores[i]
            for s in scores[i:]:
                if s >= rpeak:
                    rpeak = s
                else:
                    break
            depth[i] = lpeak + rpeak - 2 * scores[i]
        return depth

    def _boundaries(self, depth):
        """Mark gaps whose depth exceeds the cutoff (mean - std/2 for HC,
        mean - std for LC), suppressing boundaries within 4 gaps of a
        stronger one."""
        marks = [0] * len(depth)
        if not depth:
            return marks
        avg = sum(depth) / len(depth)
        std = float(np.std(depth))
        cutoff = avg - std if self.cutoff_policy == "LC" else avg - std / 2.0
        ranked = sorted(zip(depth, range(len(depth))), reverse=True)
        strong = [t for t in ranked if t[0] > cutoff]
        for _, i in strong:
            marks[i] = 1
            for _, j in strong:
                if i != j and abs(i - j) < 4 and marks[j] == 1:
                    marks[i] = 0
        return marks

    def _normalize_to_paragraphs(self, text, boundaries, par_breaks):
        """Snap each marked gap to the closest paragraph break in the ORIGINAL
        text (walking words in the original to locate gap positions)."""
        out = []
        char_count = word_count = gaps_seen = 0
        in_word = False
        for ch in text:
            char_count += 1
            if ch in " \t\n" and in_word:
                in_word = False
                word_count += 1
            if ch not in " \t\n" and not in_word:
                in_word = True
            if gaps_seen < len(boundaries) and word_count > max(gaps_seen * self.w, self.w):
                if boundaries[gaps_seen] == 1:
                    best, bestbr = len(text), None
                    for br in par_breaks:
                        if best > abs(br - char_count):
                            best = abs(br - char_count)
                            bestbr = br
                        else:
                            break
                    if bestbr is not None and bestbr not in out:
                        out.append(bestbr)
                gaps_seen += 1
        return out


# --------------------------------------------------------------------- sentences

# common English abbreviations that end with a period but do not end a sentence
_ABBREVIATIONS = frozenset("""
mr mrs ms dr prof rev hon st jr sr messrs mmes msgr gov gen rep sen sgt cpl col
capt lt cmdr adm maj pvt co corp inc ltd dept dist div est al etc eg ie viz cf
vs v ca approx appt apt ave blvd rd mt ft pt no nos vol vols pp ch sec fig figs
ed eds trans univ assn bros jan feb mar apr jun jul aug sep sept oct nov dec
mon tue tues wed thu thurs fri sat sun usa uss
""".split())

_TERMINATOR = re.compile(r"[.!?]+[\"'”’)\]]*")


def split_sentences(text):
    """Abbreviation-aware sentence splitting (punkt-equivalent, rule-based).

    Splits after ``.``/``!``/``?`` (plus trailing quotes/brackets) unless the
    period belongs to a known abbreviation, a single-letter initial, a decimal
    number, or an acronym like ``U.S.`` — the error classes a naive regex gets
    wrong and punkt's learned parameters exist to fix. The next sentence must
    start with an uppercase letter, digit, or opening quote.
    """
    text = text.strip()
    if not text:
        return []
    sentences = []
    start = 0
    for m in _TERMINATOR.finditer(text):
        end = m.end()
        if end >= len(text):
            break
        # next non-space char must plausibly start a sentence
        rest = text[end:]
        nxt = rest.lstrip()
        if not nxt:
            break
        if rest[0] not in " \t\n\r":
            continue  # terminator glued to following text (e.g. "3.14")
        if not (nxt[0].isupper() or nxt[0].isdigit() or nxt[0] in "\"'“‘([" ):
            continue
        if "." in m.group():
            # the word carrying the period
            prev = text[start:m.start()].rsplit(None, 1)
            word = prev[-1] if prev else ""
            token = (word + text[m.start():m.end()]).strip("\"'“”‘’()[]")
            core = token.rstrip(".").lower()
            if core in _ABBREVIATIONS:
                continue
            if len(core) == 1 and core.isalpha():
                continue  # single-letter initial: "J. Smith"
            if re.fullmatch(r"(?:[a-z]\.)+[a-z]?", core + ".", flags=re.IGNORECASE):
                continue  # acronym: U.S., i.e., Ph.D.-style dotted forms
        sentences.append(text[start:end].strip())
        start = end
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences
