"""Query-biased snippet extraction (a copy of the JAX package's
``analysis/highlight.py``, the Lucene highlighter's role): pick the document
window that best covers the query terms and mark the hits. Host-side work
only: a service returns snippets with its results (the HTTP front end's
``snippets`` flag) without touching the device.

Candidate windows of ``window`` tokens are scored by the unique query terms
they cover (idf-weighted when given) with a small density bonus for repeated
hits, the classic KWIC / Luhn recipe, and the best window comes back with its
matches wrapped in ``<em>...</em>`` (the marker is configurable). Matching
goes through the index's analyzer on both sides (stemming included), so
"galaxies" highlights "galaxy" as Lucene's analyzed highlighting does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


def _tokenize_with_spans(text: str) -> List[Tuple[str, int, int]]:
    """[(raw_token, start, end)] over the ORIGINAL text (spans for markup)."""
    return [(m.group(0), m.start(), m.end()) for m in _TOKEN_RE.finditer(text)]


def best_window(analyzed_doc: Sequence[Optional[str]], query_terms: Dict[str, float],
                window: int) -> Tuple[int, int, float]:
    """Best [start, end) token window by idf-weighted unique-term coverage +
    0.1 per extra hit (density bonus). Returns (start, end, score)."""
    n = len(analyzed_doc)
    if n == 0:
        return 0, 0, 0.0
    window = max(1, min(window, n))
    best = (0, window, 0.0)
    # O(n) sliding window with per-term hit counts
    counts: Dict[str, int] = {}
    hits = 0

    def score() -> float:
        uniq = sum(query_terms.get(t, 0.0) for t, c in counts.items() if c > 0)
        return uniq + 0.1 * max(0, hits - sum(1 for c in counts.values() if c > 0))

    for i in range(n):
        t = analyzed_doc[i]
        if t in query_terms:
            counts[t] = counts.get(t, 0) + 1
            hits += 1
        if i >= window:
            old = analyzed_doc[i - window]
            if old in query_terms:
                counts[old] -= 1
                hits -= 1
        if i >= window - 1:
            s = score()
            if s > best[2]:
                best = (i - window + 1, i + 1, s)
    return best


def make_snippet(text: str, query_terms: Dict[str, float], analyze=None,
                 window: int = 30, mark: Tuple[str, str] = ("<em>", "</em>"),
                 ellipsis: str = " … ", escape=None) -> str:
    """Query-biased snippet of ``text``: the best ``window``-token span with
    query-term matches wrapped in ``mark``. ``analyze(token) -> str|None``
    maps a raw token to its analyzed form (None = stopword/removed); identity
    lowercase when omitted. ``query_terms`` maps ANALYZED terms to weights
    (idf, or 1.0). ``escape(fragment) -> str`` encodes the DOCUMENT text
    before the markers are interleaved (Lucene's SimpleHTMLEncoder role —
    pass ``html.escape`` when snippets render as HTML, so corpus markup can
    neither inject nor masquerade as highlighter output)."""
    if analyze is None:
        analyze = lambda tok: tok.lower()
    if escape is None:
        escape = lambda frag: frag
    spans = _tokenize_with_spans(text)
    analyzed = [analyze(tok) for tok, _, _ in spans]
    start, end, score = best_window(analyzed, query_terms, window)
    if not spans:
        return escape(text[: window * 8])
    # truncation is about TOKENS dropped, not characters: the snippet extends
    # to the text boundaries when the window touches the first/last token (a
    # doc starting with quotes/whitespace is not "truncated")
    lo = spans[start][1] if start > 0 else 0
    hi = spans[end - 1][2] if end < len(spans) else len(text)
    out = []
    if start > 0:
        out.append(ellipsis.lstrip())
    cursor = lo
    for (tok, s, e), a in zip(spans[start:end], analyzed[start:end]):
        out.append(escape(text[cursor:s]))
        if a is not None and a in query_terms:
            out.append(mark[0] + escape(text[s:e]) + mark[1])
        else:
            out.append(escape(text[s:e]))
        cursor = e
    out.append(escape(text[cursor:hi]) if hi > cursor else "")
    if end < len(spans):
        out.append(ellipsis.rstrip())
    return "".join(out)


def snippets_for_hits(index, query: str, hits, window: int = 30,
                      mark: Tuple[str, str] = ("<em>", "</em>"),
                      html_escape: bool = True) -> List[str]:
    """Per-hit snippets through the INDEX's analyzer (stemming-aware matching,
    idf-weighted window choice): ``hits`` is [(docid, score), ...]. Document
    text is HTML-escaped by default (the markers are the only markup in the
    output — SimpleHTMLEncoder semantics); pass html_escape=False for
    plain-text consumers."""
    import html as _html

    q_terms = {t: max(float(index.get_idf(t)), 0.1) for t in set(index.analyze(query))}
    escape = _html.escape if html_escape else None

    def analyze_token(tok):
        out = index.analyze(tok)
        return out[0] if out else None

    result = []
    for docid, _ in hits:
        text = index.get_doc(docid) or ""
        result.append(make_snippet(text, q_terms, analyze=analyze_token, window=window,
                                   mark=mark, escape=escape))
    return result
