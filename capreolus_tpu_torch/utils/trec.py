"""TREC files: the pure-Python branch of the JAX package's
``utils/trec.py::iterate_trec_docs``, and its run-file reader and writer
(``load_trec_run``, ``write_trec_run``). The JAX package reads plain ASCII
files through a native C++ reader whose output its own tests pin equal to this
parser's; the native reader is not ported yet.
"""

from __future__ import annotations

import gzip
from collections import defaultdict
from pathlib import Path

# Content tags whose text is indexed, mirroring Anserini's TrecCollection
# semantics: HEADLINE/DATE/TEXT contribute to contents; SECTION/BYLINE/LENGTH/TYPE do not.
TREC_CONTENT_TAGS = ("text", "headline", "title", "hl", "head", "ttl", "dd", "date", "lp", "leadpara")


def _open_maybe_gz(path, mode="rt"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode, encoding="utf-8", errors="replace")
    return open(path, mode, encoding="utf-8", errors="replace")


def load_trec_run(path):
    """Parse a TREC run file into {qid: {docid: score}}, preserving insertion order."""
    run = defaultdict(dict)
    with _open_maybe_gz(path) as f:
        for line in f:
            if not line.strip():
                continue
            qid, _, docid, _, score, _ = line.split()[:6]
            run[qid][docid] = float(score)
    return dict(run)


def write_trec_run(run, path, tag="capreolus_tpu", mode="wt"):
    """Write {qid: {docid: score}} as a TREC run file sorted by descending score."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    count = 0
    with open(path, mode, encoding="utf-8") as f:
        for qid in sorted(run, key=lambda q: (len(q), q)):
            ranked = sorted(run[qid].items(), key=lambda kv: (-kv[1], kv[0]))
            for rank, (docid, score) in enumerate(ranked, start=1):
                f.write(f"{qid} Q0 {docid} {rank} {score} {tag}\n")
                count += 1
    return count


def iterate_trec_docs(path, content_tags=TREC_CONTENT_TAGS):
    """Yield (docid, contents) pairs from a TREC-format document file.

    Contents are the whitespace-joined text of the content tags, with <P>-style
    markup removed, in document order.
    """
    content_tags = set(content_tags)
    docid = None
    contents = []
    tag_stack = []

    with _open_maybe_gz(path) as f:
        for line in f:
            stripped = line.strip()
            low = stripped.lower()
            if low.startswith("<doc>"):
                docid, contents, tag_stack = None, [], []
            elif low.startswith("</doc>"):
                if docid is not None:
                    yield docid, " ".join(" ".join(contents).split())
                docid = None
            elif low.startswith("<docno>"):
                docid = stripped[len("<docno>") :].replace("</DOCNO>", "").replace("</docno>", "").strip()
            elif low.startswith("<") and not low.startswith("</") and low[1:].split(">")[0] in ("p", "br"):
                continue  # markup inside content blocks
            elif low.startswith("</"):
                tag = low[2:].split(">")[0].strip()
                if tag_stack and tag_stack[-1] == tag:
                    tag_stack.pop()
            elif low.startswith("<"):
                tag = low[1:].split(">")[0].strip()
                tag_stack.append(tag)
                rest = stripped.split(">", 1)
                if len(rest) == 2 and rest[1].strip() and tag in content_tags:
                    text = rest[1]
                    close = f"</{tag}>"
                    idx = text.lower().find(close)
                    if idx >= 0:
                        text = text[:idx]
                        tag_stack.pop()
                    contents.append(text.strip())
            else:
                if stripped and tag_stack and any(t in content_tags for t in tag_stack):
                    contents.append(stripped)
