"""TREC files (the JAX package's ``utils/trec.py``): topics (TREC, NTCIR and
TSV), qrels, run files, passage-run max pooling, and the pure-Python branch of
``iterate_trec_docs``. The JAX package reads plain ASCII files through a
native C++ reader whose output its own tests pin equal to this parser's; the
native reader, and the trecweb and jsonl document formats, are not ported yet.
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


def load_trec_topics(path):
    """Parse a TREC topics file into {"title": {qid: text}, "desc": ..., "narr": ...}."""
    title, desc, narr = {}, {}, {}
    block, qid = None, None

    def flush_ws(parts):
        return " ".join(" ".join(parts).split())

    buffers = {"title": [], "desc": [], "narr": []}

    def end_block():
        nonlocal block
        if block and qid is not None and buffers[block]:
            target = {"title": title, "desc": desc, "narr": narr}[block]
            target[qid] = flush_ws(buffers[block])
        block = None

    with _open_maybe_gz(path) as f:
        for line in f:
            stripped = line.strip()
            low = stripped.lower()
            if low.startswith("<top>"):
                end_block()
                qid = None
                buffers = {"title": [], "desc": [], "narr": []}
            elif low.startswith("</top>"):
                end_block()
                qid = None
            elif low.startswith("<num>"):
                end_block()
                content = stripped[len("<num>") :].replace("Number:", "").replace("number:", "").strip()
                if content:
                    qid = content.split()[0]
            elif low.startswith("<title>"):
                end_block()
                block = "title"
                rest = stripped[len("<title>") :].replace("Topic:", "").strip()
                if rest:
                    buffers["title"].append(rest)
            elif low.startswith("<desc>"):
                end_block()
                block = "desc"
                rest = stripped[len("<desc>") :].replace("Description:", "").strip()
                if rest:
                    buffers["desc"].append(rest)
            elif low.startswith("<narr>"):
                end_block()
                block = "narr"
                rest = stripped[len("<narr>") :].replace("Narrative:", "").strip()
                if rest:
                    buffers["narr"].append(rest)
            elif low.startswith("<"):
                end_block()
            else:
                if qid is None and stripped and stripped.split()[0].isdigit() and block is None:
                    # some topic files put the number on its own line after <num>
                    qid = stripped.split()[0]
                elif block:
                    buffers[block].append(stripped)

    return {"title": title, "desc": desc, "narr": narr}


def load_ntcir_topics(path):
    """Parse NTCIR-format XML topics into {"title": {qid: text}}."""
    import re

    text = open(path, encoding="utf-8", errors="replace").read()
    topics = {}
    for m in re.finditer(r"<query>(.*?)</query>", text, re.DOTALL):
        block = m.group(1)
        qid = re.search(r"<qid>\s*(.*?)\s*</qid>", block, re.DOTALL)
        content = re.search(r"<content>\s*(.*?)\s*</content>", block, re.DOTALL)
        if qid and content:
            topics[qid.group(1).strip()] = " ".join(content.group(1).split())
    return {"title": topics}


def load_tsv_topics(path, query_type="title"):
    """Parse a qid\\tquery TSV topics file (MS MARCO style)."""
    topics = {}
    with _open_maybe_gz(path) as f:
        for line in f:
            if not line.strip():
                continue
            qid, text = line.rstrip("\n").split("\t", 1)
            topics[qid] = text.strip()
    return {query_type: topics}


def load_qrels(path, qids=None):
    """Parse a TREC qrels file into {qid: {docid: int label}}."""
    qrels = defaultdict(dict)
    with _open_maybe_gz(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, docid, label = parts[0], parts[1], parts[2], parts[3]
            if qids is not None and qid not in qids:
                continue
            qrels[qid][docid] = int(float(label))
    return dict(qrels)


def write_qrels(qrels, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wt", encoding="utf-8") as f:
        for qid in sorted(qrels):
            for docid in sorted(qrels[qid]):
                f.write(f"{qid} 0 {docid} {qrels[qid][docid]}\n")


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


def max_pool_trec_passage_run(run, delimiter="."):
    """Convert a passage-level run into a doc-level run by max-pooling passage scores."""
    pooled = {}
    for qid, docs in run.items():
        best = {}
        for pid, score in docs.items():
            docid = pid.split(delimiter)[0]
            if docid not in best or score > best[docid]:
                best[docid] = score
        pooled[qid] = best
    return pooled


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
