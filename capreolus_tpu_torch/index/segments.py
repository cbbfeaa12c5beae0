"""Incremental indexing: Lucene-style segment writes and generation commits
(a copy of the JAX package's ``index/segments.py``).

Lucene's IndexWriter appends documents to a live index (new segments) and
deletes by tombstone, with merges compacting segments and a commit point
(``segments_N``) naming the current generation; readers re-open to see new
commits. This module gives TpuIndex the same capability:

- ``add_documents`` tokenizes the new docs ONCE and buffers them as an on-disk
  *op* (a segment: global-vocab triples + doc store bytes); nothing existing
  is rewritten.
- ``delete_documents`` buffers a tombstone op.
- ``merge_pending`` (Lucene's merge + commit) replays pending ops in order,
  compacts deletions, re-runs the canonical (term, range, impact) sort, and
  writes a full artifact set into a NEW generation directory
  ``<index>/gen-N/``; the swap is one atomic ``os.replace`` of the CURRENT
  pointer file. Readers resolve artifacts through CURRENT, so an open reader
  keeps its old (still on-disk) generation until it re-opens — Lucene's
  point-in-time semantics.

Merged results are EXACTLY what a from-scratch build over the same surviving
documents (in first-added order) would produce: doc ordinals, statistics
(df/N/avgdl/norms), prune tables, and the forward index all match, so every
downstream engine (scoring, pruning, RM3, SDM) is oblivious to how the index
was grown (equality pinned in tests/test_torch_incremental.py).

Durability notes: the shared doc stores (docs.bin / docterms.bin) are
append-only. A merge journal records the pre-append EOFs keyed by the target
generation, so a failed attempt's orphan bytes are truncated on retry instead
of accumulating; deleted documents' bytes are reclaimed by the offline
``compact_doc_stores`` (rewrites the stores into a versioned ``store-K/`` dir
and commits a hardlinked generation atomically). Op directories are created
under a dot-tmp name and renamed into place, and are only removed after the
CURRENT swap; each generation records the ops it consumed so a failed cleanup
cannot double-apply, and op sequence numbers stay monotonic across merges
(consumed names are never reused). The previous generation is kept for one
extra commit (deleted at N+2) so in-flight readers — including ones that
lazily materialize tile artifacts — survive one refresh.

Term ids are append-only across generations (like Lucene, terms whose df
drops to zero keep their id until they naturally vanish from a future fresh
build) — scores never depend on term ids, only on df/tf/dl statistics.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import Counter
from pathlib import Path

import numpy as np

from capreolus_tpu_torch.index.smallfloat import quantize_lengths
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

OPS_DIR = "segments"


class _WriterLock:
    """Lucene's write.lock: at most one writer (add/delete/merge) per index.
    Exclusive-create of a lock file; stale locks (no live pid) are broken."""

    def __init__(self, index_path: Path):
        self.fn = index_path / "write.lock"

    def __enter__(self):
        for _ in range(2):
            try:
                fd = os.open(self.fn, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return self
            except FileExistsError:
                try:
                    pid = int(self.fn.read_text() or "0")
                except (ValueError, FileNotFoundError):
                    pid = 0
                alive = False
                if pid > 0:
                    try:
                        os.kill(pid, 0)
                        alive = True
                    except ProcessLookupError:
                        alive = False
                    except PermissionError:  # exists, owned by another user
                        alive = True
                if alive and pid != os.getpid():
                    raise IOError(
                        f"index write.lock at {self.fn} is held by live pid {pid}; "
                        f"only one writer may add/delete/merge at a time (Lucene "
                        f"LockObtainFailedException semantics)"
                    )
                logger.warning("breaking stale write.lock at %s (pid %s not alive)", self.fn, pid)
                self.fn.unlink(missing_ok=True)
        raise IOError(f"could not obtain index write.lock at {self.fn}")

    def __exit__(self, *exc):
        self.fn.unlink(missing_ok=True)


# --------------------------------------------------------------------- state
def artifacts_dir(index_path: Path) -> Path:
    """Directory holding the current generation's artifacts: the generation
    dir named by the CURRENT pointer file, else the index root (gen 0 — the
    layout every freshly built index has, so non-incremental indexes never
    see any of this machinery)."""
    current = index_path / "CURRENT"
    if current.exists():
        name = current.read_text(encoding="utf-8").strip()
        gen_dir = index_path / name
        if name.startswith("gen-") and gen_dir.is_dir():
            return gen_dir
        logger.warning("CURRENT at %s names missing generation %r; falling back to root",
                       index_path, name)
    return index_path


def generation(index_path: Path) -> int:
    d = artifacts_dir(index_path)
    return 0 if d == index_path else int(d.name.split("-", 1)[1])


def store_dir(index_path: Path, art: Path = None) -> Path:
    """Directory holding the shared doc stores (docs.bin / docterms.bin) that
    a generation's spans point into: named by store_name.txt in the artifacts
    dir (written by compact_doc_stores), else the index root. Callers that
    already resolved an artifacts dir MUST pass it as ``art`` — resolving
    CURRENT a second time could pair spans from one generation with the store
    of a newer one committed in between."""
    if art is None:
        art = artifacts_dir(index_path)
    fn = art / "store_name.txt"
    if fn.exists():
        d = index_path / fn.read_text(encoding="utf-8").strip()
        if d.is_dir():
            return d
        logger.warning("store_name.txt at %s names a missing store dir; falling back to root", art)
    return index_path


def _consumed_ops(art_dir: Path) -> set:
    fn = art_dir / "consumed_ops.json"
    if fn.exists():
        return set(json.loads(fn.read_text(encoding="utf-8")))
    return set()


def pending_ops(index_path: Path) -> list:
    """Buffered op dirs not yet merged into the current generation, in
    sequence order. Only ops with a done marker count (a crashed writer's
    half-built dot-tmp dir is invisible)."""
    ops_dir = index_path / OPS_DIR
    if not ops_dir.is_dir():
        return []
    consumed = _consumed_ops(artifacts_dir(index_path))
    ops = sorted(
        d for d in ops_dir.iterdir()
        if d.is_dir() and not d.name.startswith(".") and (d / "done").exists()
    )
    return [d for d in ops if d.name not in consumed]


def _next_seq(index_path: Path) -> int:
    """Monotonic op sequence numbers across merges. Merged op dirs are
    rmtree'd after commit, so scanning dirs alone would reset the sequence;
    a reused name would match consumed_ops.json and the new op would be
    silently filtered out of pending_ops (data loss). Take the max over both
    live op dirs AND the names the current generation already consumed."""
    seqs = [0]
    ops_dir = index_path / OPS_DIR
    if ops_dir.is_dir():
        seqs += [int(d.name.split("-", 1)[0]) for d in ops_dir.iterdir()
                 if d.is_dir() and not d.name.startswith(".")]
    seqs += [int(name.split("-", 1)[0]) for name in _consumed_ops(artifacts_dir(index_path))]
    return max(seqs) + 1


def _read_lines(fn: Path) -> list:
    text = fn.read_text(encoding="utf-8")
    return text.splitlines()


def live_docids(index_path: Path) -> dict:
    """Ordered docid -> None mapping after replaying pending ops on the
    current generation (the visible corpus a merge would produce)."""
    live = dict.fromkeys(_read_lines(artifacts_dir(index_path) / "docids.txt"))
    for op in pending_ops(index_path):
        ids = _read_lines(op / "docids.txt")
        if op.name.endswith("-add"):
            for d in ids:
                live[d] = None
        else:
            for d in ids:
                live.pop(d, None)
    return live


def _current_vocab(index_path: Path) -> dict:
    """Current term -> id mapping including terms introduced by pending adds
    (append-only, so segment triples can carry final global ids)."""
    vocab = {t: i for i, t in enumerate(_read_lines(artifacts_dir(index_path) / "vocab.txt"))}
    for op in pending_ops(index_path):
        if op.name.endswith("-add"):
            fn = op / "new_terms.txt"
            if fn.stat().st_size:
                for t in _read_lines(fn):
                    vocab.setdefault(t, len(vocab))
    return vocab


# ----------------------------------------------------------------------- ops
def write_add_op(index_path: Path, docs, analyzer, store_positions: bool) -> Path:
    """Tokenize ``docs`` (iterable of (docid, contents)) into a buffered
    segment op. Raises ValueError on a docid that already exists live (Lucene
    updates are delete-then-add; re-adding a deleted docid is fine)."""
    with _WriterLock(index_path):
        return _write_add_op_locked(index_path, docs, analyzer, store_positions)


def _write_add_op_locked(index_path, docs, analyzer, store_positions):
    live = live_docids(index_path)
    vocab = _current_vocab(index_path)
    base_vocab_size = len(vocab)

    docids, doclens = [], []
    term_chunks, doc_chunks, tf_chunks = [], [], []
    doc_bytes = bytearray()
    byte_offsets = [0]
    docterm_bytes = bytearray()
    docterm_offsets = [0]
    new_terms = []

    def intern(tok):
        tid = vocab.get(tok)
        if tid is None:
            tid = len(vocab)
            vocab[tok] = tid
            new_terms.append(tok)
        return tid

    seen = set()
    for ord_, (docid, contents) in enumerate(docs):
        if docid in live or docid in seen:
            raise ValueError(
                f"docid {docid!r} already exists in the index; delete it first "
                f"(Lucene updateDocument = deleteDocuments + addDocuments)"
            )
        seen.add(docid)
        tokens = analyzer.analyze(contents)
        docids.append(docid)
        doclens.append(len(tokens))
        data = contents.encode("utf-8")
        doc_bytes += data
        byte_offsets.append(byte_offsets[-1] + len(data))
        if store_positions:
            seq = np.fromiter((intern(t) for t in tokens), dtype=np.int32, count=len(tokens))
            docterm_bytes += seq.tobytes()
            docterm_offsets.append(docterm_offsets[-1] + len(seq))
        counts = Counter(tokens)
        if counts:
            term_chunks.append(np.fromiter((intern(t) for t in counts), dtype=np.int64,
                                           count=len(counts)))
            doc_chunks.append(np.full(len(counts), ord_, dtype=np.int64))
            tf_chunks.append(np.fromiter(counts.values(), dtype=np.int64, count=len(counts)))
    if not docids:
        raise ValueError("add_documents got no documents")

    ops_dir = index_path / OPS_DIR
    ops_dir.mkdir(exist_ok=True)
    name = f"{_next_seq(index_path):08d}-add"
    tmp = ops_dir / f".tmp-{name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    (tmp / "docids.txt").write_text("\n".join(docids), encoding="utf-8")
    (tmp / "new_terms.txt").write_text("\n".join(new_terms), encoding="utf-8")
    (tmp / "docs.bin").write_bytes(bytes(doc_bytes))
    off = np.asarray(byte_offsets, dtype=np.int64)
    np.save(tmp / "doc_spans.npy", np.stack([off[:-1], off[1:]], axis=1))
    if store_positions:
        (tmp / "docterms.bin").write_bytes(bytes(docterm_bytes))
        toff = np.asarray(docterm_offsets, dtype=np.int64)
        np.save(tmp / "docterm_spans.npy", np.stack([toff[:-1], toff[1:]], axis=1))
    np.savez(
        tmp / "triples.npz",
        term_ids=(np.concatenate(term_chunks) if term_chunks else np.zeros(0, np.int64)),
        doc_local=(np.concatenate(doc_chunks) if doc_chunks else np.zeros(0, np.int64)),
        tfs=(np.concatenate(tf_chunks) if tf_chunks else np.zeros(0, np.int64)),
        doclens=np.asarray(doclens, dtype=np.int32),
        base_vocab_size=np.int64(base_vocab_size),
    )
    (tmp / "done").write_text("done")
    final = ops_dir / name
    os.rename(tmp, final)
    logger.info("buffered add segment %s: %d docs, %d new terms", name, len(docids),
                len(new_terms))
    return final


def write_delete_op(index_path: Path, docids) -> Path:
    with _WriterLock(index_path):
        return _write_delete_op_locked(index_path, docids)


def _write_delete_op_locked(index_path, docids):
    docids = list(docids)
    if not docids:
        raise ValueError("delete_documents got no docids")
    live = live_docids(index_path)
    missing = [d for d in docids if d not in live]
    if missing:
        raise ValueError(f"cannot delete docids not in the index: {missing[:10]}")
    if len(set(docids)) >= len(live):
        raise ValueError("refusing to delete every document in the index")
    ops_dir = index_path / OPS_DIR
    ops_dir.mkdir(exist_ok=True)
    name = f"{_next_seq(index_path):08d}-del"
    tmp = ops_dir / f".tmp-{name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    (tmp / "docids.txt").write_text("\n".join(docids), encoding="utf-8")
    (tmp / "done").write_text("done")
    final = ops_dir / name
    os.rename(tmp, final)
    logger.info("buffered delete op %s: %d docids", name, len(docids))
    return final


# --------------------------------------------------------------------- merge
def merge_pending(index_path: Path, save_artifacts, store_positions: bool) -> bool:
    """Replay pending ops onto the current generation and commit a new one.

    ``save_artifacts`` is TpuIndex._save_artifacts (kept as a parameter so the
    on-disk layout has exactly one owner). Returns True when a new generation
    was committed, False when nothing was pending.

    Host cost is O(total postings) — the same work Lucene pays in a full
    merge; tokenization (the dominant indexing cost) is never repeated.
    """
    if not pending_ops(index_path):
        return False
    try:
        lock = _WriterLock(index_path).__enter__()
    except IOError:
        # another process is writing/merging right now: serve the current
        # (point-in-time) generation instead of failing the reader — the next
        # access resolves whatever generation that writer commits
        logger.info("index at %s is being written by another process; "
                    "serving the current generation", index_path)
        return False
    try:
        return _merge_pending_locked(index_path, save_artifacts, store_positions)
    finally:
        lock.__exit__(None, None, None)


def _merge_pending_locked(index_path, save_artifacts, store_positions):
    ops = pending_ops(index_path)  # re-read under the lock
    if not ops:
        return False
    art = artifacts_dir(index_path)
    from capreolus_tpu_torch.index.tpu import build_prune_tables, canonical_postings_order

    npz = np.load(art / "postings.npz")
    term_offsets = npz["term_offsets"]
    base_doclens = npz["doclens"]
    vocab_list = _read_lines(art / "vocab.txt")
    docids = _read_lines(art / "docids.txt")
    doc_spans = [np.load(art / "doc_spans.npy")]
    docterm_spans = None
    if store_positions:
        docterm_spans = [np.load(art / "docterm_spans.npy")]

    # base triples recovered from the CSR (mmapped reads; one linear pass)
    df = np.diff(term_offsets)
    all_term = [np.repeat(np.arange(len(df), dtype=np.int64), df)]
    all_doc = [np.asarray(np.load(art / "postings_doc_ids.npy", mmap_mode="r"), dtype=np.int64)]
    all_tf = [np.asarray(np.load(art / "postings_tfs.npy", mmap_mode="r"), dtype=np.int64)]
    all_len = [np.asarray(base_doclens, dtype=np.int32)]

    docid_to_ord = {d: i for i, d in enumerate(docids)}
    alive = [True] * len(docids)
    sdir = store_dir(index_path, art)
    docs_bin = sdir / "docs.bin"
    docterms_bin = sdir / "docterms.bin"

    # merge journal: a failed attempt's doc-store appends are unreferenced
    # trailing bytes. Record the pre-append EOFs keyed by the target
    # generation; a retry truncates them back so failed merges never grow
    # the stores. If the journal's target generation already committed (a
    # crash in the tiny window between the CURRENT swap and journal cleanup),
    # the appended bytes ARE referenced and must not be touched.
    cur_gen = generation(index_path)
    gen = cur_gen + 1
    journal_fn = index_path / ".merge_journal.json"
    if journal_fn.exists():
        j = json.loads(journal_fn.read_text(encoding="utf-8"))
        if j.get("target_gen", 0) > cur_gen:
            for key, fn in (("docs_bin", docs_bin), ("docterms_bin", docterms_bin)):
                if key in j and fn.exists() and fn.stat().st_size > j[key]:
                    logger.warning("truncating %s to %d bytes (failed merge attempt)",
                                   fn, j[key])
                    os.truncate(fn, j[key])
        journal_fn.unlink()
    journal = {"target_gen": gen,
               "docs_bin": docs_bin.stat().st_size if docs_bin.exists() else 0}
    if store_positions:
        journal["docterms_bin"] = docterms_bin.stat().st_size if docterms_bin.exists() else 0
    journal_tmp = index_path / ".merge_journal.json.tmp"
    journal_tmp.write_text(json.dumps(journal), encoding="utf-8")
    os.replace(journal_tmp, journal_fn)

    for op in ops:
        op_ids = _read_lines(op / "docids.txt")
        if op.name.endswith("-del"):
            for d in op_ids:
                ord_ = docid_to_ord.get(d)
                # a docid both added and deleted while pending may miss; the
                # add op below never ran for it only if ops were hand-edited
                if ord_ is not None and alive[ord_]:
                    alive[ord_] = False
                    docid_to_ord.pop(d)
            continue
        tri = np.load(op / "triples.npz")
        base_ord = len(alive)
        all_term.append(tri["term_ids"])
        all_doc.append(tri["doc_local"] + base_ord)
        all_tf.append(tri["tfs"])
        all_len.append(tri["doclens"])
        new_terms_fn = op / "new_terms.txt"
        if new_terms_fn.stat().st_size:
            vocab_list.extend(_read_lines(new_terms_fn))
        # append the segment's doc bytes to the shared append-only stores;
        # old generations' spans point strictly before the old EOF
        seg_bytes = (op / "docs.bin").read_bytes()
        with open(docs_bin, "ab") as f:
            byte_base = f.tell()
            f.write(seg_bytes)
        doc_spans.append(np.load(op / "doc_spans.npy") + byte_base)
        if store_positions:
            seg_terms = (op / "docterms.bin").read_bytes()
            with open(docterms_bin, "ab") as f:
                term_base = f.tell() // 4  # spans are in int32 elements
                f.write(seg_terms)
            docterm_spans.append(np.load(op / "docterm_spans.npy") + term_base)
        for i, d in enumerate(op_ids):
            docid_to_ord[d] = base_ord + i
            alive.append(True)
        docids.extend(op_ids)

    # compact deletions: surviving docs keep first-added order, exactly the
    # ordinals a fresh build over the surviving corpus would assign
    alive = np.asarray(alive, dtype=bool)
    new_of_old = np.cumsum(alive, dtype=np.int64) - 1
    term_ids = np.concatenate(all_term)
    doc_ords = np.concatenate(all_doc)
    tfs = np.concatenate(all_tf)
    keep = alive[doc_ords]
    term_ids, doc_ords, tfs = term_ids[keep], new_of_old[doc_ords[keep]], tfs[keep]
    doclens = np.concatenate(all_len)[alive]
    doc_spans = np.concatenate(doc_spans, axis=0)[alive]
    if store_positions:
        docterm_spans = np.concatenate(docterm_spans, axis=0)[alive]
    docid_strings = [d for d, a in zip(docids, alive) if a]
    num_docs = len(docid_strings)
    num_terms = len(vocab_list)

    # identical post-tokenization pipeline to _create_index
    order, range_size = canonical_postings_order(term_ids, doc_ords, tfs, num_docs)
    term_ids, doc_ords, tfs = term_ids[order], doc_ords[order], tfs[order]
    csr = np.zeros(num_terms + 1, dtype=np.int64)
    np.cumsum(np.bincount(term_ids, minlength=num_terms), out=csr[1:])
    norm_doclens = quantize_lengths(doclens).astype(np.int32)
    prune_tables = build_prune_tables(csr, doc_ords.astype(np.int32), tfs.astype(np.int32),
                                      norm_doclens, num_docs, range_size=range_size)
    fwd_order = np.lexsort((term_ids, doc_ords))
    fwd_offsets = np.zeros(num_docs + 1, dtype=np.int64)
    np.cumsum(np.bincount(doc_ords, minlength=num_docs), out=fwd_offsets[1:])

    tmp = index_path / f".tmp-gen-{gen}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    save_artifacts(
        tmp,
        term_offsets=csr,
        doc_ids=doc_ords.astype(np.int32),
        tfs=tfs.astype(np.int32),
        doclens=doclens,
        norm_doclens=norm_doclens,
        fwd_offsets=fwd_offsets,
        fwd_term_ids=term_ids[fwd_order].astype(np.int32),
        fwd_tfs=tfs[fwd_order].astype(np.int32),
        docid_strings=docid_strings,
        vocab={t: i for i, t in enumerate(vocab_list)},
        prune_tables=prune_tables,
    )
    np.save(tmp / "doc_spans.npy", doc_spans)
    if store_positions:
        np.save(tmp / "docterm_spans.npy", docterm_spans)
    consumed = sorted(_consumed_ops(art) | {op.name for op in ops})
    (tmp / "consumed_ops.json").write_text(json.dumps(consumed), encoding="utf-8")
    if sdir != index_path:  # carry the compacted-store pointer forward
        (tmp / "store_name.txt").write_text(sdir.name, encoding="utf-8")

    gen_dir = index_path / f"gen-{gen}"
    if gen_dir.exists():  # leftover from a crashed pre-commit attempt
        shutil.rmtree(gen_dir)
    os.rename(tmp, gen_dir)
    # the commit point: one atomic pointer swap (Lucene's segments_N rename)
    current_tmp = index_path / ".CURRENT.tmp"
    current_tmp.write_text(gen_dir.name, encoding="utf-8")
    os.replace(current_tmp, index_path / "CURRENT")
    journal_fn.unlink(missing_ok=True)  # appended bytes are now referenced
    # cleanup is best-effort; consumed_ops.json guards against double-apply
    for op in ops:
        shutil.rmtree(op, ignore_errors=True)
    # deferred deletion policy (Lucene KeepOnlyLastCommit, softened by one):
    # keep generation N-1 so in-flight readers — including ones that lazily
    # materialize tile artifacts like exact_dl.npy on first QL/DFR use —
    # stay valid across one refresh; delete N-2 and older.
    for old in index_path.glob("gen-*"):
        try:
            n = int(old.name.split("-", 1)[1])
        except ValueError:
            continue
        if old.is_dir() and n <= gen - 2:
            shutil.rmtree(old, ignore_errors=True)
    logger.info("committed index generation %d: %d docs, %d terms, %d postings (%d ops merged)",
                gen, num_docs, num_terms, len(tfs), len(ops))
    return True


# ---------------------------------------------------------------- compaction
def compact_doc_stores(index_path: Path, store_positions: bool) -> int:
    """Offline doc-store compaction (Lucene forceMerge's stored-fields rewrite):
    the shared docs.bin/docterms.bin are append-only, so deleted documents'
    bytes and failed-merge orphans accumulate. This rewrites them with only
    the bytes the CURRENT generation references, into a fresh versioned
    ``store-K/`` dir, and commits a new generation whose unchanged postings
    artifacts are HARDLINKED (zero copy) — the swap is the same atomic CURRENT
    rename merges use, so a crash leaves the index serving the old store.
    OFFLINE utility: older generations and the old store are deleted, so
    in-flight point-in-time readers of previous generations must be closed.
    Returns bytes reclaimed."""
    with _WriterLock(index_path):
        art = artifacts_dir(index_path)
        old_store = store_dir(index_path, art)
        spans = np.load(art / "doc_spans.npy")
        old_docs = np.memmap(old_store / "docs.bin", dtype=np.uint8, mode="r")
        old_size = (old_store / "docs.bin").stat().st_size
        has_terms = store_positions and (old_store / "docterms.bin").exists()
        if has_terms:
            old_size += (old_store / "docterms.bin").stat().st_size

        existing = [int(d.name.split("-", 1)[1]) for d in index_path.glob("store-*") if d.is_dir()]
        K = max(existing, default=0) + 1
        tmp_store = index_path / f".tmp-store-{K}"
        if tmp_store.exists():
            shutil.rmtree(tmp_store)
        tmp_store.mkdir()

        new_offsets = [0]
        with open(tmp_store / "docs.bin", "wb") as f:
            for lo, hi in spans:
                f.write(old_docs[lo:hi].tobytes())
                new_offsets.append(new_offsets[-1] + int(hi - lo))
        off = np.asarray(new_offsets, dtype=np.int64)
        new_spans = np.stack([off[:-1], off[1:]], axis=1)
        new_term_spans = None
        if has_terms:
            tspans = np.load(art / "docterm_spans.npy")  # int32-element offsets
            old_terms = np.memmap(old_store / "docterms.bin", dtype=np.int32, mode="r")
            toffsets = [0]
            with open(tmp_store / "docterms.bin", "wb") as f:
                for lo, hi in tspans:
                    f.write(old_terms[lo:hi].tobytes())
                    toffsets.append(toffsets[-1] + int(hi - lo))
            toff = np.asarray(toffsets, dtype=np.int64)
            new_term_spans = np.stack([toff[:-1], toff[1:]], axis=1)
        os.rename(tmp_store, index_path / f"store-{K}")

        gen = generation(index_path) + 1
        tmp = index_path / f".tmp-gen-{gen}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        skip = {"doc_spans.npy", "docterm_spans.npy", "store_name.txt"}
        for fn in art.iterdir():
            if fn.name in skip or fn.name.startswith((".", "gen-", "store-")) or fn.name in (
                    OPS_DIR, "CURRENT", "write.lock", "docs.bin", "docterms.bin"):
                continue
            if fn.is_dir():
                if fn.name == "tiles":  # keep the warm tile cache, zero-copy
                    (tmp / "tiles").mkdir()
                    for t in fn.iterdir():
                        if t.is_file():
                            os.link(t, tmp / "tiles" / t.name)
                continue
            os.link(fn, tmp / fn.name)
        np.save(tmp / "doc_spans.npy", new_spans)
        if new_term_spans is not None:
            np.save(tmp / "docterm_spans.npy", new_term_spans)
        (tmp / "store_name.txt").write_text(f"store-{K}", encoding="utf-8")

        gen_dir = index_path / f"gen-{gen}"
        if gen_dir.exists():
            shutil.rmtree(gen_dir)
        os.rename(tmp, gen_dir)
        current_tmp = index_path / ".CURRENT.tmp"
        current_tmp.write_text(gen_dir.name, encoding="utf-8")
        os.replace(current_tmp, index_path / "CURRENT")

        # reclaim: old generations' spans dangle into the old store — drop both
        for old in index_path.glob("gen-*"):
            try:
                n = int(old.name.split("-", 1)[1])
            except ValueError:
                continue
            if old.is_dir() and n < gen:
                shutil.rmtree(old, ignore_errors=True)
        for old in index_path.glob("store-*"):
            if old.is_dir() and old != index_path / f"store-{K}":
                shutil.rmtree(old, ignore_errors=True)
        for name in ("docs.bin", "docterms.bin"):
            (index_path / name).unlink(missing_ok=True)
        new_size = (index_path / f"store-{K}" / "docs.bin").stat().st_size
        if has_terms:
            new_size += (index_path / f"store-{K}" / "docterms.bin").stat().st_size
        logger.info("compacted doc stores at %s: %d -> %d bytes (gen %d, store-%d)",
                    index_path, old_size, new_size, gen, K)
        return old_size - new_size
