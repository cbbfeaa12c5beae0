"""Inverted index with Lucene-compatible statistics (the JAX package's
``index/tpu.py``, registered under the same name ``tpu`` so configs carry over).

    host tokenize -> (term, doc, tf) triples -> canonical sort -> CSR postings,
    per-doc length norms (Lucene SmallFloat), and a docid -> contents store.

The build produces the same vocab, docid order, doclens, norm doclens, term
offsets, postings order and forward index (per-doc term ids and tfs, the
feedback searchers' input) as the JAX build, and with ``storepositions`` the
same per-doc token-id sequences (SDM's input), the same internal ordinals
under ``docreorder`` (``terms``: cluster by rarest term; ``bp``: recursive
graph bisection, ``index/reorder.py``) and the same block-max prune tables
(``build_prune_tables``, read by the scoring engine's exact pruning).
Incremental writes (``add_documents``, ``delete_documents``, ``refresh``,
``compact_doc_stores``; ``index/segments.py``) buffer segment ops and merge
them into generation directories ``gen-N/`` whose artifacts equal a fresh
build over the surviving documents; ``_loaded_generation`` names the
generation the loaded artifacts came from, and the engines' caches key on it.

Artifacts written to the cache path:
  index/vocab.txt          one term per line (line number = term id)
  index/docids.txt         external docid per internal doc ordinal
  index/postings.npz       CSR offsets, doc lengths, forward-index offsets and
                           the prune tables (``pt_*``)
  index/postings_*.npy     doc_ids, tfs, fwd_term_ids and fwd_tfs, memory-mapped
                           at load when index.mmap
  index/docs.bin           concatenated utf-8 contents
  index/doc_spans.npy      int64 [N, 2] byte spans into docs.bin per internal ordinal
  index/docterms.bin       (storepositions) concatenated int32 token ids
  index/docterm_spans.npy  (storepositions) int64 [N, 2] spans into docterms.bin
  index/tiles/             (index.mmap) the scoring engine's tile payloads on disk
                           and its settled pruning verdicts (searcher/scoring.py)
  index/CURRENT, gen-N/    after an incremental merge: the generation directory
                           holding the artifacts above (docs.bin and docterms.bin
                           stay shared and append-only), and its pointer
"""

from __future__ import annotations

import contextlib
import math
import shutil
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from itertools import islice

import numpy as np

from capreolus_tpu_torch.analysis import get_analyzer
from capreolus_tpu_torch.core import ConfigError, ConfigOption, constants
from capreolus_tpu_torch.index import Index
from capreolus_tpu_torch.index.smallfloat import quantize_lengths
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

# v2: the forward index (fwd_*) joined the artifacts; v3: the block-max prune
# tables (pt_*) joined them
LAYOUT_VERSION = 3
ANALYZE_CHUNK_DOCS = 1024  # documents handed to the analyzer threads at once


def reorder_doc_ids(term_ids, doc_ords, num_docs, num_terms):
    """Cluster-by-rare-term doc-id permutation (a light version of the docid
    reordering modern engines pair with block-max pruning, cf. Dhulipala et al.
    2016 BP reordering): docs sharing their rarest term become neighbors, so
    per-(term, doc-range) spans concentrate and range bounds sharpen. External
    docids are unaffected — only internal ordinals move (Lucene's internal ids
    are likewise an indexing-order artifact). Returns old->new [N] int64."""
    df = np.bincount(term_ids, minlength=num_terms).astype(np.int64)
    # per-doc signature: the (df, term) pair of its rarest term, packed into one
    # int64 key so a single np.minimum.at computes the min per doc
    key = df[term_ids] * num_terms + term_ids
    sig = np.full(num_docs, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(sig, doc_ords, key)
    new_of_old = np.empty(num_docs, dtype=np.int64)
    new_of_old[np.lexsort((np.arange(num_docs), sig))] = np.arange(num_docs)
    return new_of_old


# terms with df below this get no per-range tables. Default 1 = tables for
# EVERY term: a term absent from the tables must be charged to every range's
# bound, which measured out to defeat pruning entirely (a single table-less
# query term inflates all U(R) above theta). Entries are host-side metadata
# (like Lucene's skip files), bounded by the number of distinct (term, range)
# pairs — ~33% of postings count on bench.py's 200k-doc corpus.
HEAVY_DF = 1


def pick_range_size(num_docs: int) -> int:
    """Doc-range granularity for block-max pruning: a power of two >= 64 chosen
    so the corpus has at most ~4096 ranges (keeps per-query [Q, R] bound
    matrices and per-term tables small while staying fine enough to prune)."""
    size = 64
    while num_docs // size > 4096:
        size *= 2
    return size


def canonical_postings_order(term_ids, doc_ords, tfs, num_docs):
    """Sort key for the canonical postings layout: (term, doc-range, impact desc,
    doc asc), the JAX package's layout (its block-max pruner skips whole
    (term, range) spans, and its early termination reads high-impact prefixes)."""
    range_size = pick_range_size(num_docs)
    order = np.lexsort((doc_ords, -tfs, doc_ords // range_size, term_ids))
    return order, range_size


def build_prune_tables(term_offsets, doc_ids, tfs, norm_doclens, num_docs,
                       range_size=None, heavy_df=HEAVY_DF):
    """Block-max side tables for exact dynamic pruning (the analog of Lucene's
    per-block skip data + impact metadata, which WAND/MaxScore consume); the
    JAX package's tables, array for array. Postings MUST be in canonical
    (term, range, impact desc) order.

    Returns a dict of arrays:
      range_size            scalar
      rt_offsets [V+1]      CSR over table entries per term (empty for light terms)
      rt_range   [E]        range id of each (term, nonempty-range) span
      rt_start   [E]        posting offset where the span begins
      rt_end     [E]        posting offset where the span ends
      rt_max_tf  [E]        max term frequency within the span (= first posting's,
                            thanks to the impact sort within ranges)
      rt_min_dl  [E]        min quantized doc length within the span
      gmax_tf    [V]        per-term global max tf (light-term bound)
      gmin_dl    [V]        per-term global min quantized dl
    """
    if range_size is None:
        range_size = pick_range_size(num_docs)
    num_terms = len(term_offsets) - 1
    nnz = len(doc_ids)
    dl_of_posting = norm_doclens.astype(np.float32)[doc_ids]
    tfs_f = tfs.astype(np.float32)

    # per-term global bounds (all terms)
    gmax_tf = np.zeros(num_terms, np.float32)
    gmin_dl = np.full(num_terms, np.float32(np.inf))
    starts = term_offsets[:-1]
    nonempty = term_offsets[1:] > starts
    if nnz:
        gmax_tf[nonempty] = np.maximum.reduceat(tfs_f, starts[nonempty])
        gmin_dl[nonempty] = np.minimum.reduceat(dl_of_posting, starts[nonempty])

    # heavy terms: one entry per (term, nonempty range)
    df = np.diff(term_offsets)
    term_of_posting = np.repeat(np.arange(num_terms, dtype=np.int64), df)
    heavy_posting = df[term_of_posting] >= heavy_df
    ranges = (doc_ids.astype(np.int64) // range_size)
    key = np.where(heavy_posting, term_of_posting * (num_docs // range_size + 2) + ranges, -1)
    # spans are contiguous runs of equal key (postings already range-major)
    if nnz:
        is_start = np.concatenate([[True], key[1:] != key[:-1]]) & (key >= 0)
    else:
        is_start = np.zeros(0, bool)
    entry_start = np.flatnonzero(is_start)
    E = len(entry_start)
    rt_start = entry_start.astype(np.int64)
    # span end: next span start within the same term, else the term's end
    entry_term = term_of_posting[entry_start] if E else np.zeros(0, np.int64)
    rt_end = np.empty(E, np.int64)
    if E:
        rt_end[:-1] = rt_start[1:]
        rt_end[-1] = term_offsets[entry_term[-1] + 1]
        # fix ends at term boundaries
        term_change = np.flatnonzero(entry_term[1:] != entry_term[:-1])
        rt_end[term_change] = term_offsets[entry_term[term_change] + 1]
    rt_range = ranges[entry_start].astype(np.int32) if E else np.zeros(0, np.int32)
    rt_max_tf = tfs_f[entry_start] if E else np.zeros(0, np.float32)  # impact sort: first = max
    # reduceat segments run start->next start; at term boundaries they may spill
    # into the next (light) term's postings, which can only SHRINK the min ->
    # a larger (still valid) upper bound. Exactness is unaffected.
    rt_min_dl = (np.minimum.reduceat(dl_of_posting, rt_start) if E else np.zeros(0, np.float32))
    rt_offsets = np.zeros(num_terms + 1, np.int64)
    if E:
        np.cumsum(np.bincount(entry_term, minlength=num_terms), out=rt_offsets[1:])
    return {
        "range_size": np.int64(range_size),
        "rt_offsets": rt_offsets,
        "rt_range": rt_range,
        "rt_start": rt_start,
        "rt_end": rt_end,
        "rt_max_tf": rt_max_tf,
        "rt_min_dl": rt_min_dl.astype(np.float32),
        "gmax_tf": gmax_tf,
        "gmin_dl": gmin_dl,
    }




class IndexData:
    """In-memory (host) view of the index artifacts; numpy arrays, ready to be
    placed on the device by the scoring engine."""

    def __init__(self, term_offsets, doc_ids, tfs, doclens, norm_doclens, docid_strings, vocab,
                 fwd_offsets=None, fwd_term_ids=None, fwd_tfs=None, prune_tables=None,
                 tile_dir=None):
        self.term_offsets = term_offsets  # int64 [V+1]
        self.doc_ids = doc_ids  # int32 [nnz], canonical (range, impact desc) within each term
        self.tfs = tfs  # int32 [nnz]
        self.doclens = doclens  # int32 [N] exact lengths
        self.norm_doclens = norm_doclens  # int32 [N] Lucene-quantized lengths
        self.docid_strings = docid_strings  # list[str] length N
        self.vocab = vocab  # dict term -> term id
        self.fwd_offsets = fwd_offsets  # int64 [N+1]
        self.fwd_term_ids = fwd_term_ids  # int32 [nnz] sorted by (doc, term)
        self.fwd_tfs = fwd_tfs  # int32 [nnz]
        # block-max side tables for exact dynamic pruning (build_prune_tables);
        # None disables pruning (e.g. synthetic fixtures built in another order)
        self.prune_tables = prune_tables
        # when set (disk-resident index), the scoring engine keeps its tile
        # payloads on disk here too instead of padded host-RAM copies
        self.tile_dir = tile_dir
        # where the scoring engine persists settled pruning verdicts when there
        # is no tile_dir (e.g. cached synthetic corpora)
        self.verdict_path = None

    @property
    def num_docs(self):
        return len(self.doclens)

    @property
    def num_terms(self):
        return len(self.term_offsets) - 1

    @property
    def total_term_count(self):
        return int(self.doclens.sum())

    @property
    def avgdl(self):
        return self.total_term_count / max(1, self.num_docs)

    def df(self, term_id):
        return int(self.term_offsets[term_id + 1] - self.term_offsets[term_id])

    @property
    def df_array(self):
        return np.diff(self.term_offsets).astype(np.int32)

    @property
    def cf_array(self):
        cf = np.zeros(self.num_terms, dtype=np.int64)
        np.add.at(cf, np.repeat(np.arange(self.num_terms), np.diff(self.term_offsets)), self.tfs)
        return cf

    def postings(self, term_id):
        s, e = self.term_offsets[term_id], self.term_offsets[term_id + 1]
        return self.doc_ids[s:e], self.tfs[s:e]


@Index.register
class TpuIndex(Index):
    """Inverted index with Lucene-compatible statistics; options ``indexstops``
    and ``stemmer`` as in Anserini."""

    module_name = "tpu"
    config_spec = [
        ConfigOption("indexstops", False, "index stopwords (True) or remove them (False)"),
        ConfigOption("stemmer", "porter", "stemmer: porter, krovetz, or none"),
        ConfigOption("storepositions", False, "store the positional forward index "
                     "(per-doc token-id sequences; required by SDM)"),
        ConfigOption("docreorder", "none", "internal doc-ordinal reordering for posting locality: "
                     "none, 'terms' (cheap cluster-by-rarest-term), or 'bp' (recursive graph "
                     "bisection, Dhulipala et al. 2016, index/reorder.py). External docids and "
                     "scores are unchanged; score-tie ORDER follows internal ids, like Lucene's"),
        ConfigOption("mmap", True, "memory-map the postings arrays (and keep the scoring engine's tile "
                     "payloads on disk beside them); False loads them into RAM"),
    ]
    config_keys_not_in_path = ["mmap"]  # identical artifacts either way

    def build(self):
        try:
            self._analyzer()
        except ValueError as e:
            raise ConfigError(f"index.stemmer: {e}") from None
        if (self.config["docreorder"] or "none") not in ("none", "terms", "bp"):  # config casts "none" -> None
            raise ConfigError(f"index.docreorder must be none, terms, or bp, got {self.config['docreorder']!r}")

    def _analyzer(self):
        return get_analyzer(stemmer=self.config["stemmer"], keep_stopwords=self.config["indexstops"])

    # ------------------------------------------------------------------ build
    def _create_index(self):
        analyzer = self._analyzer()
        index_path = self.get_index_path()
        index_path.mkdir(parents=True, exist_ok=True)

        logger.info("building inverted index at %s", index_path)
        vocab: dict = {}
        docid_strings = []
        doclens = []
        term_chunks, doc_chunks, tf_chunks = [], [], []
        doc_byte_offsets = [0]
        store_positions = self.config["storepositions"]
        docterm_offsets = [0]
        doc_ord = 0
        doc_iter = self.collection.get_doc_iterator()
        # the analyzer runs on a thread pool over chunks of documents: the native
        # analyzer releases the GIL inside its ctypes call, so the threads overlap;
        # pool.map keeps document order, so term ids are the serial build's
        with open(index_path / "docs.bin", "wb") as docs_bin, \
                open(index_path / "docterms.bin", "wb") if store_positions else contextlib.nullcontext() as docterms_bin, \
                ThreadPoolExecutor(max_workers=max(1, constants["MAX_THREADS"])) as pool:
            while chunk := list(islice(doc_iter, ANALYZE_CHUNK_DOCS)):
                token_lists = pool.map(analyzer.analyze, (contents for _, contents in chunk))
                for (docid, contents), tokens in zip(chunk, token_lists):
                    counts = Counter(tokens)
                    docid_strings.append(docid)
                    doclens.append(len(tokens))
                    data = contents.encode("utf-8")
                    docs_bin.write(data)
                    doc_byte_offsets.append(doc_byte_offsets[-1] + len(data))
                    if store_positions:
                        # term ids in token order: the same first-occurrence ids as the counts below
                        seq = np.fromiter((vocab.setdefault(t, len(vocab)) for t in tokens),
                                          dtype=np.int32, count=len(tokens))
                        docterms_bin.write(seq.tobytes())
                        docterm_offsets.append(docterm_offsets[-1] + len(seq))
                    if counts:
                        tids = np.fromiter(
                            (vocab.setdefault(t, len(vocab)) for t in counts), dtype=np.int64, count=len(counts)
                        )
                        term_chunks.append(tids)
                        doc_chunks.append(np.full(len(counts), doc_ord, dtype=np.int64))
                        tf_chunks.append(np.fromiter(counts.values(), dtype=np.int64, count=len(counts)))
                    doc_ord += 1
                    if doc_ord % 100000 == 0:
                        logger.info("tokenized %d docs (%d terms so far)", doc_ord, len(vocab))

        num_docs = len(docid_strings)
        if num_docs == 0:
            raise IOError(f"collection {self.collection.module_name} yielded no documents")

        term_ids = np.concatenate(term_chunks) if term_chunks else np.zeros(0, dtype=np.int64)
        doc_ords = np.concatenate(doc_chunks) if doc_chunks else np.zeros(0, dtype=np.int64)
        tfs = np.concatenate(tf_chunks) if tf_chunks else np.zeros(0, dtype=np.int64)
        del term_chunks, doc_chunks, tf_chunks

        # per-ordinal spans into docs.bin / docterms.bin (in write order for now)
        off = np.asarray(doc_byte_offsets, dtype=np.int64)
        doc_spans = np.stack([off[:-1], off[1:]], axis=1)
        docterm_spans = None
        if store_positions:
            toff = np.asarray(docterm_offsets, dtype=np.int64)
            docterm_spans = np.stack([toff[:-1], toff[1:]], axis=1)

        reorder_mode = self.config["docreorder"] or "none"  # config casts "none" -> None
        if reorder_mode != "none" and len(term_ids):
            # reorder internal ordinals for posting locality; the spans, lengths
            # and external docids are permuted with them
            if reorder_mode == "bp":
                from capreolus_tpu_torch.index.reorder import bp_reorder

                logger.info("docreorder=bp: recursive graph bisection over %d postings", len(term_ids))
                new_of_old = bp_reorder(term_ids, doc_ords, num_docs)
            else:
                new_of_old = reorder_doc_ids(term_ids, doc_ords, num_docs, len(vocab))
            doc_ords = new_of_old[doc_ords]
            inv = np.argsort(new_of_old)  # new ordinal -> old ordinal
            docid_strings = [docid_strings[i] for i in inv]
            doclens = [doclens[i] for i in inv]
            doc_spans = doc_spans[inv]
            if docterm_spans is not None:
                docterm_spans = docterm_spans[inv]
        np.save(index_path / "doc_spans.npy", doc_spans)
        if docterm_spans is not None:
            np.save(index_path / "docterm_spans.npy", docterm_spans)

        order, range_size = canonical_postings_order(term_ids, doc_ords, tfs, num_docs)
        term_ids, doc_ords, tfs = term_ids[order], doc_ords[order], tfs[order]

        num_terms = len(vocab)
        term_offsets = np.zeros(num_terms + 1, dtype=np.int64)
        np.cumsum(np.bincount(term_ids, minlength=num_terms), out=term_offsets[1:])

        doclens = np.asarray(doclens, dtype=np.int32)
        norm_doclens = quantize_lengths(doclens).astype(np.int32)
        prune_tables = build_prune_tables(term_offsets, doc_ords.astype(np.int32), tfs.astype(np.int32),
                                          norm_doclens, num_docs, range_size=range_size)

        # forward index: the same triples sorted by (doc, term)
        fwd_order = np.lexsort((term_ids, doc_ords))
        fwd_offsets = np.zeros(num_docs + 1, dtype=np.int64)
        np.cumsum(np.bincount(doc_ords, minlength=num_docs), out=fwd_offsets[1:])

        self._save_artifacts(
            index_path, term_offsets=term_offsets, doc_ids=doc_ords.astype(np.int32), tfs=tfs.astype(np.int32),
            doclens=doclens, norm_doclens=norm_doclens, fwd_offsets=fwd_offsets,
            fwd_term_ids=term_ids[fwd_order].astype(np.int32), fwd_tfs=tfs[fwd_order].astype(np.int32),
            docid_strings=docid_strings, vocab=vocab, prune_tables=prune_tables)
        logger.info("index built: %d docs, %d terms, %d postings, avgdl %.2f",
                    num_docs, num_terms, len(tfs), doclens.mean())

    @staticmethod
    def _save_artifacts(index_path, *, term_offsets, doc_ids, tfs, doclens, norm_doclens, fwd_offsets,
                        fwd_term_ids, fwd_tfs, docid_strings, vocab, prune_tables):
        """Write one generation's artifacts (the build's and every merge's: the
        layout has one owner)."""
        terms_by_id = sorted(vocab, key=vocab.get)
        (index_path / "vocab.txt").write_text("\n".join(terms_by_id), encoding="utf-8")
        (index_path / "docids.txt").write_text("\n".join(docid_strings), encoding="utf-8")
        np.save(index_path / "postings_doc_ids.npy", doc_ids)
        np.save(index_path / "postings_tfs.npy", tfs)
        np.save(index_path / "postings_fwd_term_ids.npy", fwd_term_ids)
        np.save(index_path / "postings_fwd_tfs.npy", fwd_tfs)
        np.savez(index_path / "postings.npz", layout_version=np.int64(LAYOUT_VERSION),
                 term_offsets=term_offsets, doclens=doclens, norm_doclens=norm_doclens,
                 fwd_offsets=fwd_offsets, **{f"pt_{k}": v for k, v in prune_tables.items()})

    # ------------------------------------------------------------------ incremental writes
    def _check_incremental_supported(self):
        if (self.config["docreorder"] or "none") != "none":
            raise ConfigError(
                "incremental indexing requires index.docreorder=none (reordered "
                "internal ordinals would have to be recomputed on every merge); "
                "rebuild the index with docreorder=none to use add/delete_documents"
            )

    def add_documents(self, docs):
        """Append documents, an iterable of (docid, contents), to the built
        index (Lucene's IndexWriter.addDocuments): tokenized once and buffered
        as an on-disk segment op; the next ``.data`` access (or ``refresh()``)
        merges the pending ops into a new generation whose artifacts equal a
        fresh build over the combined corpus. Returns the op's directory."""
        from capreolus_tpu_torch.index import segments

        self._check_incremental_supported()
        self.create_index()
        op = segments.write_add_op(self.get_index_path(), docs, self._analyzer(), self.config["storepositions"])
        self._dirty = True
        return op

    def delete_documents(self, docids):
        """Buffer deletion tombstones for external docids (Lucene's
        IndexWriter.deleteDocuments), applied and compacted at the next merge."""
        from capreolus_tpu_torch.index import segments

        self._check_incremental_supported()
        self.create_index()
        op = segments.write_delete_op(self.get_index_path(), docids)
        self._dirty = True
        return op

    def refresh(self):
        """Merge pending ops (if any) and re-open at the newest generation;
        returns the current generation number."""
        self._dirty = True
        self._load()
        return self.generation

    @property
    def generation(self):
        """Commit generation of the artifacts on disk now (0: the original
        build). Engine caches key on ``_loaded_generation`` instead, the
        generation the loaded artifacts came from."""
        from capreolus_tpu_torch.index import segments

        return segments.generation(self.get_index_path())

    def compact_doc_stores(self):
        """Reclaim deleted documents' bytes from the append-only doc stores
        (offline; ``segments.compact_doc_stores``). Returns the bytes reclaimed."""
        from capreolus_tpu_torch.index import segments

        self._check_incremental_supported()
        self.create_index()
        reclaimed = segments.compact_doc_stores(self.get_index_path(), self.config["storepositions"])
        self._dirty = True
        return reclaimed

    # ------------------------------------------------------------------ load/access
    def _load(self):
        if getattr(self, "_data", None) is not None and not getattr(self, "_dirty", False):
            return self._data
        from capreolus_tpu_torch.index import segments

        self.create_index()
        index_path = self.get_index_path()
        if segments.pending_ops(index_path):
            self._check_incremental_supported()
            segments.merge_pending(index_path, self._save_artifacts, self.config["storepositions"])
        self._dirty = False
        self._data = None
        art = segments.artifacts_dir(index_path)
        mmap_mode = "r" if self.config["mmap"] else None
        with np.load(art / "postings.npz") as npz:
            found = int(npz["layout_version"])
        if found != LAYOUT_VERSION:
            if art != index_path:
                # a generation holds incrementally added docs that a rebuild from the collection would drop
                raise RuntimeError(f"index generation at {art} uses postings layout v{found} (current "
                                   f"v{LAYOUT_VERSION}) and contains incrementally added documents; rebuild it "
                                   f"by re-indexing and re-adding")
            # a cache from an older layout: rebuild it in place (the done file lives inside index_path)
            logger.warning("index at %s has layout v%d (current v%d); rebuilding", index_path, found, LAYOUT_VERSION)
            shutil.rmtree(index_path, ignore_errors=True)
            self.create_index()
        with np.load(art / "postings.npz") as npz:
            term_offsets, doclens, norm_doclens = npz["term_offsets"], npz["doclens"], npz["norm_doclens"]
            fwd_offsets = npz["fwd_offsets"]
            prune_tables = {k[3:]: npz[k] for k in npz.files if k.startswith("pt_")} or None
        vocab_list = (art / "vocab.txt").read_text(encoding="utf-8").splitlines()
        docid_strings = (art / "docids.txt").read_text(encoding="utf-8").splitlines()
        self._data = IndexData(
            term_offsets=term_offsets,
            doc_ids=np.load(art / "postings_doc_ids.npy", mmap_mode=mmap_mode),
            tfs=np.load(art / "postings_tfs.npy", mmap_mode=mmap_mode),
            doclens=doclens,
            norm_doclens=norm_doclens,
            docid_strings=docid_strings,
            vocab={t: i for i, t in enumerate(vocab_list)},
            fwd_offsets=fwd_offsets,
            fwd_term_ids=np.load(art / "postings_fwd_term_ids.npy", mmap_mode=mmap_mode),
            fwd_tfs=np.load(art / "postings_fwd_tfs.npy", mmap_mode=mmap_mode),
            prune_tables=prune_tables,
            # per generation: a tile payload or a pruning verdict of one generation never serves another
            tile_dir=(art / "tiles") if mmap_mode else None,
        )
        self._docid_to_ord = {d: i for i, d in enumerate(docid_strings)}
        self._doc_spans = np.load(art / "doc_spans.npy")
        sdir = segments.store_dir(index_path, art)
        self._docs_bin = np.memmap(sdir / "docs.bin", dtype=np.uint8, mode="r")
        self._docterm_spans = None
        if (art / "docterm_spans.npy").exists():
            self._docterm_spans = np.load(art / "docterm_spans.npy")
            # np.memmap refuses an empty file (a corpus whose docs all analyze to nothing)
            self._docterms_bin = (np.memmap(sdir / "docterms.bin", dtype=np.int32, mode="r")
                                  if (sdir / "docterms.bin").stat().st_size else np.zeros(0, np.int32))
        # read from the resolved directory, never from CURRENT again: another
        # writer may have committed since, and a cache keyed on a fresh read
        # would hold this generation's data under the next one's number
        self._loaded_generation = 0 if art == index_path else int(art.name.split("-", 1)[1])
        return self._data

    @property
    def data(self) -> IndexData:
        return self._load()

    def get_doc(self, docid):
        self._load()
        try:
            ord_ = self._docid_to_ord[docid]
        except KeyError:
            return None
        s, e = self._doc_spans[ord_]
        return bytes(self._docs_bin[s:e]).decode("utf-8")

    def get_df(self, term):
        """Document frequency of an already-analyzed term."""
        data = self._load()
        tid = data.vocab.get(term)
        return 0 if tid is None else data.df(tid)

    def get_idf(self, term):
        """BM25 idf log(1 + (N - df + 0.5) / (df + 0.5)), 0 for unseen terms."""
        df = self.get_df(term)
        if df == 0:
            return 0.0
        n = self._load().num_docs
        return math.log(1 + (n - df + 0.5) / (df + 0.5))

    def get_doc_term_ids(self, doc_ord: int):
        """Positional forward index: the doc's analyzed token-id sequence
        (requires storepositions=True)."""
        self._load()
        if self._docterm_spans is None:
            raise ValueError("index was built without storepositions=True")
        s, e = self._docterm_spans[doc_ord]
        return np.asarray(self._docterms_bin[s:e])

    def analyze(self, text):
        return self._analyzer().analyze(text)
