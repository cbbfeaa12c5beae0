"""Inverted index with Lucene-compatible statistics (the JAX package's
``index/tpu.py``, registered under the same name ``tpu`` so configs carry over).

    host tokenize -> (term, doc, tf) triples -> canonical sort -> CSR postings,
    per-doc length norms (Lucene SmallFloat), and a docid -> contents store.

The build produces the same vocab, docid order, doclens, norm doclens, term
offsets, postings order and forward index (per-doc term ids and tfs, the
feedback searchers' input) as the JAX build, and with ``storepositions`` the
same per-doc token-id sequences (SDM's input). Not ported yet: docid
reordering (``docreorder``, which raises ``ConfigError``), block-max prune
tables and incremental segments.

Artifacts written to the cache path:
  index/vocab.txt          one term per line (line number = term id)
  index/docids.txt         external docid per internal doc ordinal
  index/postings.npz       CSR offsets, doc lengths, forward-index offsets
  index/postings_*.npy     doc_ids, tfs, fwd_term_ids and fwd_tfs, memory-mapped
                           at load when index.mmap
  index/docs.bin           concatenated utf-8 contents
  index/doc_spans.npy      int64 [N, 2] byte spans into docs.bin per internal ordinal
  index/docterms.bin       (storepositions) concatenated int32 token ids
  index/docterm_spans.npy  (storepositions) int64 [N, 2] spans into docterms.bin
"""

from __future__ import annotations

import contextlib
import math
import shutil
from collections import Counter

import numpy as np

from capreolus_tpu_torch.analysis import get_analyzer
from capreolus_tpu_torch.core import ConfigError, ConfigOption
from capreolus_tpu_torch.index import Index
from capreolus_tpu_torch.index.smallfloat import quantize_lengths
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

LAYOUT_VERSION = 2  # v2: the forward index (fwd_*) joined the artifacts


def pick_range_size(num_docs: int) -> int:
    """Doc-range granularity of the canonical postings order: a power of two
    >= 64 chosen so the corpus has at most ~4096 ranges."""
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


class IndexData:
    """In-memory (host) view of the index artifacts; numpy arrays, ready to be
    placed on the device by the scoring engine."""

    def __init__(self, term_offsets, doc_ids, tfs, doclens, norm_doclens, docid_strings, vocab,
                 fwd_offsets=None, fwd_term_ids=None, fwd_tfs=None):
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


@Index.register
class TpuIndex(Index):
    """Inverted index with Lucene-compatible statistics; options ``indexstops``
    and ``stemmer`` as in Anserini."""

    module_name = "tpu"
    config_spec = [
        ConfigOption("indexstops", False, "index stopwords (True) or remove them (False)"),
        ConfigOption("stemmer", "porter", "stemmer: porter or none"),
        ConfigOption("storepositions", False, "store the positional forward index "
                     "(per-doc token-id sequences; required by SDM)"),
        ConfigOption("docreorder", "none", "internal doc-ordinal reordering (not ported; must be none)"),
        ConfigOption("mmap", True, "memory-map the postings arrays; False loads them into RAM"),
    ]
    config_keys_not_in_path = ["mmap"]  # identical artifacts either way

    def build(self):
        try:
            self._analyzer()
        except ValueError as e:
            raise ConfigError(f"index.stemmer: {e}") from None
        if (self.config["docreorder"] or "none") != "none":  # config casts "none" -> None
            raise ConfigError(f"index.docreorder={self.config['docreorder']!r} is not ported yet; "
                              f"only docreorder=none is")

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
        with open(index_path / "docs.bin", "wb") as docs_bin, \
                open(index_path / "docterms.bin", "wb") if store_positions else contextlib.nullcontext() as docterms_bin:
            for docid, contents in self.collection.get_doc_iterator():
                tokens = analyzer.analyze(contents)
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

        off = np.asarray(doc_byte_offsets, dtype=np.int64)
        np.save(index_path / "doc_spans.npy", np.stack([off[:-1], off[1:]], axis=1))
        if store_positions:
            toff = np.asarray(docterm_offsets, dtype=np.int64)
            np.save(index_path / "docterm_spans.npy", np.stack([toff[:-1], toff[1:]], axis=1))

        order, _ = canonical_postings_order(term_ids, doc_ords, tfs, num_docs)
        term_ids, doc_ords, tfs = term_ids[order], doc_ords[order], tfs[order]

        num_terms = len(vocab)
        term_offsets = np.zeros(num_terms + 1, dtype=np.int64)
        np.cumsum(np.bincount(term_ids, minlength=num_terms), out=term_offsets[1:])

        doclens = np.asarray(doclens, dtype=np.int32)
        norm_doclens = quantize_lengths(doclens).astype(np.int32)

        # forward index: the same triples sorted by (doc, term)
        fwd_order = np.lexsort((term_ids, doc_ords))
        fwd_offsets = np.zeros(num_docs + 1, dtype=np.int64)
        np.cumsum(np.bincount(doc_ords, minlength=num_docs), out=fwd_offsets[1:])

        terms_by_id = sorted(vocab, key=vocab.get)
        (index_path / "vocab.txt").write_text("\n".join(terms_by_id), encoding="utf-8")
        (index_path / "docids.txt").write_text("\n".join(docid_strings), encoding="utf-8")
        np.save(index_path / "postings_doc_ids.npy", doc_ords.astype(np.int32))
        np.save(index_path / "postings_tfs.npy", tfs.astype(np.int32))
        np.save(index_path / "postings_fwd_term_ids.npy", term_ids[fwd_order].astype(np.int32))
        np.save(index_path / "postings_fwd_tfs.npy", tfs[fwd_order].astype(np.int32))
        np.savez(index_path / "postings.npz", layout_version=np.int64(LAYOUT_VERSION),
                 term_offsets=term_offsets, doclens=doclens, norm_doclens=norm_doclens,
                 fwd_offsets=fwd_offsets)
        logger.info("index built: %d docs, %d terms, %d postings, avgdl %.2f",
                    num_docs, num_terms, len(tfs), doclens.mean())

    # ------------------------------------------------------------------ load/access
    def _load(self):
        if getattr(self, "_data", None) is not None:
            return self._data
        self.create_index()
        index_path = self.get_index_path()
        mmap_mode = "r" if self.config["mmap"] else None
        with np.load(index_path / "postings.npz") as npz:
            found = int(npz["layout_version"])
        if found != LAYOUT_VERSION:
            # a cache from an older layout: rebuild it in place (the done file lives inside index_path)
            logger.warning("index at %s has layout v%d (current v%d); rebuilding", index_path, found, LAYOUT_VERSION)
            shutil.rmtree(index_path, ignore_errors=True)
            self.create_index()
        with np.load(index_path / "postings.npz") as npz:
            term_offsets, doclens, norm_doclens = npz["term_offsets"], npz["doclens"], npz["norm_doclens"]
            fwd_offsets = npz["fwd_offsets"]
        vocab_list = (index_path / "vocab.txt").read_text(encoding="utf-8").splitlines()
        docid_strings = (index_path / "docids.txt").read_text(encoding="utf-8").splitlines()
        self._data = IndexData(
            term_offsets=term_offsets,
            doc_ids=np.load(index_path / "postings_doc_ids.npy", mmap_mode=mmap_mode),
            tfs=np.load(index_path / "postings_tfs.npy", mmap_mode=mmap_mode),
            doclens=doclens,
            norm_doclens=norm_doclens,
            docid_strings=docid_strings,
            vocab={t: i for i, t in enumerate(vocab_list)},
            fwd_offsets=fwd_offsets,
            fwd_term_ids=np.load(index_path / "postings_fwd_term_ids.npy", mmap_mode=mmap_mode),
            fwd_tfs=np.load(index_path / "postings_fwd_tfs.npy", mmap_mode=mmap_mode),
        )
        self._docid_to_ord = {d: i for i, d in enumerate(docid_strings)}
        self._doc_spans = np.load(index_path / "doc_spans.npy")
        self._docs_bin = np.memmap(index_path / "docs.bin", dtype=np.uint8, mode="r")
        self._docterm_spans = None
        if (index_path / "docterm_spans.npy").exists():
            self._docterm_spans = np.load(index_path / "docterm_spans.npy")
            # np.memmap refuses an empty file (a corpus whose docs all analyze to nothing)
            self._docterms_bin = (np.memmap(index_path / "docterms.bin", dtype=np.int32, mode="r")
                                  if (index_path / "docterms.bin").stat().st_size else np.zeros(0, np.int32))
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
