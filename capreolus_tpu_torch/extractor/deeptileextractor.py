"""DeepTileExtractor: topical-tile feature matrices, DeepTileBar's input (the
JAX package's ``extractor/deeptileextractor.py``).

A document's tokens are cut into ``slicelen``-token slices joined by blank
lines, which TextTiling (``analysis/segmentation.py``, k = 6) merges or cuts
at topic shifts; short documents that TextTiling refuses keep the raw slices,
and tiles past ``passagelen`` collapse into the last. Each (query term, tile)
cell carries up to three channels: the term's frequency in the tile, its idf
where it occurs, and the largest cosine between its embedding and the tile's.
The tiling is host Python, done once per document at ``preprocess``.
"""

from __future__ import annotations

import numpy as np

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.extractor import Extractor
from capreolus_tpu_torch.extractor.embeddings import build_embedding_matrix
from capreolus_tpu_torch.utils.exceptions import MissingDocError
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Extractor.register
class DeepTileExtractor(Extractor):
    module_name = "deeptiles"
    requires_random_seed = True
    dependencies = [
        Dependency(key="index", module="index", name="tpu",
                   default_config_overrides={"indexstops": True, "stemmer": "none"}),
        Dependency(key="tokenizer", module="tokenizer", name="lucene"),
    ]
    config_spec = [
        ConfigOption("tfchannel", True, "include TF as a channel"),
        ConfigOption("slicelen", 20, "tokens per tile"),
        ConfigOption("keepstops", False, "include stopwords"),
        ConfigOption("tilechannels", 3, "number of channels"),
        ConfigOption("embeddings", "glove6b", "embedding source"),
        ConfigOption("passagelen", 20, "number of tiles per document"),
        ConfigOption("maxqlen", 4, "maximum query length"),
        ConfigOption("maxdoclen", 800, "maximum doc length"),
        ConfigOption("usecache", True, "cache extracted features (reference default)"),
    ]
    config_keys_not_in_path = ["usecache"]

    def build(self):
        self.qid2toks = {}
        self.docid2tiles = {}
        self.stoi = {}
        self.idf = {}
        self.embeddings = None
        self._preprocessed = False

    def get_state(self):
        return {"qid2toks": self.qid2toks, "docid2tiles": self.docid2tiles, "stoi": self.stoi,
                "idf": self.idf, "embeddings": self.embeddings}

    def set_state(self, state):
        self.qid2toks, self.docid2tiles = state["qid2toks"], state["docid2tiles"]
        self.stoi, self.idf, self.embeddings = state["stoi"], state["idf"], state["embeddings"]
        self._preprocessed = True

    def _segmenter(self):
        if getattr(self, "_tt", None) is None:
            from capreolus_tpu_torch.analysis.segmentation import TextTilingSegmenter

            self._tt = TextTilingSegmenter(k=6)
        return self._tt

    def _tile_doc(self, text):
        """A document's tiles (lists of tokens), at most ``passagelen``."""
        toks = self.tokenizer.tokenize(text)[: self.config["maxdoclen"]]
        size = self.config["slicelen"]
        slices = [" ".join(toks[i : i + size]) for i in range(0, max(1, len(toks)), size)]
        try:
            tiles = [seg.split() for seg in self._segmenter().tokenize("\n\n".join(slices))]
        except ValueError:  # TextTiling refuses a document too short for its window
            tiles = [s.split() for s in slices]
        ntiles = self.config["passagelen"]
        if len(tiles) > ntiles:
            tiles[ntiles - 1] = [t for tile in tiles[ntiles - 1 :] for t in tile]
            tiles = tiles[:ntiles]
        return tiles

    def preprocess(self, qids, docids, topics):
        if self._preprocessed:
            return
        self.index.create_index()
        if self.config["usecache"] and self._load_state_from_cache(qids, docids):
            return
        for qid in qids:
            self.qid2toks[qid] = self.tokenizer.tokenize(topics[qid])[: self.config["maxqlen"]]
        for docid in docids:
            doc = self.index.get_doc(docid)
            self.docid2tiles[docid] = self._tile_doc(doc) if doc else []
        terms = sorted({t for toks in self.qid2toks.values() for t in toks}
                       | {t for tiles in self.docid2tiles.values() for tile in tiles for t in tile})
        self.embeddings, self.stoi = build_embedding_matrix(self.config["embeddings"], terms)
        query_terms = {t for toks in self.qid2toks.values() for t in toks}
        self.idf = {t: self.index.get_idf(t) for t in query_terms}
        self._preprocessed = True
        if self.config["usecache"]:
            self._cache_state(qids, docids)

    def _tile_matrix(self, query, tiles):
        """The [tilechannels, maxqlen, passagelen] features of a query over a document's tiles."""
        channels = self.config["tilechannels"]
        qlen = self.config["maxqlen"]
        ntiles = self.config["passagelen"]
        mat = np.zeros((channels, qlen, ntiles), dtype=np.float32)
        for qi, qterm in enumerate(query[:qlen]):
            q_row = self.stoi.get(qterm, 0)
            q_vec = self.embeddings[q_row] if q_row > 0 else None
            for ti, tile in enumerate(tiles[:ntiles]):
                tf = sum(1 for t in tile if t == qterm)
                if self.config["tfchannel"]:
                    mat[0, qi, ti] = tf
                if channels > 1:
                    mat[1, qi, ti] = self.idf.get(qterm, 0.0) if tf > 0 else 0.0
                if channels > 2 and q_vec is not None and tile:
                    rows = [self.stoi.get(t, 0) for t in tile]
                    vecs = self.embeddings[[r for r in rows if r > 0]]
                    if len(vecs):
                        sims = vecs @ q_vec / (
                            (np.linalg.norm(vecs, axis=1) + 1e-9) * (np.linalg.norm(q_vec) + 1e-9)
                        )
                        mat[2, qi, ti] = float(sims.max())
        return mat

    def id2vec(self, qid, posid, negid=None, label=None, training=True):
        if not self._preprocessed:
            raise RuntimeError("call preprocess() first")
        query = self.qid2toks[qid]
        pos_tiles = self.docid2tiles.get(posid)
        if not pos_tiles:
            raise MissingDocError(qid, posid)
        posdoc = self._tile_matrix(query, pos_tiles)
        data = {
            "qid": qid,
            "posdocid": posid,
            "posdoc": posdoc,
            "negdocid": "",
            "negdoc": np.zeros_like(posdoc),
            "query_idf": np.zeros(self.config["maxqlen"], dtype=np.float32),
            "label": np.array(label if label is not None else [1, 0], dtype=np.float32),
        }
        if negid:
            neg_tiles = self.docid2tiles.get(negid)
            if not neg_tiles:
                raise MissingDocError(qid, negid)
            data["negdocid"] = negid
            data["negdoc"] = self._tile_matrix(query, neg_tiles)
        return data
