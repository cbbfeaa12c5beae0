"""The reranker zoo's extractors in the port (``slowembedtext``,
``bagofwords``, ``deeptiles``) against the JAX package's on a corpus the test
writes: the preprocessed state and every ``id2vec`` feature equal, exactly.
``slowembedtext`` runs over a pretrained table written to both caches that
holds about two thirds of the corpus's terms, so that out-of-embedding terms
take negative ids (``zerounk=False``) or the pad id 0 (``zerounk=True``)."""

import numpy as np
import pytest

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()

from capreolus_tpu.extractor import Extractor as JaxExtractor  # noqa: E402
from capreolus_tpu_torch.extractor import Extractor as TorchExtractor  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from torch_zoo_util import zoo_corpus_at  # noqa: E402

PRETRAINED = "glove6b.50d"  # a name the loaders read from <cache>/embeddings/<name>.npy + .vocab.txt


@pytest.fixture
def corpus(tmpdir_as_cache, torch_cache):
    from capreolus_tpu_torch.core import constants

    corpus = zoo_corpus_at(tmpdir_as_cache)
    rng = np.random.Generator(np.random.PCG64(11))
    # a pretrained table over two thirds of a vocabulary of the corpus's words, in both caches
    words = sorted({w.lower().strip(".,'") for f in (tmpdir_as_cache / "corpus").iterdir()
                    for w in f.read_text().split() if w.isalpha()})
    kept = [w for w in words if rng.random() < 0.66]
    table = rng.standard_normal((len(kept), 50)).astype(np.float32)
    for base in (tmpdir_as_cache / "cache", constants["CACHE_BASE_PATH"]):
        (base / "embeddings").mkdir(parents=True, exist_ok=True)
        np.save(base / "embeddings" / f"{PRETRAINED}.npy", table)
        (base / "embeddings" / f"{PRETRAINED}.vocab.txt").write_text("\n".join(kept) + "\n")
    return corpus


def pair(corpus, name, config):
    out = []
    for registry in (JaxExtractor, TorchExtractor):
        ext = registry.create(name, dict(config, index={"collection": corpus["collection"]}))
        ext.preprocess(list(corpus["run"]), corpus["docids"], corpus["topics"])
        out.append(ext)
    return out


def assert_samples_equal(corpus, jax_ext, port_ext):
    n = 0
    for qid, docs in corpus["run"].items():
        ids = sorted(docs)
        for pos, neg in zip(ids, ids[1:] + ids[:1]):
            want = jax_ext.id2vec(qid, pos, neg, label=[1, 0])
            got = port_ext.id2vec(qid, pos, neg, label=[1, 0])
            assert sorted(got) == sorted(want)
            for key, value in want.items():
                if isinstance(value, np.ndarray):
                    assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
                    np.testing.assert_array_equal(got[key], value, err_msg=f"{qid} {pos} {key}")
                else:
                    assert got[key] == value, key
            n += 1
    return n


@pytest.mark.parametrize("zerounk", [False, True])
def test_slowembedtext_features_equal_jax(corpus, zerounk):
    jax_ext, port_ext = pair(corpus, "slowembedtext", {"embeddings": PRETRAINED, "maxqlen": 4, "maxdoclen": 40,
                                                       "zerounk": zerounk})
    assert port_ext.stoi == jax_ext.stoi and min(port_ext.stoi.values()) < 0  # out-of-embedding terms exist
    np.testing.assert_array_equal(port_ext.embeddings, jax_ext.embeddings)
    assert assert_samples_equal(corpus, jax_ext, port_ext) == 48
    docs = np.stack([port_ext.id2vec(q, d)["posdoc"] for q, run in corpus["run"].items() for d in run])
    if zerounk:  # unknown terms are the pad id, inside documents: K1's input with pads among real terms
        assert docs.min() == 0 and any((row[: np.count_nonzero(row)] == 0).any() for row in docs)
    else:
        assert docs.min() < 0
    assert "usecache" not in str(port_ext.get_cache_path()) and port_ext.config["usecache"] is False


@pytest.mark.parametrize("datamode", ["unigram", "trigram"])
def test_bagofwords_features_equal_jax(corpus, datamode):
    jax_ext, port_ext = pair(corpus, "bagofwords", {"datamode": datamode})
    assert port_ext.stoi == jax_ext.stoi
    assert port_ext.feature_dim == len(port_ext.stoi) == jax_ext.feature_dim
    assert assert_samples_equal(corpus, jax_ext, port_ext) == 48
    if datamode == "trigram":
        assert all(len(f) == 3 for f in port_ext.stoi)


def test_bagofwords_feature_dim_is_the_vector_width(corpus):
    """With no vocabulary the vectors keep one slot, and ``feature_dim`` says so."""
    ext = TorchExtractor.create("bagofwords", {"index": {"collection": corpus["collection"]}})
    ext.set_state({"qid2toks": {"q": []}, "docid2toks": {"d": ["x"]}, "stoi": {}})
    assert ext.feature_dim == 1 and ext.id2vec("q", "d")["posdoc"].shape == (1,)


@pytest.mark.parametrize("config", [{}, {"tilechannels": 2, "tfchannel": False, "slicelen": 5, "passagelen": 6}],
                         ids=["defaults", "two-channels"])
def test_deeptiles_features_equal_jax(corpus, config):
    cfg = dict({"embeddings": "random8", "maxqlen": 4, "maxdoclen": 40, "slicelen": 8, "passagelen": 4}, **config)
    jax_ext, port_ext = pair(corpus, "deeptiles", cfg)
    assert port_ext.docid2tiles == jax_ext.docid2tiles and port_ext.idf == jax_ext.idf
    np.testing.assert_array_equal(port_ext.embeddings, jax_ext.embeddings)
    assert assert_samples_equal(corpus, jax_ext, port_ext) == 48
    tiles = [len(t) for t in port_ext.docid2tiles.values()]
    assert max(tiles) <= cfg["passagelen"] and min(tiles) >= 1


def test_deeptiles_state_round_trips(corpus, tmp_path):
    _, port_ext = pair(corpus, "deeptiles", {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 40})
    port_ext.save_state(tmp_path / "state.pkl")
    again = TorchExtractor.create("deeptiles", {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 40,
                                                "index": {"collection": corpus["collection"]}})
    again.load_state(tmp_path / "state.pkl")
    qid, docs = next(iter(corpus["run"].items()))
    doc = next(iter(docs))
    np.testing.assert_array_equal(again.id2vec(qid, doc)["posdoc"], port_ext.id2vec(qid, doc)["posdoc"])
