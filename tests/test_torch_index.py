"""The PyTorch port's index build against the JAX package's, on the CPU.

The port's ``TpuIndex`` must produce EQUAL artifacts: vocab, docid order,
doclens, SmallFloat norm doclens, term offsets, the canonical postings
(doc ids, tfs) and the block-max prune tables, for every stemmer, with
stopwords indexed or removed, under both docid reorderings, and with the
analyzer on one thread or many.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402

_WORDS = ("galaxy galaxies telescope telescopes whale whales ocean oceans running runs jumped "
          "gravity computes computing computation relational conditional happily generously "
          "orbit orbits orbiting launch launched Launches hopeful hopefulness").split()
_EXTRAS = ("the", "and", "of", "is", "not", "whale's", "U.S.A", "3.14", "1,000", "don't",
           "Zebra", "ZEBRAS", "x_y", "naïve", "café")


def write_trec_corpus(directory, num_docs=2000, seed=7, min_len=8, max_len=80, files=2):
    """Deterministic TREC corpus: Zipfian words, stopwords, possessives,
    numbers, mixed case, a non-content tag, and two content tags per doc.
    Returns [(docid, text)] in file order."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = list(_WORDS) + list(_EXTRAS) + [f"w{i}" for i in range(300)]
    probs = 1.0 / np.arange(1, len(vocab) + 1) ** 1.05
    probs /= probs.sum()
    directory.mkdir(parents=True, exist_ok=True)
    docs = []
    per_file = (num_docs + files - 1) // files
    for f in range(files):
        with open(directory / f"part{f}.trec", "wt", encoding="utf-8") as fh:
            for i in range(f * per_file, min(num_docs, (f + 1) * per_file)):
                n = int(rng.integers(min_len, max_len))
                words = list(rng.choice(vocab, size=n, p=probs))
                head, body = " ".join(words[:3]), " ".join(words[3:])
                docid = f"T{i:05d}"
                fh.write(f"<DOC>\n<DOCNO> {docid} </DOCNO>\n<BYLINE> byline{i} </BYLINE>\n"
                         f"<HEADLINE>\n{head}\n</HEADLINE>\n<TEXT>\n{body}\n</TEXT>\n</DOC>\n")
                docs.append((docid, f"{head} {body}"))
    return docs


@pytest.fixture
def torch_cache(tmp_path, monkeypatch):
    """Point the PORT's cache/results paths at a tmpdir (tmpdir_as_cache patches
    only the JAX package's constants)."""
    from capreolus_tpu_torch.core import constants

    monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / "torch_cache")
    monkeypatch.setitem(constants, "RESULTS_BASE_PATH", tmp_path / "torch_results")
    return tmp_path


def _collection_cfg(kind, tmp_path):
    if kind == "dummy":
        return {"name": "dummy"}
    corpus = tmp_path / "corpus"
    if not corpus.exists():
        write_trec_corpus(corpus)
    return {"name": "dummy", "path": str(corpus)}


def _assert_same_index(jax_index, torch_index):
    jd, td = jax_index.data, torch_index.data
    assert td.vocab == jd.vocab
    assert td.docid_strings == jd.docid_strings
    for name in ("term_offsets", "doc_ids", "tfs", "doclens", "norm_doclens"):
        np.testing.assert_array_equal(np.asarray(getattr(td, name)), np.asarray(getattr(jd, name)), err_msg=name)
    assert sorted(td.prune_tables) == sorted(jd.prune_tables)
    for name, value in jd.prune_tables.items():
        np.testing.assert_array_equal(td.prune_tables[name], value, err_msg=f"prune table {name}")
        assert td.prune_tables[name].dtype == value.dtype, name


@pytest.mark.parametrize("corpus", ["dummy", "synthetic"])
@pytest.mark.parametrize("stemmer", ["porter", "none"])
@pytest.mark.parametrize("indexstops", [False, True])
def test_index_arrays_equal(tmpdir_as_cache, torch_cache, corpus, stemmer, indexstops):
    cfg = {"stemmer": stemmer, "indexstops": indexstops,
           "collection": _collection_cfg(corpus, tmpdir_as_cache)}
    jax_index = JaxIndex.create("tpu", cfg)
    torch_index = TorchIndex.create("tpu", cfg)
    _assert_same_index(jax_index, torch_index)
    # the cache path of each package derives from the same config
    assert torch_index.get_module_path() == jax_index.get_module_path()


def test_index_accessors_equal(tmpdir_as_cache, torch_cache):
    cfg = {"collection": _collection_cfg("synthetic", tmpdir_as_cache)}
    jax_index = JaxIndex.create("tpu", cfg)
    torch_index = TorchIndex.create("tpu", cfg)
    for docid in ("T00000", "T00999", "T01999", "missing"):
        assert torch_index.get_doc(docid) == jax_index.get_doc(docid)
    for text in ("Galaxies orbiting the whale's ocean", "U.S.A 3.14 1,000 don't", "café naïve"):
        terms = torch_index.analyze(text)
        assert terms == jax_index.analyze(text)
        for term in terms + ["zzzz"]:
            assert torch_index.get_df(term) == jax_index.get_df(term)
            assert torch_index.get_idf(term) == jax_index.get_idf(term)


@pytest.mark.parametrize("native", ["1", "0"])
def test_threaded_build_equals_serial(tmpdir_as_cache, torch_cache, monkeypatch, native):
    """The build analyzes chunks of documents on MAX_THREADS threads; with the
    native analyzer and with the Python chain, and with chunks that split the
    files, every array equals a one-thread build's and the JAX index's."""
    from capreolus_tpu_torch.core import constants
    from capreolus_tpu_torch.index import tpu as port_index_tpu

    monkeypatch.setenv("CAPREOLUS_NATIVE", native)
    monkeypatch.setattr(port_index_tpu, "ANALYZE_CHUNK_DOCS", 37)
    coll = _collection_cfg("synthetic", tmpdir_as_cache)
    built = {}
    for threads in (1, 8):
        monkeypatch.setitem(constants, "MAX_THREADS", threads)
        monkeypatch.setitem(constants, "CACHE_BASE_PATH", torch_cache / f"threads{threads}")
        built[threads] = TorchIndex.create("tpu", {"collection": coll})
        built[threads].create_index()
    _assert_same_index(built[1], built[8])
    _assert_same_index(JaxIndex.create("tpu", {"collection": coll}), built[8])
    assert built[8].get_doc("T01999") == built[1].get_doc("T01999")


def test_index_mmap_gives_same_arrays(tmpdir_as_cache, torch_cache):
    coll = _collection_cfg("synthetic", tmpdir_as_cache)
    mapped = TorchIndex.create("tpu", {"mmap": True, "collection": coll})
    loaded = TorchIndex.create("tpu", {"mmap": False, "collection": coll})
    assert isinstance(mapped.data.doc_ids, np.memmap) and not isinstance(loaded.data.doc_ids, np.memmap)
    for name in ("doc_ids", "tfs"):
        np.testing.assert_array_equal(np.asarray(getattr(mapped.data, name)), getattr(loaded.data, name))


@pytest.mark.parametrize("override", [{"docreorder": "bp"}, {"docreorder": "terms"}, {"stemmer": "krovetz"}])
def test_index_unported_options_raise(tmpdir_as_cache, torch_cache, override):
    """Every option once refused is ported. ``stemmer=krovetz`` gives the JAX
    index's arrays (an unknown stemmer still raises). The two docid
    reorderings: their internal ordinals, docid order, postings, prune tables
    and stored documents equal the JAX index's, and ``docreorder=none`` holds
    the same documents under other ordinals."""
    coll = _collection_cfg("synthetic", tmpdir_as_cache)
    if "stemmer" in override:
        jax_index = JaxIndex.create("tpu", {**override, "collection": coll})
        torch_index = TorchIndex.create("tpu", {**override, "collection": coll})
        _assert_same_index(jax_index, torch_index)
        assert torch_index.analyze("running cities hopped") == ["run", "city", "hop"]
        assert torch_index.data.vocab != TorchIndex.create("tpu", {"collection": coll}).data.vocab
        with pytest.raises(ConfigError):
            TorchIndex.create("tpu", {"stemmer": "lovins", "collection": coll})
        return
    jax_index = JaxIndex.create("tpu", {**override, "collection": coll})
    torch_index = TorchIndex.create("tpu", {**override, "collection": coll})
    _assert_same_index(jax_index, torch_index)
    plain = TorchIndex.create("tpu", {"collection": coll})
    assert torch_index.data.docid_strings != plain.data.docid_strings
    assert sorted(torch_index.data.docid_strings) == sorted(plain.data.docid_strings)
    for docid in plain.data.docid_strings[:50]:
        assert torch_index.get_doc(docid) == plain.get_doc(docid) == jax_index.get_doc(docid)
