"""Item 3b in the port: the published benchmarks, the collection formats, the
static-run and MS MARCO searchers, MS MARCO evaluation, significance tests,
udel expansion and the tutorial task, against the JAX package's on the CPU.

Nothing downloads: ``CAPREOLUS_OFFLINE=1`` (tests/conftest.py), so what
needs a download raises ``OfflineEnvironmentError`` in both packages, and
every file a benchmark ships resolves from the port's own ``data/``.
Tolerances: topics, qrels, folds, parsed documents, run files of static
searchers, significance reports and MS MARCO metrics are equal; the rank
task on ``robust04.yang19`` writes BM25 run files with the same docids and
scores within 1e-6 relative (``tests/test_torch_rank.py``'s rule) and RM3
run files equal but for near-ties (1e-5), with every metric within 1e-12
(BM25) and 1e-4 (RM3).
"""

import json
import shutil
import textwrap
from pathlib import Path

import numpy as np
import pytest

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()

from capreolus_tpu.benchmark import Benchmark as JaxBenchmark  # noqa: E402
from capreolus_tpu.collection import Collection as JaxCollection  # noqa: E402
from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.task import Task as JaxTask  # noqa: E402
from capreolus_tpu_torch.benchmark import Benchmark  # noqa: E402
from capreolus_tpu_torch.collection import Collection  # noqa: E402
from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402
from capreolus_tpu_torch.searcher import UNPORTED_SEARCHERS, Searcher  # noqa: E402
from capreolus_tpu_torch.task import Task  # noqa: E402
from capreolus_tpu_torch.utils.common import OfflineEnvironmentError  # noqa: E402
from chip_smoke import ROBUST04_SEARCHERS, robust04_shaped_corpus  # noqa: E402
from test_collection_formats import TRECWEB_EXPECTED, TRECWEB_FIXTURE  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_rank import assert_same_run_files  # noqa: E402

BENCHMARKS = ["antique", "core17", "core17.desc", "core18", "core18.desc", "gov2", "gov2.desc", "cds", "cds.desc",
              "genomics", "covid", "covidabstract", "covidqa", "codesearchnet_corpus", "codesearchnet_challenge",
              "robust04", "robust04.yang19", "robust04.yang19.desc", "robust04.huston14.title",
              "robust04.huston14.desc", "nf", "msmarcopsg"]
COLLECTIONS = ["antique", "nf", "robust04", "msmarcopsg", "gov2", "cds", "nyt", "wapo", "highwire", "covid",
               "covidabstract", "codesearchnet"]
STATIC_RUNS = ["bm25staticrob04yang19", "bm25staticrob04yang19desc", "bm25staticrob04huston14title",
               "bm25staticrob04huston14desc", "bm25staticgov2", "bm25staticgov2desc", "bm25staticgenomics",
               "bm25staticcds", "qdelstaticcovidabstract", "rm3staticcore18title", "rm3staticcore18desc"]
SHIPPED_RUNS = {"bm25staticgenomics", "bm25staticcds", "qdelstaticcovidabstract", "rm3staticcore18title",
                "rm3staticcore18desc"}


@pytest.fixture
def caches(tmpdir_as_cache, torch_cache):
    return tmpdir_as_cache


def outcome(fn):
    """What ``fn()`` gives: ("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn()
    except Exception as e:  # compared between the packages, never swallowed
        return type(e).__name__, str(e)


def test_nothing_of_item_3b_is_left_unported():
    assert sorted(UNPORTED_SEARCHERS) == ["dense", "impact"]
    for name in STATIC_RUNS + ["msmarcopsg", "static_tct_colbert", "msptop200"]:
        assert Searcher.lookup(name).__module__ == "capreolus_tpu_torch.searcher.special", name
    for name in BENCHMARKS:
        assert Benchmark.lookup(name).module_name == name
    for name in COLLECTIONS:
        assert Collection.lookup(name).module_name == name


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_as_in_jax(caches, name):
    """Each benchmark: its options, query type, relevance level, collection and
    module path as JAX's; its topics, qrels and folds equal to JAX's where they
    resolve offline (shipped data), the same error where they do not."""
    ours, ref = Benchmark.create(name), JaxBenchmark.create(name)
    assert ours.config == ref.config
    assert (ours.query_type, ours.relevance_level, ours.use_train_as_dev) == \
        (ref.query_type, ref.relevance_level, ref.use_train_as_dev)
    assert ours.collection.module_name == ref.collection.module_name
    assert ours.get_module_path() == ref.get_module_path()
    resolved = 0
    for part in ("topics", "qrels", "folds"):
        got, want = outcome(lambda: getattr(ours, part)), outcome(lambda: getattr(ref, part))
        assert got == want, (name, part)
        resolved += got[0] == "ok"
    shipped = {"antique": 3, "robust04": 2, "robust04.yang19": 2, "robust04.yang19.desc": 2,
               "robust04.huston14.title": 2, "robust04.huston14.desc": 2}
    assert resolved == shipped.get(name, resolved)


def test_shipped_benchmark_data(caches):
    b = Benchmark.create("robust04.yang19")
    assert len(b.topics["title"]) == 250 and b.topics["title"]["301"].lower().startswith("international organized")
    assert sorted(b.folds) == ["s1", "s2", "s3", "s4", "s5"]
    assert {q for f in b.folds.values() for q in f["predict"]["test"]} == set(b.topics["title"])
    with pytest.raises(OfflineEnvironmentError, match="offline"):
        b.qrels
    antique = Benchmark.create("antique")
    assert antique.relevance_level == 2 and len(antique.topics["title"]) > 2400 and antique.qrels
    for name in ("core18", "core18.desc", "cds", "genomics", "gov2", "core17"):
        assert Path(Benchmark.create(name).fold_file).parent == port_constants["PACKAGE_PATH"] / "data", name


def test_generated_folds_require_opt_in(caches, monkeypatch):
    from capreolus_tpu_torch.core import ConfigError

    monkeypatch.setattr(Benchmark.lookup("antique"), "fold_url", None)
    monkeypatch.setattr(JaxBenchmark.lookup("antique"), "fold_url", None)
    with pytest.raises(ConfigError, match="folds=generated"):
        Benchmark.create("antique").folds
    assert Benchmark.create("antique", {"folds": "generated"}).folds == \
        JaxBenchmark.create("antique", {"folds": "generated"}).folds


@pytest.mark.parametrize("name", COLLECTIONS)
def test_collection_as_in_jax(caches, name):
    """Each collection: its format and the error where its corpus is neither
    given nor downloadable offline (licensed corpora: IOError; public ones:
    OfflineEnvironmentError), as JAX's; a given path wins."""
    ours, ref = Collection.create(name), JaxCollection.create(name)
    assert (ours.collection_type, ours.is_large_collection) == (ref.collection_type, ref.is_large_collection)
    assert ours.get_module_path() == ref.get_module_path()
    got, want = outcome(ours.get_path), outcome(ref.get_path)
    assert got[0] == want[0] and got[0] in ("OfflineEnvironmentError", "OSError"), (got, want)
    if got[0] == "OSError":
        assert got == want
    given = caches / "given"
    given.mkdir(exist_ok=True)
    assert Collection.create(name, {"path": str(given)}).get_path() == given


def test_collection_formats_iterate_as_in_jax(caches, tmp_path):
    from capreolus_tpu.utils.trec import html_to_text as jax_html_to_text
    from capreolus_tpu.utils.trec import iterate_jsonl_docs as jax_iterate_jsonl_docs
    from capreolus_tpu_torch.utils.trec import html_to_text, iterate_jsonl_docs, iterate_trecweb_docs

    web = tmp_path / "gov2"
    web.mkdir()
    (web / "00.txt").write_text(TRECWEB_FIXTURE + "<DOC>\n<DOCNO>WX-1</DOCNO>\n<DOCOLDNO>OLD-9</DOCOLDNO>\n"
                                "hello <b>web</b> world\n</DOC>\n", encoding="utf-8")
    expected = TRECWEB_EXPECTED + [("WX-1", "hello web world")]
    assert list(iterate_trecweb_docs(web / "00.txt")) == expected
    assert list(Collection.create("gov2", {"path": str(web)}).get_doc_iterator()) == \
        list(JaxCollection.create("gov2", {"path": str(web)}).get_doc_iterator()) == expected
    jsonl = tmp_path / "json"
    jsonl.mkdir()
    (jsonl / "docs.jsonl").write_text('{"id": "NCT001", "contents": "title text abstract"}\n\n'
                                      '{"id": 7, "contents": "second document"}\n', encoding="utf-8")
    assert list(iterate_jsonl_docs(jsonl / "docs.jsonl")) == list(jax_iterate_jsonl_docs(jsonl / "docs.jsonl"))
    for name in ("cds", "nyt", "highwire", "wapo", "covid"):
        assert list(Collection.create(name, {"path": str(jsonl)}).get_doc_iterator()) == \
            list(JaxCollection.create(name, {"path": str(jsonl)}).get_doc_iterator()) == \
            [("NCT001", "title text abstract"), ("7", "second document")]
    tsv = tmp_path / "tsv"
    tsv.mkdir()
    (tsv / "docs.tsv").write_text("a1\tfirst answer text\n\na2\tsecond\ttabbed answer\n", encoding="utf-8")
    assert list(Collection.create("antique", {"path": str(tsv)}).get_doc_iterator()) == \
        list(JaxCollection.create("antique", {"path": str(tsv)}).get_doc_iterator())
    for html in ("<p>a&lt;b</p>", "no markup", "<script>x()</script><b>kept</b>", "<script>var leak = 1;",
                 "<br/>line one<br/>line two", "<style>a<style>b</style>c</style>ok"):
        assert html_to_text(html) == jax_html_to_text(html), html


def test_trecweb_docno_closing_tag_in_any_case(tmp_path):
    """Recorded difference: the port strips ``</DOCNO>`` in any letter case;
    the JAX parser strips only ``</DOCNO>`` and ``</docno>``."""
    from capreolus_tpu.utils.trec import iterate_trecweb_docs as jax_iterate_trecweb_docs
    from capreolus_tpu_torch.utils.trec import iterate_trecweb_docs

    fn = tmp_path / "web.txt"
    fn.write_text("<DOC>\n<DOCNO>GX-1</DOCNO>\n<p>one</p>\n</DOC>\n<DOC>\n<docno> GX-2 </docno>\ntwo\n</DOC>\n"
                  "<DOC>\n<DocNo>GX-3</DocNo>\n<DOCHDR>\nhttp://x HTTP/1.1\n</DOCHDR>\nthree\n</DOC>\n")
    assert list(iterate_trecweb_docs(fn)) == [("GX-1", "one"), ("GX-2", "two"), ("GX-3", "three")]
    assert list(jax_iterate_trecweb_docs(fn)) == [("GX-1", "one"), ("GX-2", "two"), ("GX-3</DocNo>", "three")]


@pytest.mark.parametrize("name", STATIC_RUNS)
def test_static_run_searchers_as_in_jax(caches, tmp_path, name):
    """A given ``runfile`` is handed back; without one, a shipped run comes
    from the port's data/ (the JAX package's file, byte for byte) and any
    other raises OfflineEnvironmentError, as in JAX."""
    from capreolus_tpu_torch.utils.trec import write_trec_run

    runfile = tmp_path / "canned.run"
    write_trec_run({"301": {"D001": 2.0, "D002": 1.0}}, runfile)
    outs = {}
    for pkg, cls in (("port", Searcher), ("jax", JaxSearcher)):
        out = cls.create(name, {"runfile": str(runfile)}).query_from_file(tmp_path / "unused.tsv", tmp_path / pkg)
        outs[pkg] = (out / "static_run").read_bytes()
        outs[pkg + "_default"] = outcome(lambda: Path(cls.create(name).query_from_file(
            tmp_path / "unused.tsv", tmp_path / f"{pkg}_default") / "static_run").read_bytes())
    assert outs["port"] == outs["jax"] == runfile.read_bytes()
    assert outs["port_default"] == outs["jax_default"]
    if name in SHIPPED_RUNS:
        assert outs["port_default"][0] == "ok" and len(outs["port_default"][1]) > 100_000
    else:
        assert outs["port_default"][0] == "OfflineEnvironmentError"


@pytest.mark.parametrize("name", ["static_tct_colbert", "msptop200"])
def test_runfile_only_searchers_as_in_jax(caches, tmp_path, name):
    runfile = tmp_path / "given.run"
    runfile.write_text("1 Q0 p1 1 3.0 tag\n")
    for pkg, cls in (("port", Searcher), ("jax", JaxSearcher)):
        with pytest.raises(IOError, match="runfile"):
            cls.create(name).query_from_file(tmp_path / "t.tsv", tmp_path / f"{pkg}_none")
        out = cls.create(name, {"runfile": str(runfile)}).query_from_file(tmp_path / "t.tsv", tmp_path / pkg)
        assert (out / "static_run").read_text() == runfile.read_text()
    assert Searcher.create(name).config == JaxSearcher.create(name).config


def test_msmarcopsg_searcher_as_in_jax(caches, tmp_path):
    triples = tmp_path / "triples.tsv"
    triples.write_text("1\tp1\tp9\n1\tp1\tp8\n2\tp2\tp9\n")
    top1000 = tmp_path / "top1000.tsv"
    top1000.write_text("3\tp3\tq\tpassage\n3\tp4\tq\tpassage\n4\tp5\tq\tpassage\n")
    files = {"tripletsfile": str(triples), "top1000file": str(top1000)}
    outs = []
    for pkg, cls in (("port", Searcher), ("jax", JaxSearcher)):
        with pytest.raises(IOError, match="tripletsfile"):
            cls.create("msmarcopsg").query_from_file(tmp_path / "t.tsv", tmp_path / f"{pkg}_none")
        out = cls.create("msmarcopsg", files).query_from_file(tmp_path / "t.tsv", tmp_path / pkg)
        outs.append((out / "searcher_msmarcopsg").read_text())
    assert outs[0] == outs[1] and outs[0].count("\n") == 8


def test_covid_xml_topics_and_udel_as_in_jax(caches, tmp_path):
    xml = textwrap.dedent("""\
        <topics>
        <topic number="1"><query>coronavirus origin</query>
        <question>what is the origin of COVID-19</question>
        <narrative>n</narrative></topic>
        <topic number="2"><query>virus spread</query>
        <question>how does the coronavirus respond to changes in the weather</question>
        <narrative>n</narrative></topic>
        </topics>""")
    topicfn, qrelfn = tmp_path / "topics.xml", tmp_path / "qrels.txt"
    topicfn.write_text(xml)
    qrelfn.write_text("1 Q0  d1 2\n2 Q0  d2 1\n")
    for name in ("covid", "covidabstract"):
        for extra in ({}, {"udelqexpand": True}):
            cfg = {"topicfile": str(topicfn), "qrelfile": str(qrelfn), **extra}
            ours, ref = Benchmark.create(name, cfg), JaxBenchmark.create(name, cfg)
            assert ours.topics == ref.topics and ours.qrels == ref.qrels and ours.folds == ref.folds
    expanded = Benchmark.create("covid", {"topicfile": str(topicfn), "qrelfile": str(qrelfn), "udelqexpand": True})
    assert "coronavirus" in expanded.topics["title"]["1"] and expanded.topics["desc"]["1"] == " "


def test_covidqa_and_codesearchnet_topics_as_in_jax(caches, tmp_path):
    data = {"categories": [{"name": "c", "sub_categories": [
        {"kq_name": "incubation period", "nq_name": "how long is incubation",
         "answers": [{"id": "doc1"}, {"id": "doc2"}]},
        {"kq_name": "transmission", "nq_name": "how does it spread", "answers": [{"id": "doc3"}]}]}]}
    fn = tmp_path / "covidqa.json"
    fn.write_text(json.dumps(data))
    ours, ref = Benchmark.create("covidqa", {"topicfile": str(fn)}), JaxBenchmark.create("covidqa", {"topicfile": str(fn)})
    assert ours.topics == ref.topics and ours.qrels == ref.qrels and ours.folds == ref.folds
    assert ours.qrels["2001"] == {"doc1": 1, "doc2": 1}
    csv = tmp_path / "queries.csv"
    csv.write_text("query\nconvert int to string\npriority queue\n")
    ours = Benchmark.create("codesearchnet_challenge", {"topicfile": str(csv)})
    ref = JaxBenchmark.create("codesearchnet_challenge", {"topicfile": str(csv)})
    assert ours.topics == ref.topics == {"title": {"1": "convert int to string", "2": "priority queue"},
                                         "query": {"1": "convert int to string", "2": "priority queue"}}
    with pytest.raises(ValueError):
        ours.qrels
    qrels = tmp_path / "csn_qrels.txt"
    qrels.write_text("1 0 f1 1\n")
    assert Benchmark.create("codesearchnet_challenge", {"topicfile": str(csv), "qrelfile": str(qrels)}).qrels == \
        JaxBenchmark.create("codesearchnet_challenge", {"topicfile": str(csv), "qrelfile": str(qrels)}).qrels


def _write_raw(directory, kind):
    """A small raw NFCorpus or MS MARCO distribution, in the file names the benchmarks read."""
    directory.mkdir(parents=True, exist_ok=True)
    if kind == "nf":
        for i, split in enumerate(("train", "dev", "test")):
            for fields in ("titles", "nontopic-titles", "vid-titles"):
                (directory / f"{split}.{fields}.queries").write_text(
                    f"PLAIN-{i}1\t{fields} query one of {split}\nPLAIN-{i}2\tsecond {split} query\n")
            (directory / f"{split}.3-2-1.qrel").write_text(
                f"PLAIN-{i}1 0 MED-{i}0 3\nPLAIN-{i}1 0 MED-{i}1 1\nPLAIN-{i}2 0 MED-{i}2 2\n")
    else:
        (directory / "queries.train.tsv").write_text("11\twhat is a train query\n12\tanother one\n")
        (directory / "queries.dev.small.tsv").write_text("21\ta dev query\n")
        (directory / "qrels.train.tsv").write_text("11\t0\tp1\t1\n12\t0\tp2\t1\n")
        (directory / "qrels.dev.small.tsv").write_text("21\t0\tp3\t1\n")


@pytest.mark.parametrize("name,config", [("nf", {}), ("nf", {"labelrange": "1-3", "fields": "vid_title"}),
                                         ("msmarcopsg", {})])
def test_benchmarks_built_from_raw_files_as_in_jax(caches, tmp_path, monkeypatch, name, config):
    raw = tmp_path / "raw"
    _write_raw(raw, name)
    for cls in (Collection.lookup(name), JaxCollection.lookup(name)):
        monkeypatch.setattr(cls, "get_raw_dir", lambda self: raw)
    ours, ref = Benchmark.create(name, config), JaxBenchmark.create(name, config)
    assert ours.topics == ref.topics and ours.qrels == ref.qrels and ours.folds == ref.folds
    assert Path(ours.topic_file).read_text() == Path(ref.topic_file).read_text()
    assert ours.topics[ours.query_type]


def test_significance_equals_jax():
    from capreolus_tpu.evaluation import significance as jax_sig
    from capreolus_tpu_torch.evaluation import significance as sig

    for t, df in ((2.0, 10), (2.228, 10), (1.0, 30), (0.0, 5), (12.706, 1), (-3.5, 7), (40.0, 200)):
        assert sig.t_sf_two_sided(t, df) == jax_sig.t_sf_two_sided(t, df)
    rng = np.random.Generator(np.random.PCG64(5))
    a, b = rng.random(40), rng.random(40)
    assert sig.paired_t_test(a, b) == jax_sig.paired_t_test(a, b)
    for seed in (3, 42):
        assert sig.randomization_test(a + 0.05, b, iters=5000, seed=seed) == \
            jax_sig.randomization_test(a + 0.05, b, iters=5000, seed=seed)
    qrels = {str(q): {f"D{d}": int(rng.integers(0, 3)) for d in range(12)} for q in range(30)}
    runs = [{q: {f"D{d}": float(rng.random()) for d in range(12)} for q in qrels} for _ in range(2)]
    runs[1]["999"] = {"D1": 1.0}
    metrics = ["map", "ndcg_cut_10", "P_5", "recip_rank"]
    assert sig.compare_runs(runs[0], runs[1], qrels, metrics=metrics, iters=3000, seed=7) == \
        jax_sig.compare_runs(runs[0], runs[1], qrels, metrics=metrics, iters=3000, seed=7)


def test_msmarco_evaluation_equals_jax(tmp_path):
    from capreolus_tpu.evaluation import msmarco as jax_ms
    from capreolus_tpu_torch.evaluation import msmarco as ms

    rng = np.random.Generator(np.random.PCG64(2))
    qrels = {str(q): {f"p{int(rng.integers(0, 30))}": 1} for q in range(20)}
    run = {str(q): {f"p{d}": float(rng.random()) for d in rng.choice(30, size=15, replace=False)} for q in range(18)}
    assert ms.compute_metrics_from_files(trec_qrels=qrels, trec_runs=run) == \
        jax_ms.compute_metrics_from_files(trec_qrels=qrels, trec_runs=run)
    rows = ms.trec_to_msmarco(run)
    assert rows == jax_ms.trec_to_msmarco(run)
    fn = tmp_path / "run.msmarco"
    fn.write_text("".join(f"{q}\t{d}\t{r}\n" for q, d, r in rows))
    assert ms.load_msmarco_run(fn) == jax_ms.load_msmarco_run(fn)
    assert ms.compute_metrics_from_files(trec_qrels=qrels, path_to_candidate=str(fn)) == \
        jax_ms.compute_metrics_from_files(trec_qrels=qrels, path_to_candidate=str(fn))
    assert outcome(lambda: ms.check_duplicates({"1": ["p1", "p1"]})) == \
        outcome(lambda: jax_ms.check_duplicates({"1": ["p1", "p1"]}))


def test_udel_and_chunker_equal_jax():
    from capreolus_tpu.analysis.chunker import content_spans as jax_content_spans
    from capreolus_tpu.utils.udel import udel_expand as jax_udel_expand
    from capreolus_tpu.utils.udel import udel_stopwords as jax_udel_stopwords
    from capreolus_tpu_torch.analysis.chunker import content_spans
    from capreolus_tpu_torch.utils.udel import udel_expand, udel_stopwords

    assert udel_stopwords() == jax_udel_stopwords() and len(udel_stopwords()) > 400
    cases = [("coronavirus origin", "what is the origin of COVID-19?"),
             ("virus spread", "how does the coronavirus respond to changes in the weather"),
             ("according contrariwise masks", "what is known about mask effectiveness in 2020?"),
             ("", "")]
    for query, question in cases:
        assert udel_expand(query, question=question) == jax_udel_expand(query, question=question)
        assert content_spans(question) == jax_content_spans(question)


def test_trec_rendering_equals_jax(caches, tmp_path):
    from capreolus_tpu.index import Index as JaxIndex
    from capreolus_tpu.utils import trec as jax_trec
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.utils import trec

    assert trec.topic_to_trectxt("301", "t", "d", "n") == jax_trec.topic_to_trectxt("301", "t", "d", "n")
    assert trec.topic_to_trectxt("302", "t") == jax_trec.topic_to_trectxt("302", "t")
    assert trec.document_to_trectxt("D1", "text") == jax_trec.document_to_trectxt("D1", "text")
    ours = trec.index_to_trec_docs(Index.create("tpu", {"collection": {"name": "dummy"}}), tmp_path / "port", 2)
    ref = jax_trec.index_to_trec_docs(JaxIndex.create("tpu", {"collection": {"name": "dummy"}}), tmp_path / "jax", 2)
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in ref.iterdir()) and len(names) >= 2
    for n in names:
        assert (ours / n).read_text() == (ref / n).read_text()


def test_downloads_refuse_offline(tmp_path, monkeypatch):
    from capreolus_tpu.utils.common import hash_file as jax_hash_file
    from capreolus_tpu_torch.utils.common import download_file, hash_file

    monkeypatch.setenv("CAPREOLUS_OFFLINE", "1")
    with pytest.raises(OfflineEnvironmentError, match="offline"):
        download_file("https://example.invalid/x.txt", tmp_path / "x.txt")
    assert not (tmp_path / "x.txt").exists()
    present = tmp_path / "present.txt"
    present.write_text("already here")
    assert download_file("https://example.invalid/present.txt", present) == present  # no network needed
    assert hash_file(present) == jax_hash_file(present) and hash_file(present, "md5") == jax_hash_file(present, "md5")
    with pytest.raises(OfflineEnvironmentError):  # a hash mismatch re-downloads, which offline refuses
        download_file("https://example.invalid/present.txt", present, expected_hash="0" * 64)


def test_tutorial_task_equals_jax(caches):
    port_task, jax_task = Task.create("tutorial", {}), JaxTask.create("tutorial", {})
    port_task.device = "cpu"
    ours, ref = port_task.run(), jax_task.run()
    assert ours["score"] == pytest.approx(ref["score"], abs=1e-12)
    assert [Path(p).parent.name for p in ours["path"].values()] == [Path(p).parent.name for p in ref["path"].values()]


@pytest.fixture(scope="module")
def robust04_small(tmp_path_factory):
    """A 1,500-doc corpus in Robust04's TREC layout with its qrels (phase 11's
    writer), and both packages' caches and results under one directory."""
    base = tmp_path_factory.mktemp("robust04_small")
    docs_dir, qrel_fn = robust04_shaped_corpus(str(base / "corpus"), num_docs=1500, seed=4, docs_per_file=400,
                                               min_len=60, max_len=200, bg_vocab=3000)
    packages = (("jax", jax_constants), ("torch", port_constants))
    saved = [(c["CACHE_BASE_PATH"], c["RESULTS_BASE_PATH"]) for _, c in packages]
    for name, consts in packages:
        consts["CACHE_BASE_PATH"], consts["RESULTS_BASE_PATH"] = base / f"{name}_cache", base / f"{name}_results"
    try:
        yield {"docs": docs_dir, "qrels": qrel_fn}
    finally:
        for (_, consts), (cache, results) in zip(packages, saved):
            consts["CACHE_BASE_PATH"], consts["RESULTS_BASE_PATH"] = cache, results


@pytest.mark.parametrize("searcher", sorted(ROBUST04_SEARCHERS))
def test_rank_searcheval_on_robust04_equals_jax(robust04_small, searcher):
    """``rank.searcheval`` with ``benchmark.name=robust04.yang19``, the
    shipped topics and five folds, ``benchmark.qrelfile`` and
    ``collection.path``: run files and cross-validated metrics as JAX's."""
    import contextlib
    import io

    config = {"benchmark": {"name": "robust04.yang19", "qrelfile": robust04_small["qrels"],
                            "collection": {"path": robust04_small["docs"]}},
              "searcher": ROBUST04_SEARCHERS[searcher]}
    port_task, jax_task = Task.create("rank", config), JaxTask.create("rank", config)
    port_task.device = "cpu"
    with contextlib.redirect_stdout(io.StringIO()):
        ours, ref = port_task.searcheval(), jax_task.searcheval()
    assert port_task.get_results_path().relative_to(port_constants["RESULTS_BASE_PATH"]) == \
        jax_task.get_results_path().relative_to(jax_constants["RESULTS_BASE_PATH"])
    exact = searcher == "BM25"
    assert_same_run_files(port_task.get_results_path() / "search", jax_task.get_results_path() / "search", exact)
    assert sorted(ours["score"]) == sorted(ref["score"])
    for metric, value in ref["score"].items():
        assert ours["score"][metric] == pytest.approx(value, abs=1e-12 if exact else 1e-4), metric
    assert 0.3 < ours["score"]["map"] <= 1.0
    assert len(port_task.benchmark.topics["title"]) == 250 and sorted(port_task.benchmark.folds) == [
        "s1", "s2", "s3", "s4", "s5"]
    shutil.rmtree(port_task.get_results_path() / "search")  # a second run of the module searches again
    shutil.rmtree(jax_task.get_results_path() / "search")
