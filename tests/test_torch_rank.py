"""Slice 8 module by module: the PyTorch port's config parsing, module paths,
sparse searchers, forward index, evaluation, rank task and CLI against the
JAX package's, on the CPU.

Tolerances (stated per test):
- config dicts, module paths, run-file names, eval metrics (1e-12) and the
  CLI's printed dict: equal;
- run files of the exact searchers (BM25, BM25Grid, the QL and DFR models,
  msmarcopsgbm25, BM25Postprocess): the same docids per query in the same
  order, scores within 1e-6 relative plus 1e-6 absolute (a run file prints 6
  decimals). Both sides score in f32; XLA's CPU backend contracts a multiply
  and an add into one FMA where torch rounds twice (ROADMAP "Recorded
  differences": BM25 ~2e-7 relative, QL/DFR ~1e-7 absolute);
- SPL's and the two-stage searchers' run files (BM25RM3, BM25PRF, axiomatic,
  SDM, fusion): equal but for near-ties, where two docs that trade places score
  within 1e-5 of the query's top score in both runs. SPL's ``-log`` of a
  difference of near-equal powers cancels most digits (ROADMAP); the
  two-stage searchers build their second stage from first-stage f32 scores
  that may differ in the last bit, which moves expansion weights and window
  sums by as much;
- ColBERT through the rank task: 1e-2, ``tests/test_torch_colbert.py``'s.

The corpus is a 4,000-doc draw of the JAX suite's golden recipe
(``chip_smoke.golden_corpus``) with its 25 topics.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

import capreolus_tpu.run as jax_run  # noqa: E402
import capreolus_tpu_torch.run as port_run  # noqa: E402
from capreolus_tpu.core import config_list_to_dict as jax_config_list_to_dict  # noqa: E402
from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu.core.config import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.core.config import ConfigOption as JaxConfigOption  # noqa: E402
from capreolus_tpu.evaluation import search_best_run as jax_search_best_run  # noqa: E402
from capreolus_tpu.evaluation.metrics import eval_run as jax_eval_run  # noqa: E402
from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.task import Task as JaxTask  # noqa: E402
from capreolus_tpu.utils.trec import load_trec_run as jax_load_trec_run  # noqa: E402
from capreolus_tpu_torch.core import ConfigError, ConfigOption, config_list_to_dict  # noqa: E402
from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402
from capreolus_tpu_torch.core.queue import DBManager  # noqa: E402
from capreolus_tpu_torch.evaluation import DEFAULT_METRICS, search_best_run  # noqa: E402
from capreolus_tpu_torch.evaluation.metrics import eval_run  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from capreolus_tpu_torch.searcher import tpu as port_tpu  # noqa: E402
from capreolus_tpu_torch.task import Task as TorchTask  # noqa: E402
from capreolus_tpu_torch.task.rank import place_searchers  # noqa: E402
from capreolus_tpu_torch.utils.trec import load_trec_run  # noqa: E402
from chip_smoke import golden_corpus, run_faults, write_golden  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401

SCORE_RTOL = 1e-6
RUN_FILE_ATOL = 1e-6  # a run file prints 6 decimals
NEAR_TIE_RTOL = 1e-5
SMALL_DOCS = 4000
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- config parsing
CAST_CASES = [
    ("floatlist", "0.9,1.2"), ("floatlist", "0.4..1,0.2"), ("floatlist", "0.1..0.3"), ("floatlist", 0.5),
    ("floatlist", [1, 2.5]), ("intlist", "0..12,1"), ("intlist", "5,25"), ("intlist", "3..3"),
    ("strlist", "default"), ("strlist", "map,P_10"), ("str", "none"), ("str", "None"), ("str", "null"),
    ("int", "none"), ("float", "1e-3"), ("bool", "true"), ("bool", "False"), ("bool", "0"), ("bool", "yes"),
    ("bool", ""), ("int", "7"),
]


@pytest.mark.parametrize("value_type,raw", CAST_CASES, ids=[f"{t}-{r}" for t, r in CAST_CASES])
def test_option_casts_equal_jax(value_type, raw):
    got = ConfigOption("x", raw, value_type=value_type).default_value
    want = JaxConfigOption("x", raw, value_type=value_type).default_value
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("value_type,raw", [("floatlist", "1..0"), ("intlist", "0..4,-1"), ("bool", "maybe")])
def test_bad_option_values_raise_as_in_jax(value_type, raw):
    with pytest.raises(JaxConfigError):
        JaxConfigOption("x", raw, value_type=value_type)
    with pytest.raises(ConfigError):
        ConfigOption("x", raw, value_type=value_type)


CONFIG_STRINGS = [
    "searcher.name=BM25 searcher.k1=0.9,1.2 searcher.b=0.4",
    "searcher.k1=0.1..0.5,0.2 searcher.b=0.3..0.5,0.1 searcher.hits=100",
    "searcher.name=BM25RM3 searcher.fbTerms=0..12,4 searcher.fbDocs=5",
    "filter=true searcher.name=SDM searcher.index.storepositions=True searcher.uws=4",
    "benchmark.name=dummy benchmark.collection.path=none metrics=map,P_10 optimize=P_10",
    "searcher=fusion searcher.searcher2.name=QLDirichlet searcher.method=interp searcher.alpha=0.3",
    "searcher.name=QLDirichlet searcher.mu=500,1000 searcher.index.stemmer=none searcher.index.indexstops=yes",
]


@pytest.mark.parametrize("config_string", CONFIG_STRINGS)
def test_config_strings_parse_and_instantiate_as_in_jax(tmpdir_as_cache, torch_cache, config_string):
    pairs = config_string.split()
    config = config_list_to_dict(pairs)
    assert config == jax_config_list_to_dict(pairs)
    port_task = TorchTask.create("rank", config)
    jax_task = JaxTask.create("rank", jax_config_list_to_dict(pairs))
    assert port_task.config == jax_task.config


def test_config_file_loads_as_in_jax(tmp_path):
    fn = tmp_path / "config.txt"
    fn.write_text("# a comment\n\nsearcher.name=BM25\n  searcher.k1=0.8,0.9  \nbenchmark.name=dummy\n")
    assert port_run._load_config_file(fn) == jax_run._load_config_file(fn)
    assert config_list_to_dict(port_run._load_config_file(fn)) == jax_config_list_to_dict(jax_run._load_config_file(fn))


@pytest.mark.parametrize("path", sorted((ROOT / "docs" / "reproduction" / "configs").glob("config_*.txt")),
                         ids=lambda p: p.name)
def test_reference_config_files_parse_as_in_jax(path):
    pairs = port_run._load_config_file(path)
    assert pairs == jax_run._load_config_file(path)
    assert config_list_to_dict(pairs) == jax_config_list_to_dict(pairs)


# ---------------------------------------------------------------- module paths and run-file names
PATH_CASES = {
    "bm25": {"searcher": {"name": "BM25"}},
    "grid": {"searcher": {"name": "BM25", "k1": "0.8,0.9", "b": "0.3..0.5,0.1"}},
    "rm3": {"searcher": {"name": "BM25RM3", "fbTerms": "5,10", "fbDocs": "2"}},
    "sdm": {"searcher": {"name": "SDM"}},
    "fusion": {"searcher": {"name": "fusion", "searcher2": {"name": "QLDirichlet"}}},
    "filter": {"filter": True, "searcher": {"name": "BM25", "k1": "0.9,1.0"}},
}


def _files(directory):
    return sorted(str(p.relative_to(directory)) for p in Path(directory).rglob("*") if p.is_file())


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_module_paths_and_run_file_names_equal_jax(tmpdir_as_cache, torch_cache, case):
    config = {"benchmark": {"name": "dummy"}, **PATH_CASES[case]}
    port_task, jax_task = TorchTask.create("rank", config), JaxTask.create("rank", config)
    port_task.device = "cpu"
    assert (port_task.get_results_path().relative_to(port_constants["RESULTS_BASE_PATH"])
            == jax_task.get_results_path().relative_to(jax_constants["RESULTS_BASE_PATH"]))
    assert (port_task.get_cache_path().relative_to(port_constants["CACHE_BASE_PATH"])
            == jax_task.get_cache_path().relative_to(jax_constants["CACHE_BASE_PATH"]))
    assert port_task.searcher.get_module_path() == jax_task.searcher.get_module_path()
    port_out, jax_out = port_task.search(), jax_task.search()
    assert _files(port_out) == _files(jax_out) and "done" in _files(port_out)
    if case == "filter":  # the qrels' docs left the runs
        for fn in _files(port_out):
            if fn != "done":
                assert load_trec_run(port_out / fn) == jax_load_trec_run(jax_out / fn)


def test_fusion_legs_take_the_task_device(torch_cache):
    task = TorchTask.create("rank", {"benchmark": {"name": "dummy"}, **PATH_CASES["fusion"]})
    task.device = "cpu"
    task.search()
    assert task.searcher.device == task.searcher.searcher1.device == task.searcher.searcher2.device == "cpu"


# ---------------------------------------------------------------- searchers on a small golden-recipe corpus
@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 4,000-doc golden-recipe corpus with the 25 topics, and both packages'
    caches pointed at the module's tmpdir."""
    base = tmp_path_factory.mktemp("torch_rank_small")
    docs, topics, qrels = golden_corpus(num_docs=SMALL_DOCS)
    corpus_dir, qrel_fn, topic_fn = write_golden(docs, topics, qrels, str(base))
    packages = (("jax", jax_constants), ("torch", port_constants))
    saved = [(c["CACHE_BASE_PATH"], c["RESULTS_BASE_PATH"]) for _, c in packages]
    for name, consts in packages:
        consts["CACHE_BASE_PATH"], consts["RESULTS_BASE_PATH"] = base / f"{name}_cache", base / f"{name}_results"
    try:
        yield {"base": base, "collection": {"name": "dummy", "path": corpus_dir}, "topics": Path(topic_fn),
               "qrels": qrels}
    finally:
        for (_, consts), (cache, results) in zip(packages, saved):
            consts["CACHE_BASE_PATH"], consts["RESULTS_BASE_PATH"] = cache, results


def assert_same_run_files(port_dir, jax_dir, exact=True):
    names = _files(port_dir)
    assert names == _files(jax_dir) and "done" in names
    swaps = 0
    for name in names:
        if Path(name).name == "done":
            continue
        port, ref = load_trec_run(port_dir / name), jax_load_trec_run(jax_dir / name)
        assert list(port) == list(ref), name
        if exact:
            for qid in ref:
                assert list(port[qid]) == list(ref[qid]), (name, qid)
                np.testing.assert_allclose(list(port[qid].values()), list(ref[qid].values()),
                                           rtol=SCORE_RTOL, atol=RUN_FILE_ATOL, err_msg=f"{name} {qid}")
        else:
            assert not run_faults({name: port}, {name: ref}, NEAR_TIE_RTOL, RUN_FILE_ATOL), name
            swaps += sum(list(port[q]) != list(ref[q]) for q in ref)
    return swaps


SEARCHER_CASES = {
    "BM25": ({"name": "BM25", "k1": "0.9,1.2", "b": "0.4,0.75", "hits": 200}, True),
    "BM25Grid": ({"name": "BM25Grid", "k1min": 0.5, "k1max": 0.7, "bmin": 0.3, "bmax": 0.4, "hits": 100}, True),
    "QLDirichlet": ({"name": "QLDirichlet", "mu": "500,1000", "hits": 200}, True),
    "QLJM": ({"name": "QLJM", "lam": "0.1,0.7", "hits": 200}, True),
    "INL2": ({"name": "INL2", "hits": 200}, True),
    "SPL": ({"name": "SPL", "hits": 200}, False),
    "F2Exp": ({"name": "F2Exp", "hits": 200}, True),
    "F2Log": ({"name": "F2Log", "hits": 200}, True),
    "DirichletQL": ({"name": "DirichletQL", "hits": 200}, True),
    "BM25Postprocess": ({"name": "BM25Postprocess", "hits": 200, "topn": 50}, True),
    "BM25RM3": ({"name": "BM25RM3", "fbTerms": "5,25", "fbDocs": "5,10", "hits": 200}, False),
    "BM25PRF": ({"name": "BM25PRF", "k1": "0.7", "b": "0.6", "fbTerms": "20", "fbDocs": "5,10",
                 "newTermWeight": "0.2", "hits": 200}, False),
    "axiomatic": ({"name": "axiomatic", "r": "5", "n": "3", "top": "10", "hits": 200}, False),
    "SDM-bm25": ({"name": "SDM", "hits": 200}, False),
    "SDM-qld": ({"name": "SDM", "unigram": "qld", "mu": "500,1000", "hits": 200}, False),
    "fusion-rrf": ({"name": "fusion", "searcher1": {"name": "BM25", "hits": 200},
                    "searcher2": {"name": "QLDirichlet", "hits": 200}, "hits": 200}, False),
    "fusion-interp": ({"name": "fusion", "method": "interp", "alpha": 0.3,
                       "searcher1": {"name": "BM25", "k1": "0.9,1.2"}, "searcher2": {"name": "INL2"},
                       "hits": 100}, False),
}


def _with_collection(config, collection):
    config = dict(config)
    if config["name"] == "fusion":
        for leg in ("searcher1", "searcher2"):
            config[leg] = {**config[leg], "index": {"collection": collection}}
    else:
        config["index"] = {**config.get("index", {}), "collection": collection}
    return config


@pytest.mark.parametrize("case", sorted(SEARCHER_CASES))
def test_searcher_run_files_match_jax(small, case):
    config, exact = SEARCHER_CASES[case]
    config = _with_collection(config, small["collection"])
    jax_searcher, port_searcher = JaxSearcher.create(config["name"], config), TorchSearcher.create(config["name"], config)
    place_searchers(port_searcher, "cpu")
    for searcher in (jax_searcher, port_searcher):
        if hasattr(searcher, "index"):
            searcher.index.create_index()
    out = small["base"] / "runs" / case
    port_dir = port_searcher.query_from_file(small["topics"], out / "port")
    jax_dir = jax_searcher.query_from_file(small["topics"], out / "jax")
    swaps = assert_same_run_files(port_dir, jax_dir, exact=exact)
    print(f"{case}: {len(_files(port_dir)) - 1} run file(s), queries whose order differs by near-ties: {swaps}")
    runs = [load_trec_run(port_dir / n) for n in _files(port_dir) if n != "done" and "/" not in n]
    assert runs and all(len(run) == 25 and all(run.values()) for run in runs)


def test_msmarcopsgbm25_is_bm25_at_its_settings(small):
    """The JAX ``msmarcopsgbm25`` fails with KeyError 'shards' (its config has no
    ``shards`` and its search reads one); the port's searches, as the JAX BM25
    does at k1=0.82, b=0.68."""
    collection = {"index": {"collection": small["collection"]}}
    jax_ms = JaxSearcher.create("msmarcopsgbm25", collection)
    jax_ms.index.create_index()
    with pytest.raises(KeyError, match="shards"):
        jax_ms.query_from_file(small["topics"], small["base"] / "runs" / "ms" / "jax_fails")
    port = TorchSearcher.create("msmarcopsgbm25", collection)
    port.device = "cpu"
    port_dir = port.query_from_file(small["topics"], small["base"] / "runs" / "ms" / "port")
    jax_bm25 = JaxSearcher.create("BM25", {**collection, "k1": 0.82, "b": 0.68})
    jax_dir = jax_bm25.query_from_file(small["topics"], small["base"] / "runs" / "ms" / "jax_bm25")
    assert _files(port_dir) == ["done", "searcher_msmarcopsgbm25_b-0.68_k1-0.82"]
    (port_dir / "done").unlink()
    os.rename(port_dir / "searcher_msmarcopsgbm25_b-0.68_k1-0.82", port_dir / "searcher_BM25_b-0.68_k1-0.82")
    (port_dir / "done").write_text("done")
    assert_same_run_files(port_dir, jax_dir)


def test_static_run_searcher_hands_back_its_runfile_as_jax(tmp_path):
    from capreolus_tpu.searcher.special import StaticRunSearcher as JaxStaticRun
    from capreolus_tpu_torch.searcher.special import StaticRunSearcher

    runfile = tmp_path / "given.run"
    runfile.write_text("301 Q0 D001 1 2.5 tag\n301 Q0 D002 2 1.5 tag\n")
    outs = []
    for base, name in ((JaxStaticRun, "jax"), (StaticRunSearcher, "port")):
        static = type(f"StaticRun_{name}", (base,), {"module_name": "static_test"})
        searcher = static._instantiate({"runfile": str(runfile)}, {})
        outs.append(searcher.query_from_file(tmp_path / "topics.tsv", tmp_path / name))
        with pytest.raises(IOError, match="runfile"):
            static._instantiate({}, {}).query_from_file(tmp_path / "topics.tsv", tmp_path / f"{name}_none")
    assert _files(outs[0]) == _files(outs[1]) == ["done", "static_run"]
    assert (outs[1] / "static_run").read_text() == runfile.read_text()


@pytest.mark.parametrize("storepositions", [False, True])
def test_forward_index_equals_jax(small, storepositions):
    config = {"storepositions": storepositions, "collection": small["collection"]}
    jax_index, port_index = JaxIndex.create("tpu", config), TorchIndex.create("tpu", config)
    jd, td = jax_index.data, port_index.data
    assert td.vocab == jd.vocab
    for name in ("fwd_offsets", "fwd_term_ids", "fwd_tfs"):
        np.testing.assert_array_equal(np.asarray(getattr(td, name)), np.asarray(getattr(jd, name)), err_msg=name)
    assert port_index.get_module_path() == jax_index.get_module_path()
    if storepositions:
        for ordinal in range(td.num_docs):
            np.testing.assert_array_equal(port_index.get_doc_term_ids(ordinal), jax_index.get_doc_term_ids(ordinal))
    else:
        with pytest.raises(ValueError, match="storepositions"):
            port_index.get_doc_term_ids(0)


def test_an_index_of_the_older_layout_is_rebuilt(torch_cache):
    """Layout v1 had no forward index: such a cache is rebuilt in place on load."""
    from capreolus_tpu_torch.index import tpu as port_index_tpu

    index = TorchIndex.create("tpu", {"collection": {"name": "dummy"}})
    index.create_index()
    npz_fn = index.get_index_path() / "postings.npz"
    with np.load(npz_fn) as npz:
        arrays = {k: npz[k] for k in npz.files if k != "fwd_offsets"}
    np.savez(npz_fn, **{**arrays, "layout_version": np.int64(1)})
    (index.get_index_path() / "postings_fwd_tfs.npy").unlink()
    data = TorchIndex.create("tpu", {"collection": {"name": "dummy"}}).data
    with np.load(npz_fn) as npz:
        assert int(npz["layout_version"]) == port_index_tpu.LAYOUT_VERSION == 2
    assert data.fwd_offsets[-1] == len(data.fwd_tfs) == len(data.doc_ids) > 0


# ---------------------------------------------------------------- the accumulator budget
@pytest.mark.parametrize("num_queries,grid_size,num_docs,budget", [
    (25, 100, 50_000, 1 << 26), (64, 100, 528_155, 1 << 26), (64, 1, 8_841_823, 1 << 26),
    (25, 9, 4000, 3 * 4001), (25, 9, 4000, 4 * 9 * 4001), (7, 1, 10, 10**9), (1, 1, 10**8, 1 << 26),
])
def test_engine_call_plan_covers_each_row_once_under_the_budget(num_queries, grid_size, num_docs, budget):
    plan = port_tpu.plan_engine_calls(num_queries, grid_size, num_docs, budget)
    cover = np.zeros((num_queries, grid_size), np.int64)
    for q0, q1, g0, g1 in plan:
        cover[q0:q1, g0:g1] += 1
        assert (q1 - q0) * (g1 - g0) * (num_docs + 1) <= max(budget, num_docs + 1)
    assert (cover == 1).all()
    # queries are split before grid points; each grid point's queries come in their order
    assert len({(g0, g1) for _, _, g0, g1 in plan}) == 1 or all(q1 - q0 == 1 for q0, q1, _, _ in plan)
    assert plan == sorted(plan)


@pytest.mark.parametrize("budget_rows", [3, 36])  # 75 calls (queries and grid split), 7 calls (queries)
def test_grid_split_is_byte_identical(small, monkeypatch, budget_rows):
    config = _with_collection({"name": "BM25", "k1": "0.6,0.9,1.2", "b": "0.3,0.5,0.75", "hits": 100},
                              small["collection"])
    outs = {}
    for label, budget in (("whole", port_tpu.ACC_BUDGET_ELEMENTS), ("split", budget_rows * (SMALL_DOCS + 1))):
        monkeypatch.setattr(port_tpu, "ACC_BUDGET_ELEMENTS", budget)
        searcher = TorchSearcher.create("BM25", config)
        searcher.device = "cpu"
        outs[label] = searcher.query_from_file(small["topics"], small["base"] / "split" / f"{label}{budget_rows}")
        outs[label + "_calls"] = searcher.engine_calls
    assert outs["whole_calls"] == 1 and outs["split_calls"] == {3: 75, 36: 7}[budget_rows]
    names = _files(outs["whole"])
    assert names == _files(outs["split"]) and len(names) == 10
    for name in names:
        assert (outs["whole"] / name).read_bytes() == (outs["split"] / name).read_bytes(), name


# ---------------------------------------------------------------- evaluation
def _seeded_runs_and_qrels(seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    docs = [f"D{i:03d}" for i in range(300)]
    run, qrels = {}, {}
    for q in range(40):
        qid = str(300 + q)
        picked = rng.choice(300, size=int(rng.integers(5, 200)), replace=False)
        scores = np.round(rng.standard_normal(len(picked)), 1)  # ties, broken by docid
        run[qid] = {docs[d]: float(s) for d, s in zip(picked, scores)}
        if q % 9 != 8:  # some run queries have no qrels
            judged = rng.choice(300, size=int(rng.integers(1, 60)), replace=False)
            grades = rng.integers(-1, 3, size=len(judged)) if q % 7 else np.zeros(len(judged), np.int64)
            qrels[qid] = {docs[d]: int(g) for d, g in zip(judged, grades)}
    qrels["999"] = {"D001": 1}  # a qrels query missing from the run
    return run, qrels


EVAL_METRICS = DEFAULT_METRICS[:-1] + ["map_cut_100", "Rprec", "bpref", "ndcg", "success_5", "set_P",
                                       "set_recall", "set_F"]


@pytest.mark.parametrize("relevance_level", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_eval_run_equals_jax(seed, relevance_level):
    run, qrels = _seeded_runs_and_qrels(seed)
    got = eval_run(run, qrels, EVAL_METRICS, relevance_level=relevance_level)
    want = jax_eval_run(run, qrels, EVAL_METRICS, relevance_level=relevance_level)
    assert set(got) == set(want) == set(EVAL_METRICS)
    for metric in EVAL_METRICS:
        assert abs(got[metric] - want[metric]) <= 1e-12, metric
    per_query = eval_run(run, qrels, EVAL_METRICS, relevance_level=relevance_level, average=False)
    assert per_query == jax_eval_run(run, qrels, EVAL_METRICS, relevance_level=relevance_level, average=False)


class _Folds:
    """A benchmark as search_best_run reads one: qrels, folds, non_nn_dev, relevance_level."""

    relevance_level = 1

    def __init__(self, qrels):
        qids = sorted(qrels)
        self.qrels = qrels
        self.folds = {f"s{i}": {"train_qids": qids[i::3][:4], "predict": {"dev": qids[(i + 1)::3][:6],
                                                                          "test": qids[(i + 2)::3]}}
                      for i in range(3)}
        self.non_nn_dev = {name: fold["predict"]["dev"] + fold["train_qids"] for name, fold in self.folds.items()}


def test_search_best_run_picks_the_same_runs_as_jax(tmp_path):
    from capreolus_tpu_torch.utils.trec import write_trec_run

    _, qrels = _seeded_runs_and_qrels(3)
    for k in range(4):
        write_trec_run(_seeded_runs_and_qrels(10 + k)[0], tmp_path / f"searcher_run{k}")
    (tmp_path / "done").write_text("done")
    (tmp_path / "searcher1").mkdir()  # a fusion leg's directory is skipped
    benchmark = _Folds(qrels)
    got = search_best_run(tmp_path, benchmark, "map", metrics=DEFAULT_METRICS)
    want = jax_search_best_run(tmp_path, benchmark, "map", metrics=DEFAULT_METRICS)
    assert got["path"] == want["path"] and len(set(got["path"].values())) > 1
    assert got["score"].keys() == want["score"].keys()
    for metric, value in want["score"].items():
        assert abs(got["score"][metric] - value) <= 1e-12, metric


# ---------------------------------------------------------------- the rank task
def test_second_search_writes_nothing(torch_cache, monkeypatch):
    task = TorchTask.create("rank", {"benchmark": {"name": "dummy"}})
    task.device = "cpu"
    out = task.search()
    before = {n: (out / n).stat().st_mtime_ns for n in _files(out)}

    def fail(*args, **kwargs):
        raise AssertionError("searched again")

    monkeypatch.setattr(type(task.searcher), "_search_all", fail)
    assert task.search() == out
    assert {n: (out / n).stat().st_mtime_ns for n in _files(out)} == before


@pytest.mark.parametrize("searcher,match", [
    ({"name": "BM25", "maxpostings": 2}, "item 5"),
    ({"name": "BM25", "shards": 2}, "item 6, 'Multi-device'"),
    ({"name": "fusion"}, "item 6, 'Dense and learned-sparse retrieval'"),  # searcher2 defaults to dense
])
def test_unported_options_raise(torch_cache, searcher, match):
    with pytest.raises(ConfigError, match=match):
        TorchTask.create("rank", {"benchmark": {"name": "dummy"}, "searcher": searcher})


def test_rank_task_without_a_device_asks_for_the_card(torch_cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    task = TorchTask.create("rank", {"benchmark": {"name": "dummy"}})
    assert task.device is None
    with pytest.raises(RuntimeError, match="cuda"):
        task.searcheval()


def test_colbert_through_the_rank_task_matches_jax(tmpdir_as_cache, torch_cache):
    from test_torch_colbert import SEARCHER, assert_same_run, jax_tiny_checkpoint

    config = {k: v for k, v in SEARCHER.items() if k != "index"}
    jax_task = JaxTask.create("rank", {"benchmark": {"name": "dummy"},
                                       "searcher": {**config, "name": "colbert", "allowrandominit": True}})
    ckpt = jax_tiny_checkpoint(jax_task.searcher, torch_cache / "colbert.npz")
    port_task = TorchTask.create("rank", {"benchmark": {"name": "dummy"},
                                          "searcher": {**config, "name": "colbert", "checkpointfile": ckpt}})
    port_task.device = "cpu"
    port_out, jax_out = port_task.search(), jax_task.search()
    assert _files(port_out) == _files(jax_out) == ["done", "searcher_colbert_dim-8"]
    port, ref = load_trec_run(port_out / "searcher_colbert_dim-8"), jax_load_trec_run(jax_out / "searcher_colbert_dim-8")
    assert list(port) == list(ref) == ["301", "302"]
    for qid in ref:
        assert_same_run(port[qid], ref[qid], f"colbert rank.search {qid}")


# ---------------------------------------------------------------- the CLI
def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_cli_prints_the_jax_dict(tmpdir_as_cache, torch_cache, capsys):
    args = ["rank.searcheval", "with", "benchmark.name=dummy", "searcher.name=BM25"]
    assert port_run.main(args + ["--device=cpu"]) == 0
    port_line = _last_line(capsys)
    assert jax_run.main(args) == 0
    assert port_line == _last_line(capsys)
    assert "'map': 1.0" in port_line


def test_cli_help_and_module_listing(torch_cache, capsys):
    assert port_run.main(["help", "rank"]) == 0
    out = capsys.readouterr().out
    assert "usage:" in out and "task=rank" in out and "--device=cpu|cuda" in out
    assert port_run.main(["modules.list_modules", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("module type=benchmark", "module type=task", "name=BM25RM3", "name=SDM", "name=fusion",
                 "name=msmarcopsgbm25", "name=rank"):
        assert line in out
    with pytest.raises(ConfigError, match="--device"):
        port_run.main(["modules.list_modules", "--device=tpu"])


def test_cli_queue_then_worker(torch_cache, monkeypatch, capsys):
    monkeypatch.setenv("CAPREOLUS_DB", str(torch_cache / "queue.sqlite"))
    args = ["rank.searcheval", "with", "benchmark.name=dummy", "searcher.name=BM25", "searcher.k1=1.1"]
    assert port_run.main(args + ["--queue", "--priority=3"]) == 0
    assert DBManager().list_runs() == [(1, "rank.searcheval", 3, "queued")]
    assert port_run.main(["worker", "--device=cpu"]) == 0
    assert DBManager().list_runs() == [(1, "rank.searcheval", 3, "done")]
    results = list(Path(port_constants["RESULTS_BASE_PATH"]).rglob("searcher_BM25_b-0.4_k1-1.1"))
    assert len(results) == 1 and load_trec_run(results[0])["301"]
