"""The port's ir_datasets bridge (``capreolus_tpu_torch/utils/irds.py``)
against the JAX package's (``capreolus_tpu/utils/irds.py``), on the CPU, over
the seeded stand-in of ``tests/torch_irds_standin.py`` in ``sys.modules``
(nothing is downloaded).

Tolerances (stated per test):
- the gate's error, registered names, module paths, documents, topics,
  qrels, folds, run-file names and cross-validated metrics: equal;
- run files of ``rank.searcheval`` with BM25: the same docids per query in the
  same order, scores within 1e-6 relative plus 1e-6 absolute (a run file
  prints 6 decimals), the rule of ``tests/test_torch_rank.py``.
"""

import sys

import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.benchmark import Benchmark as JaxBenchmark  # noqa: E402
from capreolus_tpu.collection import Collection as JaxCollection  # noqa: E402
from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu.core import module_registry as jax_registry  # noqa: E402
from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu.task import Task as JaxTask  # noqa: E402
from capreolus_tpu.utils import irds as jax_irds  # noqa: E402
from capreolus_tpu_torch.benchmark import Benchmark  # noqa: E402
from capreolus_tpu_torch.collection import Collection  # noqa: E402
from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402
from capreolus_tpu_torch.core import module_registry as port_registry  # noqa: E402
from capreolus_tpu_torch.index import Index  # noqa: E402
from capreolus_tpu_torch.task import Task  # noqa: E402
from capreolus_tpu_torch.utils import irds  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_rank import _files, assert_same_run_files  # noqa: E402
from torch_irds_standin import DATASETS, PARENT, make_standin  # noqa: E402

PACKAGES = {"jax": (jax_irds, jax_registry), "torch": (irds, port_registry)}


@pytest.fixture
def registries():
    """Both registries as they were before the test, restored after it: the
    bridge registers modules process-wide."""
    saved = {name: {t: dict(d) for t, d in reg._registry.items()} for name, (_, reg) in PACKAGES.items()}
    yield
    for name, (_, reg) in PACKAGES.items():
        reg._registry.clear()
        reg._registry.update(saved[name])


@pytest.fixture
def standin(monkeypatch, registries):
    module = make_standin()
    monkeypatch.setitem(sys.modules, "ir_datasets", module)
    return module


@pytest.mark.parametrize("name", ["msmarco-passage/dev", "msmarco-passage", "antique/train/split200-valid",
                                  *DATASETS])
def test_parent_collection_name_as_in_jax(name):
    assert irds.dataset_to_collection(name) == jax_irds.dataset_to_collection(name)


@pytest.mark.parametrize("name", ["msmarco-passage/dev", DATASETS[0]])
def test_gate_raises_jax_error_without_ir_datasets(monkeypatch, registries, name):
    monkeypatch.setitem(sys.modules, "ir_datasets", None)  # an import of it raises ImportError
    messages = {}
    for package, (module, reg) in PACKAGES.items():
        before = {t: reg.get_module_names(t) for t in ("collection", "benchmark")}
        with pytest.raises(ImportError) as info:
            module.get_irds(name)
        messages[package] = str(info.value)
        assert {t: reg.get_module_names(t) for t in before} == before  # nothing registered
    assert messages["torch"] == messages["jax"]
    assert "ir_datasets" in messages["torch"]


@pytest.mark.parametrize("name", DATASETS)
def test_registered_names_as_in_jax(standin, name):
    got, want = irds.get_irds(name), jax_irds.get_irds(name)
    assert got == want == (f"irds.{PARENT}", f"irds.{name}")
    assert Collection.lookup(got[0]).collection_type == JaxCollection.lookup(want[0]).collection_type == "irds"
    assert Benchmark.lookup(got[1]).module_name == got[1]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_second_call_registers_nothing_and_datasets_share_a_collection(standin, package):
    module, reg = PACKAGES[package]
    names = [module.get_irds(name) for name in DATASETS]
    assert names[0][0] == names[1][0]  # one parent, one collection (and so one index)
    snapshot = {t: {n: reg.lookup(t, n) for n in reg.get_module_names(t)} for t in ("collection", "benchmark")}
    assert [module.get_irds(name) for name in DATASETS] == names
    assert {t: {n: reg.lookup(t, n) for n in reg.get_module_names(t)} for t in snapshot} == snapshot
    bench_cls = reg.lookup("benchmark", names[0][1])
    assert [dep.name for dep in bench_cls.dependencies] == [names[0][0]]


def _pair(name):
    """(port, JAX) benchmarks registered for ``name``."""
    _, bench_name = irds.get_irds(name)
    jax_irds.get_irds(name)
    return Benchmark.create(bench_name), JaxBenchmark.create(bench_name)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("part", ["topics", "qrels", "folds"])
def test_benchmark_parts_equal_jax(standin, torch_cache, tmpdir_as_cache, name, part):
    ours, ref = _pair(name)
    got, want = getattr(ours, part), getattr(ref, part)
    assert got == want and got
    if part == "topics":  # the title-only query of dataset b reads its title
        assert list(got) == ["title"] and len(got["title"]) == 8
    if part == "qrels":
        assert {grade for docs in got.values() for grade in docs.values()} == {0, 1, 2}
    assert ours.get_module_path() == ref.get_module_path()
    assert ours.get_topics_file().read_text() == ref.get_topics_file().read_text()


def test_title_only_query_reads_its_title(standin, torch_cache):
    ours, _ = _pair(DATASETS[1])
    query = next(q for q in standin.load(DATASETS[1]).queries_iter() if not hasattr(q, "text"))
    assert ours.topics["title"][query.query_id] == query.title


def test_documents_equal_jax_in_field_order(standin, torch_cache, tmpdir_as_cache):
    collection_name, _ = irds.get_irds(DATASETS[0])
    jax_irds.get_irds(DATASETS[0])
    ours, ref = Collection.create(collection_name), JaxCollection.create(collection_name)
    assert ours.get_path() is None and ref.get_path() is None
    got, want = list(ours.get_doc_iterator()), list(ref.get_doc_iterator())
    assert got == want and len(got) == 300
    doc = next(standin.load(PARENT).docs_iter())
    assert got[0] == (doc.doc_id, f"{doc.title} {doc.text}")  # title then text; wordcount is no str


def test_pathless_collection_index_equals_jax(standin, torch_cache, tmpdir_as_cache):
    collection_name, _ = irds.get_irds(DATASETS[0])
    jax_irds.get_irds(DATASETS[0])
    ours = Index.create("tpu", {"collection": {"name": collection_name}})
    ref = JaxIndex.create("tpu", {"collection": {"name": collection_name}})
    ours.create_index()
    ref.create_index()
    assert ours.get_module_path() == ref.get_module_path()
    docids = [doc.doc_id for doc in standin.load(PARENT).docs_iter()][:5]
    assert ours.get_docs(docids) == ref.get_docs(docids)
    for term in ("the", docids[0]):
        assert ours.get_df(term) == ref.get_df(term)


@pytest.mark.parametrize("name", DATASETS)
def test_rank_searcheval_bm25_matches_jax(standin, torch_cache, tmpdir_as_cache, name):
    _, bench_name = irds.get_irds(name)
    jax_irds.get_irds(name)
    config = {"benchmark": {"name": bench_name}, "searcher": {"name": "BM25", "hits": 100}}
    port_task, jax_task = Task.create("rank", config), JaxTask.create("rank", config)
    port_task.device = "cpu"
    # a "/" in the benchmark's name nests its results and cache in both packages alike
    assert (port_task.get_results_path().relative_to(port_constants["RESULTS_BASE_PATH"])
            == jax_task.get_results_path().relative_to(jax_constants["RESULTS_BASE_PATH"]))
    assert (port_task.get_cache_path().relative_to(port_constants["CACHE_BASE_PATH"])
            == jax_task.get_cache_path().relative_to(jax_constants["CACHE_BASE_PATH"]))
    got, want = port_task.searcheval(), jax_task.searcheval()
    port_out, jax_out = port_task.get_results_path() / "search", jax_task.get_results_path() / "search"
    assert _files(port_out) == _files(jax_out) == ["done", "searcher_BM25_b-0.4_k1-0.9"]
    assert_same_run_files(port_out, jax_out)
    assert got["score"] == want["score"] and 0.3 < got["score"]["map"] < 1
