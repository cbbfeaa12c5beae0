"""The PyTorch port's doc-sharded sparse search (``parallel/``) against the JAX
package's, on the CPU: JAX on its forced 8-device host mesh, the port on a
mesh of ``torch.device("cpu")`` repeated S times.

- ``make_mesh``: the -1 wildcard, and a ``ValueError`` with JAX's wording
  when the devices are too few;
- ``init_distributed``: a no-op for one process, one ``init_process_group``
  call from explicit arguments or a launcher's environment;
- ``merge_shard_candidates``: ties across and within shards to the lower
  global ordinal;
- ``ShardedDeviceIndex``'s tiles (doc ids, tfs, both doc-length payloads) and
  term offsets, and ``build_work_units``' packed [S, 5, nq*uw] array, EQUAL to
  JAX's bit for bit at S = 2, 3 and 4 (N not divisible by S);
- ``sharded_search`` for every scoring model against JAX's ``sharded_search``
  and against the port's single-device engine: scores within 1e-5 relative,
  the same doc at each rank but for near-ties within 1e-5 (the single-device
  engine is held to the Lucene tie-break exactly);
- BM25 ``shards=4`` run files against ``shards=1``;
- ``RetrievalService(shards=4)`` against the single-device service, then add
  -> refresh() -> served -> delete -> refresh() -> gone, as
  ``tests/test_serving.py::test_sharded_retrieval_service`` holds JAX's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.parallel import ShardedDeviceIndex as JaxShardedIndex  # noqa: E402
from capreolus_tpu.parallel import sharded_search as jax_sharded_search  # noqa: E402
from capreolus_tpu_torch.parallel import ShardedDeviceIndex, sharded_bm25_topk, sharded_search  # noqa: E402
from capreolus_tpu_torch.parallel import distributed  # noqa: E402
from capreolus_tpu_torch.parallel.distributed import init_distributed, make_mesh  # noqa: E402
from capreolus_tpu_torch.parallel.sharded_search import merge_shard_candidates  # noqa: E402
from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine  # noqa: E402
from chip_smoke import ranking_rows_faults  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_tiered import MODEL_PARAMS, corpus, random_queries  # noqa: E402

RTOL = 1e-5
CPU = torch.device("cpu")


def port_mesh(shards):
    return make_mesh({"shard": shards}, [CPU] * shards)


def jax_mesh(shards):
    return JaxMesh(np.array(jax.devices()[:shards]), ("shard",))


@pytest.fixture(scope="module")
def world():
    jdata, pdata, rng = corpus(seed=5, num_docs=3001, nnz=40_000)
    queries = random_queries(jdata, rng, sizes=(1, 2, 3, 5), per_size=2) + [[]]
    return {"jdata": jdata, "pdata": pdata, "queries": queries,
            "engine": ScoringEngine(DeviceIndex(pdata, "cpu"))}


def test_make_mesh_wildcard_and_too_few_devices():
    mesh = make_mesh({"shard": 2, "data": -1}, [CPU] * 6)
    assert mesh.shape == {"shard": 2, "data": 3} and mesh.devices.shape == (2, 3)
    assert mesh.axis_devices("shard") == [CPU, CPU]
    assert make_mesh({"data": -1}, ["cpu"] * 5).shape == {"data": 5}
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 3"):
        make_mesh({"shard": 4}, [CPU] * 3)
    with pytest.raises(ValueError, match="only one axis may be -1"):
        make_mesh({"a": -1, "b": -1}, [CPU] * 4)


@pytest.mark.parametrize("how", ["single_process", "explicit", "launcher_env"])
def test_init_distributed(monkeypatch, how):
    """A no-op for one process, as JAX's; otherwise one call of
    ``init_process_group`` (gloo without a card) from the explicit
    coordinator or a launcher's environment; idempotent."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(distributed, "_initialized", False)
    for name in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    if how == "launcher_env":
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("WORLD_SIZE", "2")
    args = ("localhost:1234", 2, 1) if how == "explicit" else ()
    init_distributed(*args)
    init_distributed(*args)
    want = {"single_process": [],
            "explicit": [(("gloo",), {"init_method": "tcp://localhost:1234", "world_size": 2, "rank": 1})],
            "launcher_env": [(("gloo",), {"init_method": "env://"})]}[how]
    assert calls == want


def test_merge_shard_candidates_ties_to_the_lower_ordinal():
    """Equal scores across and within shards come out in ascending global
    ordinal, as a (score desc, ordinal asc) sort of all candidates orders them."""
    rng = np.random.default_rng(3)
    shards, local_k, per, hits = 3, 6, 10, 8
    cands, flat_s, flat_o = [], [], []
    for sh in range(shards):
        scores = rng.integers(0, 3, size=(2, per)).astype(np.float32)  # many ties
        order = np.lexsort((np.arange(per)[None].repeat(2, 0), -scores), axis=1)[:, :local_k]
        sv = np.take_along_axis(scores, order, 1)
        cands.append((torch.from_numpy(sv), torch.from_numpy(order + sh * per)))
        flat_s.append(sv)
        flat_o.append(order + sh * per)
    ms, mo = merge_shard_candidates(cands, hits, CPU)
    s_all, o_all = np.concatenate(flat_s, 1), np.concatenate(flat_o, 1)
    want = np.lexsort((o_all, -s_all), axis=1)[:, :hits]
    np.testing.assert_array_equal(mo.numpy(), np.take_along_axis(o_all, want, 1))
    np.testing.assert_array_equal(ms.numpy(), np.take_along_axis(s_all, want, 1))


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_index_and_work_units_equal_jax(world, shards):
    ours = ShardedDeviceIndex(world["pdata"], port_mesh(shards))
    ref = JaxShardedIndex(world["jdata"], jax_mesh(shards))
    assert world["pdata"].num_docs % shards  # N not divisible by S
    assert ours.docs_per_shard == ref.docs_per_shard and ours.num_shards == ref.num_shards == shards
    for name in ("doc_tiles", "tf_tiles", "norm_dl_tiles", "exact_dl_tiles"):
        got = torch.stack(getattr(ours, name)).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    np.testing.assert_array_equal(ours.term_offsets, ref.term_offsets)
    for model in ("bm25", "qld", "inl2", "spl"):
        packed, uw, r_max = ours.build_work_units(world["queries"], model=model)
        want, want_uw, want_r = ref.build_work_units(world["queries"], model=model)
        assert (uw, r_max) == (want_uw, want_r) and packed.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(packed, want, err_msg=model)


def assert_rows(got, want, what):
    faults = ranking_rows_faults(got, want, RTOL)
    assert not faults, (what, faults)


@pytest.mark.parametrize("model", sorted(MODEL_PARAMS))
def test_sharded_search_matches_jax_and_the_single_device_engine(world, model):
    shards, topk, params = 4, 50, MODEL_PARAMS[model]
    queries = world["queries"]
    ours = ShardedDeviceIndex(world["pdata"], port_mesh(shards))
    ref = JaxShardedIndex(world["jdata"], jax_mesh(shards))
    got = sharded_search(ours, ours.build_work_units(queries, model=model), len(queries), topk, model=model,
                         params=params)
    want = jax_sharded_search(ref, ref.build_work_units(queries, model=model), len(queries), topk, model=model,
                              params=params)
    assert got[0].dtype == np.float32 and got[0].shape == (len(queries), topk) and got[1].shape == want[1].shape
    assert_rows(got, (np.asarray(want[0]), np.asarray(want[1]).astype(got[1].dtype)), f"{model} vs JAX")
    single = world["engine"].search(queries, model=model, params=params, topk=topk, exact_topk=False)
    assert_rows(got, (single[0], single[1].astype(got[1].dtype)), f"{model} vs the single-device engine")
    # past the matching docs the merged rows carry the sentinel ordinal
    assert (got[1][got[0] <= 0] == world["pdata"].num_docs).all()
    assert (got[0][len(queries) - 1] <= 0).all()  # the empty query matches nothing


def test_unmaterialised_results_stay_on_the_first_device(world):
    ours = ShardedDeviceIndex(world["pdata"], port_mesh(3))
    queries = world["queries"][:4]
    units = ours.build_work_units(queries)
    scores, ords = sharded_bm25_topk(ours, units, len(queries), 20)
    lazy = sharded_search(ours, units, len(queries), 20, params={"k1": 0.9, "b": 0.4}, materialize=False)
    assert all(isinstance(t, torch.Tensor) and t.device == CPU for t in lazy)
    np.testing.assert_array_equal(lazy[0].numpy(), scores)
    np.testing.assert_array_equal(lazy[1].numpy(), ords)


def _run(path):
    from capreolus_tpu_torch.utils.trec import load_trec_run

    return load_trec_run(next(f for f in path.iterdir() if f.name != "done"))


def test_bm25_searcher_shards_option(torch_cache, tmp_path):
    from capreolus_tpu_torch.core import ConfigError
    from capreolus_tpu_torch.searcher import Searcher

    topicsfn = tmp_path / "topics.tsv"
    topicsfn.write_text("1\ttelescope galaxies\n2\twhales ocean\n3\tzzzunknown\n")
    single = Searcher.create("BM25", {"index": {"collection": {"name": "dummy"}}})
    single.device = "cpu"
    single.query_from_file(topicsfn, tmp_path / "single")
    sharded = Searcher.create("BM25", {"shards": 4, "index": {"collection": {"name": "dummy"}}})
    sharded.device, sharded.devices = "cpu", ["cpu"] * 4
    sharded.query_from_file(topicsfn, tmp_path / "sharded")
    assert (tmp_path / "sharded").joinpath(next(f.name for f in (tmp_path / "single").iterdir()
                                                if f.name != "done")).exists()  # the same run file name
    run1, run2 = _run(tmp_path / "single"), _run(tmp_path / "sharded")
    assert set(run1) == set(run2) == {"1", "2"}
    for qid in run1:
        assert list(run1[qid]) == list(run2[qid])
        for docid in run1[qid]:
            assert run2[qid][docid] == pytest.approx(run1[qid][docid], rel=RTOL)

    capped = Searcher.create("BM25", {"shards": 4, "maxpostings": 2, "index": {"collection": {"name": "dummy"}}})
    capped.device, capped.devices = "cpu", ["cpu"] * 4
    with pytest.raises(ConfigError, match="maxpostings .* not yet supported with searcher.shards > 1"):
        capped.query_from_file(topicsfn, tmp_path / "capped")
    few = Searcher.create("BM25", {"shards": 4, "index": {"collection": {"name": "dummy"}}})
    few.device, few.devices = "cpu", ["cpu"] * 2
    with pytest.raises(ValueError, match=r"searcher.shards=4 but only 2 devices are available"):
        few.query_from_file(topicsfn, tmp_path / "few")


def test_sharded_retrieval_service(torch_cache):
    from capreolus_tpu_torch.serving import RetrievalService

    sharded = RetrievalService.from_config(collection="dummy", shards=4, device="cpu", devices=["cpu"] * 4)
    single = RetrievalService.from_config(collection="dummy", device="cpu")
    assert sharded.engine is None and sharded._sindex.num_shards == 4
    queries = ["galaxies collide", "whales in the ocean", "orbit telescope launch"]
    sh, si = sharded.search(queries, k=3), single.search(queries, k=3)
    for a, b in zip(sh, si):
        assert [d for d, _ in a] == [d for d, _ in b], (sh, si)
        for (_, sa), (_, sb) in zip(a, b):
            assert sa == pytest.approx(sb, rel=RTOL)
    assert list(sharded._docids) == list(single._docids)

    sharded.index.add_documents([("NEWDOC1", "zebra stampede across the savanna")])
    assert sharded.refresh() is True
    hits = sharded.search(["zebra stampede"], k=3)
    assert hits[0] and hits[0][0][0] == "NEWDOC1"
    assert sharded.refresh() is False  # nothing pending: the generation did not move
    sharded.index.delete_documents(["NEWDOC1"])
    assert sharded.refresh() is True
    gone = sharded.search(["zebra stampede"], k=3)
    assert not gone[0] or gone[0][0][0] != "NEWDOC1"
    assert "NEWDOC1" not in sharded._docids


def test_sharded_services_never_fall_back(torch_cache):
    """Too few devices raise JAX's ``ValueError``; without ``devices`` the
    shards ask for cards, never the CPU or one device."""
    from capreolus_tpu_torch.serving import RetrievalService

    with pytest.raises(ValueError, match=r"shards=4 but only 3 devices present"):
        RetrievalService.from_config(collection="dummy", shards=4, device="cpu", devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"shards=2 but only 0 devices present"):
            RetrievalService.from_config(collection="dummy", shards=2, device="cpu")
