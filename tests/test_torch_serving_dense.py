"""The PyTorch port's ``DenseRetrievalService``, ``ImpactRetrievalService``
and ``HybridRetrievalService`` against the JAX package's on the CPU
(``tests/test_serving.py``'s dense, IVF, hybrid and impact tests), over the
126-doc corpus of ``torch_dense_util.py``, with the JAX searchers' random-init
weights carried over as the port's checkpoints.

Tolerances:
- dense hits: the same docids in the same order but for near-ties, scores
  within 1e-3 (``tests/test_torch_dense.py``: a bf16 or int8 rounding of an
  embedding 1e-7 from JAX's).
- impact hits, from JAX's raw cache: the same docids but for near-ties,
  scores within 1e-4 of the list's top score (query weights 1e-6 apart
  relative, summed in f32 over up to 32 terms).
- a request's hits against the same queries in another batch: the same
  docids but for near-ties, scores within 1e-6 (the port does not pad a
  batch to ``batch`` rows, so a row's f32 sums may block differently).
- hybrid: equal to ``fusion.py``'s math over the two legs' own hit lists;
  against JAX's hybrid at the dense leg's tolerance.
"""

import inspect
import shutil

import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

import capreolus_tpu.serving as jax_serving  # noqa: E402
import capreolus_tpu_torch.serving as port_serving  # noqa: E402
from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from test_torch_cuda import assert_same_ranking  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from torch_dense_util import TOPICS, jax_dense_checkpoint, jax_impact_checkpoint, searcher_config, write_dense_corpus  # noqa: E402,E501

DENSE_TOL = 1e-3
IMPACT_RTOL = 1e-4
BATCH_TOL = 1e-6
QUERIES = list(TOPICS.values())


@pytest.fixture
def coll(tmpdir_as_cache, torch_cache):
    return write_dense_corpus(tmpdir_as_cache / "corpus")


def service_config(coll, **options):
    config = searcher_config(coll, **options)
    index = config.pop("index")
    config["index"] = {k: v for k, v in index.items() if k != "collection"}
    return dict(collection="dummy", collection_path=coll["path"], **config)


def dense_pair(coll, tmp, max_k=20, **options):
    jax_svc = jax_serving.DenseRetrievalService.from_config(max_k=max_k, **service_config(coll, **options))
    ckpt = jax_dense_checkpoint(jax_svc.searcher, tmp / "dense.npz")
    port_svc = port_serving.DenseRetrievalService.from_config(
        max_k=max_k, device="cpu", **service_config(coll, checkpointfile=ckpt, **options))
    return jax_svc, port_svc


def assert_hits_agree(port_results, jax_results, tol, what, relative=False):
    assert len(port_results) == len(jax_results)
    for i, (p, j) in enumerate(zip(port_results, jax_results)):
        scale = max([abs(s) for _, s in j] + [1e-30]) if relative else 1.0
        assert_same_ranking([(d, s / scale) for d, s in p], [(d, s / scale) for d, s in j], tol, f"{what}, query {i}")


@pytest.mark.parametrize("options", [{}, {"quantize": "int8"}, {"quantize": "int4", "rescore": 30},
                                     {"prf": 3}, {"clusters": 6, "nprobe": 6}])
def test_dense_service_matches_jax(coll, tmpdir_as_cache, options):
    """Hits of the dense service's engines against JAX's; a single query and
    ``search_async`` give the batch's hits. With ``prf`` the port's service
    expands each request's queries as the searcher's batch pipeline does (the
    JAX service's ``_embed_batch`` never calls ``_prf_expand``), so its hits
    are held against the JAX searcher's run."""
    jax_svc, port_svc = dense_pair(coll, tmpdir_as_cache, **options)
    got = port_svc.search(QUERIES, k=10)
    if "prf" in options:
        topics = tmpdir_as_cache / "topics.tsv"
        topics.write_text("".join(f"{q}\t{t}\n" for q, t in TOPICS.items()))
        from torch_dense_util import load_run

        run = load_run(jax_svc.searcher.query_from_file(topics, tmpdir_as_cache / "jax_prf"))
        want = [list(run[q].items())[:10] for q in TOPICS]
    else:
        want = jax_svc.search(QUERIES, k=10)
    assert all(len(h) == 10 for h in got)
    assert_hits_agree(got, want, DENSE_TOL, f"DenseRetrievalService {options}")
    assert_hits_agree(port_svc.search(QUERIES[:1], k=5), [got[0][:5]], BATCH_TOL, "one query")
    c1, c2 = port_svc.search_async(QUERIES[:2], k=10), port_svc.search_async(QUERIES[2:4], k=10)
    assert_hits_agree(c1() + c2(), got[:4], BATCH_TOL, "two dispatches")
    assert port_svc.max_k == jax_svc.max_k == 20
    assert port_svc.get_document(got[0][0][0]) == jax_svc.get_document(got[0][0][0])


def test_dense_service_ivf_full_probe_equals_exact(coll, tmpdir_as_cache):
    """``tests/test_serving.py::test_dense_retrieval_service_ivf``: IVF with
    every cell probed serves the exact service's hits."""
    _, exact = dense_pair(coll, tmpdir_as_cache)
    ivf = port_serving.DenseRetrievalService(
        port_serving.DenseRetrievalService.from_config(
            device="cpu", **service_config(coll, checkpointfile=exact.searcher.config["checkpointfile"],
                                           clusters=4, nprobe=4)).searcher, max_k=20, device="cpu")
    assert_hits_agree(ivf.search(QUERIES, k=10), exact.search(QUERIES, k=10), 1e-6, "IVF full probe")


@pytest.mark.parametrize("encoder", ["unicoil", "splade"])
def test_impact_service_matches_jax(coll, tmpdir_as_cache, encoder):
    """The impact service over JAX's raw doc-major cache: JAX's hits (each
    list cut at its first score <= 0), ``search_async`` the batch's."""
    options = {"encoder": encoder, "topterms": 24}
    jax_svc = jax_serving.ImpactRetrievalService.from_config(**service_config(coll, **options))
    ckpt = jax_impact_checkpoint(jax_svc.searcher, tmpdir_as_cache / f"{encoder}.npz")
    searcher = port_serving.ImpactRetrievalService.from_config(
        device="cpu", **service_config(coll, checkpointfile=ckpt, **options)).searcher
    searcher._engine = None
    dest = searcher._cache_file()
    dest.unlink()
    shutil.copy(jax_svc.searcher._cache_file(), dest)
    port_svc = port_serving.ImpactRetrievalService(searcher, device="cpu")
    got, want = port_svc.search(QUERIES, k=10), jax_svc.search(QUERIES, k=10)
    assert any(got) and all(s > 0 for hits in got for _, s in hits)
    assert_hits_agree(got, want, IMPACT_RTOL, f"ImpactRetrievalService {encoder}", relative=True)
    c1, c2 = port_svc.search_async(QUERIES[:3], k=10), port_svc.search_async(QUERIES[3:], k=10)
    assert_hits_agree(c1() + c2(), got, BATCH_TOL, "two dispatches", relative=True)
    assert port_svc.get_document(got[0][0][0]) == jax_svc.get_document(got[0][0][0])


@pytest.mark.parametrize("method", ["rrf", "interp"])
def test_hybrid_service_matches_fusion_and_jax(coll, tmpdir_as_cache, method):
    """The fused lists equal ``fusion.py``'s math over the two legs' hit
    lists, and JAX's hybrid over its own legs."""
    from capreolus_tpu_torch.searcher.fusion import interp_fuse, rrf_fuse

    jax_dense, port_dense = dense_pair(coll, tmpdir_as_cache)
    index = {"collection": "dummy", "collection_path": coll["path"]}
    port_sparse = port_serving.RetrievalService.from_config(device="cpu", **index)
    jax_sparse = jax_serving.RetrievalService.from_config(**index)
    hybrid = port_serving.HybridRetrievalService(port_sparse, port_dense, method=method, depth=15)
    fused = hybrid.search(QUERIES, k=8)
    legs = [{str(i): dict(h) for i, h in enumerate(svc.search(QUERIES, k=15))} for svc in (port_sparse, port_dense)]
    expected = rrf_fuse(legs, k=60, hits=8) if method == "rrf" else interp_fuse(legs[0], legs[1], alpha=0.5, hits=8)
    for i in range(len(QUERIES)):
        assert fused[i] == sorted(expected[str(i)].items(), key=lambda kv: (-kv[1], kv[0]))
    want = jax_serving.HybridRetrievalService(jax_sparse, jax_dense, method=method, depth=15).search(QUERIES, k=8)
    assert_hits_agree(fused, want, DENSE_TOL, f"hybrid {method}")
    assert hybrid.get_document(fused[0][0][0])


def test_hybrid_depth_clamp_and_unknown_method(coll, tmpdir_as_cache):
    _, dense = dense_pair(coll, tmpdir_as_cache)
    sparse = port_serving.RetrievalService.from_config(collection="dummy", collection_path=coll["path"], device="cpu")
    assert port_serving.HybridRetrievalService(sparse, dense, depth=50).depth == dense.max_k == 20
    with pytest.raises(JaxConfigError) as want:
        jax_serving.HybridRetrievalService(sparse, dense, method="zzz")
    with pytest.raises(ConfigError) as got:
        port_serving.HybridRetrievalService(sparse, dense, method="zzz")
    assert str(got.value) == str(want.value)


def test_refresh_and_snippets_name_their_roadmap_item(coll, tmpdir_as_cache):
    """Both are ported (ROADMAP.md item 9): with nothing pending ``refresh``
    returns False, as JAX's does, and ``snippets`` equal JAX's
    (tests/test_torch_incremental.py and tests/test_torch_highlight.py hold
    them further)."""
    from capreolus_tpu.analysis.highlight import snippets_for_hits as jax_snippets_for_hits

    jax_dense, dense = dense_pair(coll, tmpdir_as_cache)
    impact = port_serving.ImpactRetrievalService.from_config(device="cpu", **service_config(coll))
    hybrid = port_serving.HybridRetrievalService(impact, dense)
    assert jax_dense.refresh() is False
    for svc in (dense, impact):
        assert svc.refresh() is False
    hits = dense.search(["galaxy telescope"], k=3)[0]
    want = jax_snippets_for_hits(jax_dense.searcher.index, "galaxy telescope", hits)
    for svc in (dense, impact, hybrid):
        assert svc.snippets("galaxy telescope", hits) == want
        assert svc.snippets("galaxy", []) == []


def _parameters(fn):
    return [p for p in inspect.signature(fn).parameters.values() if p.kind is not p.VAR_KEYWORD]


@pytest.mark.parametrize("name", ["DenseRetrievalService.__init__", "DenseRetrievalService.from_config",
                                  "ImpactRetrievalService.__init__", "ImpactRetrievalService.from_config",
                                  "HybridRetrievalService.__init__"])
def test_service_signatures_take_the_jax_parameters_in_the_jax_order(name):
    """The JAX parameters first, in the JAX order with the JAX defaults, then
    ``device`` (the hybrid service has none: its legs hold theirs)."""
    cls, method = name.split(".")
    jax_params = _parameters(getattr(getattr(jax_serving, cls), method))
    port_params = _parameters(getattr(getattr(port_serving, cls), method))
    assert [(p.name, p.kind, p.default) for p in port_params[:len(jax_params)]] == \
        [(p.name, p.kind, p.default) for p in jax_params]
    rest = [p.name for p in port_params[len(jax_params):]]
    assert rest == ([] if cls == "HybridRetrievalService" else ["device"])


def test_dense_service_defaults_to_cuda_and_raises_without_a_card(coll):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        port_serving.DenseRetrievalService.from_config(**service_config(coll))
    with pytest.raises(RuntimeError, match="cuda"):
        port_serving.ImpactRetrievalService.from_config(**service_config(coll))
