"""K1 (fused KNRM simmat + kernel pooling) and KNRM: the PyTorch port against
the JAX package, on the CPU, where the port runs K1's plain version.

Tolerance 2e-4 (rtol and atol), the JAX suite's own for its kernel
(tests/test_ops.py): the sigma=0.001 exact-match kernel turns a 1e-7
difference in a similarity near 1 into a visible change of the pooled feature.

Pad doc positions: the JAX Pallas kernel masks their kernel values while its
XLA fallback (``reranker.common.knrm_pool``) counts them at similarity 0, so the
two JAX paths disagree on any document shorter than D. The port's K1 follows
the model's path; against the Pallas kernel it is held on unpadded documents,
and a test pins the reference's disagreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.ops.simmat import knrm_simmat_pool as jax_knrm_simmat_pool  # noqa: E402
from capreolus_tpu.reranker.common import knrm_pool as jax_knrm_pool  # noqa: E402
from capreolus_tpu.reranker.common import similarity_matrix as jax_similarity_matrix  # noqa: E402
from capreolus_tpu.reranker.knrm import KNRMModel as JaxKNRMModel  # noqa: E402
from capreolus_tpu_torch.convert import knrm_state_dict, load_params, save_params  # noqa: E402
from capreolus_tpu_torch.ops import simmat  # noqa: E402
from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS, knrm_pool, similarity_matrix  # noqa: E402
from capreolus_tpu_torch.reranker.knrm import KNRMModel  # noqa: E402

TOL = 2e-4
SHAPES = {"small": (3, 4, 37, 20), "serving": (4, 4, 800, 300)}  # B, Q, D (ragged), E


def make_inputs(shape, seed, doc_pads):
    """Embedding table [V, E] (row 0 = pad) and int32 token ids: a pad query row,
    negative OOV ids in queries and docs (some equal), optional doc pad tails."""
    b, q, d, e = shape
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = 60
    emb = rng.standard_normal((vocab, e)).astype(np.float32)
    emb[0] = 0.0
    qt = rng.integers(1, vocab, size=(b, q)).astype(np.int32)
    qt[:, -1] = 0
    qt[0, 0], qt[-1, 1] = -1, -2
    dt = rng.integers(-3, vocab, size=(b, d)).astype(np.int32)
    dt[dt == 0] = 1
    if doc_pads:
        for i, n in enumerate(rng.integers(d // 3, d, size=b)):
            dt[i, n:] = 0
    return emb, qt, dt


def port_k1(emb, qt, dt):
    return simmat.knrm_simmat_pool(torch.from_numpy(emb), torch.from_numpy(qt), torch.from_numpy(dt),
                                   KNRM_MUS, KNRM_SIGMAS).numpy()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_k1_matches_pallas_kernel(shape):
    emb, qt, dt = make_inputs(SHAPES[shape], seed=1, doc_pads=False)
    ref = jax_knrm_simmat_pool(jnp.asarray(emb), jnp.asarray(qt), jnp.asarray(dt), KNRM_MUS, KNRM_SIGMAS,
                               use_pallas=True, interpret=True)
    np.testing.assert_allclose(port_k1(emb, qt, dt), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("doc_pads", [False, True])
def test_plain_k1_matches_model_path(shape, doc_pads):
    emb, qt, dt = make_inputs(SHAPES[shape], seed=2, doc_pads=doc_pads)
    ref = jax_knrm_pool(jax_similarity_matrix(jnp.asarray(emb), qt, dt), KNRM_MUS, KNRM_SIGMAS)
    np.testing.assert_allclose(port_k1(emb, qt, dt), np.asarray(ref), rtol=TOL, atol=TOL)


def test_reference_pallas_kernel_disagrees_on_padded_docs():
    """The fault the port does not copy: with doc pad tails the Pallas kernel
    leaves the pad positions out of the kernel sums and its XLA fallback does
    not; the port's K1 sides with the model's path."""
    emb, qt, dt = make_inputs(SHAPES["small"], seed=3, doc_pads=True)
    pallas = np.asarray(jax_knrm_simmat_pool(jnp.asarray(emb), jnp.asarray(qt), jnp.asarray(dt), KNRM_MUS,
                                             KNRM_SIGMAS, use_pallas=True, interpret=True))
    xla = np.asarray(jax_knrm_pool(jax_similarity_matrix(jnp.asarray(emb), qt, dt), KNRM_MUS, KNRM_SIGMAS))
    assert np.abs(pallas - xla).max() > 0.1
    np.testing.assert_allclose(port_k1(emb, qt, dt), xla, rtol=TOL, atol=TOL)


def test_model_path_functions_match_jax():
    emb, qt, dt = make_inputs(SHAPES["serving"], seed=4, doc_pads=True)
    sim = similarity_matrix(torch.from_numpy(emb), torch.from_numpy(qt).long(), torch.from_numpy(dt).long())
    ref_sim = jax_similarity_matrix(jnp.asarray(emb), qt, dt)
    np.testing.assert_allclose(sim.numpy(), np.asarray(ref_sim), rtol=1e-5, atol=1e-6)
    pooled = knrm_pool(sim, torch.tensor(KNRM_MUS), torch.tensor(KNRM_SIGMAS))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jax_knrm_pool(ref_sim, KNRM_MUS, KNRM_SIGMAS)),
                               rtol=TOL, atol=TOL)


def flatten_params(params):
    """The JAX param tree flattened to "params/..." paths of numpy arrays."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(getattr(p, "key", p)) for p in path)] = np.asarray(leaf)
    return flat


def _jax_and_port_models(options, emb, qt, dt, seed=0):
    jax_model = JaxKNRMModel(embedding_init=emb, **options)
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(qt), jnp.asarray(dt), None)
    port = KNRMModel(emb, **options)
    port.load_state_dict(knrm_state_dict(flatten_params(params)))
    return jax_model, params, port.eval()


@pytest.mark.parametrize("gradkernels", [False, True])
@pytest.mark.parametrize("singlefc", [False, True])
@pytest.mark.parametrize("scoretanh", [False, True])
def test_knrm_model_matches_jax(gradkernels, singlefc, scoretanh):
    options = {"gradkernels": gradkernels, "singlefc": singlefc, "scoretanh": scoretanh, "finetune": False}
    b, q, d, e = SHAPES["serving"]
    emb, qt, dt = make_inputs((b, q, 200, e), seed=5, doc_pads=True)
    jax_model, params, port = _jax_and_port_models(options, emb, qt, dt)
    ref = jax_model.apply(params, jnp.asarray(qt), jnp.asarray(dt), None)
    with torch.no_grad():
        out = port(torch.from_numpy(qt).long(), torch.from_numpy(dt).long())
    assert out.shape == (b,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_knrm_checkpoint_without_frozen_params(tmp_path):
    """A JAX checkpoint leaves frozen leaves out (empty arrays): convert refills
    the embedding from the extractor's table and the kernel bank from the
    defaults; an npz round trip keeps everything else."""
    options = {"gradkernels": False, "singlefc": False, "scoretanh": True, "finetune": False}
    emb, qt, dt = make_inputs((2, 4, 50, 16), seed=6, doc_pads=True)
    jax_model, params, _ = _jax_and_port_models(options, emb, qt, dt, seed=1)
    flat = flatten_params(params)
    for frozen in ("params/embedding", "params/mus", "params/sigmas"):
        flat[frozen] = np.zeros(0, np.float32)
    path = save_params(flat, tmp_path / "knrm.npz")
    state = knrm_state_dict(load_params(path), embedding=emb)
    np.testing.assert_array_equal(state["embedding"].numpy(), emb)
    np.testing.assert_array_equal(state["mus"].numpy(), np.float32(KNRM_MUS))
    np.testing.assert_array_equal(state["combine1.weight"].numpy(), flat["params/combine1/kernel"].T)
    port = KNRMModel(np.zeros_like(emb), **options)
    port.load_state_dict(state)
    ref = jax_model.apply(params, jnp.asarray(qt), jnp.asarray(dt), None)
    with torch.no_grad():
        out = port(torch.from_numpy(qt).long(), torch.from_numpy(dt).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    with pytest.raises(KeyError):
        knrm_state_dict({k: v for k, v in flat.items() if k != "params/embedding"})


def test_knrm_finetune_trains_embedding_on_model_path():
    options = {"gradkernels": True, "singlefc": True, "scoretanh": False, "finetune": True}
    emb, qt, dt = make_inputs((2, 4, 30, 16), seed=7, doc_pads=True)
    _, _, port = _jax_and_port_models(options, emb, qt, dt)
    port(torch.from_numpy(qt).long(), torch.from_numpy(dt).long()).sum().backward()
    assert port.embedding.grad is not None and torch.isfinite(port.embedding.grad).all()
    assert port.mus.grad is not None


def test_cpu_forward_never_takes_the_kernel(monkeypatch):
    """KNRM routes through K1 only for CUDA tensors (gradkernels=False,
    finetune=False): on the CPU it runs the model's path, like the JAX model
    off the TPU."""
    from capreolus_tpu_torch.reranker import knrm

    monkeypatch.setattr(knrm, "knrm_simmat_pool", lambda *a, **k: pytest.fail("K1 taken on the CPU"))
    emb, qt, dt = make_inputs((2, 4, 30, 16), seed=8, doc_pads=True)
    port = KNRMModel(emb, gradkernels=False, finetune=False).eval()
    with torch.no_grad():
        assert port(torch.from_numpy(qt).long(), torch.from_numpy(dt).long()).shape == (2,)


def test_k1_wrapper_runs_plain_on_cpu_and_rejects_other_devices():
    emb, qt, dt = make_inputs((2, 4, 30, 16), seed=9, doc_pads=True)
    args = simmat.knrm_inputs(torch.from_numpy(emb), torch.from_numpy(qt), torch.from_numpy(dt),
                              KNRM_MUS, KNRM_SIGMAS)
    before = simmat.knrm_pool.launches
    np.testing.assert_array_equal(simmat.knrm_pool(*args).numpy(), simmat.knrm_pool_plain(*args).numpy())
    assert simmat.knrm_pool.launches == before  # the plain version is no launch
    with pytest.raises(ValueError):
        simmat.knrm_pool(*(a.to("meta") for a in args))
