"""K1's launch plan and the identities its Hopper kernel relies on, on the CPU.

``csrc/knrm_pool.cu`` splits a batch element's D doc rows over several
blocks (``knrm_plan``) whose warps take chunks of rows in turn
(``warp_rows`` below replays the kernel's indexing). It never reads a row whose id is <= 0: such a row is
zero by contract (``knrm_inputs``), so its similarity follows from the ids.
It adds each warp's kernel values over its non-pad rows in ascending order,
then its count of pad rows times the kernel values of similarity 0, then the
warps of a block in order, then the blocks in order. The tests hold that
order, replayed here in f32, within 2e-4 of ``knrm_pool_plain`` and of the JAX
model path's ``knrm_pool`` (the JAX suite's tolerance for its kernel: the
sigma = 0.001 exact-match kernel amplifies f32 rounding), and the similarity
of a row with id <= 0, taken from its id, bit for bit against the plain
version's product with the zero row.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.configuration import set_hypothesis_home_dir

from capreolus_tpu.reranker.common import knrm_pool as jax_knrm_pool
from capreolus_tpu.reranker.common import similarity_matrix as jax_similarity_matrix
from capreolus_tpu_torch.ops import simmat
from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS

set_hypothesis_home_dir(str(Path(__file__).resolve().parents[1] / "build" / "hypothesis"))  # git-ignored

ERR_TOL = 2e-4


def warp_rows(splits, rank, warp, d):
    """The doc rows of warp ``warp`` of block ``rank`` (of a batch element's
    ``splits`` blocks), ascending, as ``csrc/knrm_pool.cu`` indexes them: the
    batch element's warps take chunks of ``KNRM_CHUNK`` rows in turn."""
    w, chunk = simmat.KNRM_WARPS, simmat.KNRM_CHUNK
    chunks = range(rank * w + warp, -(-d // chunk), w * splits)
    return [r for ch in chunks for r in range(ch * chunk, min(d, (ch + 1) * chunk))]


def inputs(b, q, d, e, seed, all_pad=None):
    """K1's inputs as the model builds them (``knrm_inputs``): a pad query row,
    negative OOV ids in queries and docs (some equal), ragged pad tails, and
    optionally one batch element whose doc positions are all pad."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = 60
    emb = rng.standard_normal((vocab, e)).astype(np.float32)
    emb[0] = 0.0
    qt = rng.integers(1, vocab, size=(b, q)).astype(np.int32)
    qt[:, -1] = 0
    qt[0, 0] = -1
    dt = rng.integers(-3, vocab, size=(b, d)).astype(np.int32)
    for i, n in enumerate(rng.integers(0, d + 1, size=b)):
        dt[i, n:] = 0
    if all_pad is not None:
        dt[all_pad] = 0
    return emb, qt, dt, simmat.knrm_inputs(torch.from_numpy(emb), torch.from_numpy(qt), torch.from_numpy(dt),
                                            KNRM_MUS, KNRM_SIGMAS)


def sims_from_ids(q_emb, d_emb, qtok, dtok):
    """The kernel's similarities [B, Q, D]: the dot product only where the doc
    id is > 0, else 0; plus 1 where equal negative ids meet; 0 at any pad."""
    dots = np.einsum("bqe,bde->bqd", q_emb, d_emb).astype(np.float32)
    dots = np.where((dtok > 0)[:, None, :], dots, np.float32(0.0))
    qt, dt = qtok[:, :, None], dtok[:, None, :]
    exact = ((qt == dt) & (qt < 0)).astype(np.float32)
    return np.where((qt != 0) & (dt != 0), dots + exact, np.float32(0.0)).astype(np.float32)


def k1_in_kernel_order(q_emb, d_emb, qtok, dtok, mus, sigmas):
    """K1's sums replayed in f32 in the kernel's order (see the module docstring)."""
    q_emb, d_emb, qtok, dtok = (x.numpy() for x in (q_emb, d_emb, qtok, dtok))
    b, q, _ = q_emb.shape
    d = dtok.shape[1]
    mu = np.tile(mus.numpy(), q).astype(np.float32)            # pair (qi, k) at qi * K + k
    sg2 = np.tile((sigmas * sigmas).numpy(), q).astype(np.float32)
    k = mus.shape[0]
    sims = sims_from_ids(q_emb, d_emb, qtok, dtok)
    splits = simmat.knrm_plan(d)
    out = np.zeros((b, k), dtype=np.float32)

    def kernel_values(sim_row):  # [Q] -> [Q * K]
        adj = np.repeat(sim_row, k).astype(np.float32) - mu
        return np.exp(np.float32(-0.5) * adj * adj / sg2).astype(np.float32)

    for bi in range(b):
        tot, rtot = np.zeros(q * k, np.float32), np.zeros(q, np.float32)
        for rank in range(splits):
            ksum, rowsum = np.zeros(q * k, np.float32), np.zeros(q, np.float32)
            for warp in range(simmat.KNRM_WARPS):
                acc, rowacc, pads = np.zeros(q * k, np.float32), np.zeros(q, np.float32), 0
                for di in warp_rows(splits, rank, warp, d):
                    if dtok[bi, di] == 0:
                        pads += 1
                        continue
                    acc = (acc + kernel_values(sims[bi, :, di])).astype(np.float32)
                    rowacc = (rowacc + sims[bi, :, di]).astype(np.float32)
                acc = (acc + np.float32(pads) * kernel_values(np.zeros(q, np.float32))).astype(np.float32)
                ksum, rowsum = (ksum + acc).astype(np.float32), (rowsum + rowacc).astype(np.float32)
            tot, rtot = (tot + ksum).astype(np.float32), (rtot + rowsum).astype(np.float32)
        for qi in range(q):
            if rtot[qi] != 0:
                out[bi] = out[bi] + np.log(tot[qi * k:(qi + 1) * k] + np.float32(1e-6)).astype(np.float32)
    return out


@settings(max_examples=60, deadline=None, database=None)
@given(d=st.integers(1, 2000))
def test_each_doc_row_goes_to_one_warp_in_ascending_order(d):
    splits = simmat.knrm_plan(d)
    assert 1 <= splits <= simmat.KNRM_MAX_SPLITS
    seen = []
    for rank in range(splits):
        for warp in range(simmat.KNRM_WARPS):
            rows = warp_rows(splits, rank, warp, d)
            assert rows == sorted(rows)
            seen += rows
    assert sorted(seen) == list(range(d))
    if splits < simmat.KNRM_MAX_SPLITS:  # every warp takes at most one chunk
        assert splits * simmat.KNRM_WARPS * simmat.KNRM_CHUNK >= d


def test_plan_at_the_serving_shape():
    """100 chunks of 8 rows per batch element: 13 blocks of 8 warps."""
    assert simmat.knrm_plan(800) == 13


@settings(max_examples=8, deadline=None, database=None)
@given(b=st.integers(1, 4), q=st.integers(1, 6), d=st.integers(1, 200), e=st.sampled_from([8, 20, 33, 300]),
       seed=st.integers(0, 2 ** 16))
def test_kernel_order_matches_the_plain_version_and_jax(b, q, d, e, seed):
    emb, qt, dt, args = inputs(b, q, d, e, seed, all_pad=0 if b > 1 else None)
    got = k1_in_kernel_order(*args)
    plain = simmat.knrm_pool_plain(*args).numpy()
    np.testing.assert_allclose(got, plain, rtol=ERR_TOL, atol=ERR_TOL)
    want = np.asarray(jax_knrm_pool(jax_similarity_matrix(jnp.asarray(emb), qt, dt), KNRM_MUS, KNRM_SIGMAS))
    np.testing.assert_allclose(got, want, rtol=ERR_TOL, atol=ERR_TOL)


@pytest.mark.parametrize("shape", [(4, 4, 800, 300), (3, 5, 37, 20), (2, 3, 803, 33)])
def test_kernel_order_at_fixed_shapes(shape):
    emb, qt, dt, args = inputs(*shape, seed=sum(shape), all_pad=1)
    got = k1_in_kernel_order(*args)
    plain = simmat.knrm_pool_plain(*args).numpy()
    print(f"K1 in the kernel's order {shape}: max |err| vs plain {np.abs(got - plain).max():.3g} (tolerance {ERR_TOL})")
    np.testing.assert_allclose(got, plain, rtol=ERR_TOL, atol=ERR_TOL)
    want = np.asarray(jax_knrm_pool(jax_similarity_matrix(jnp.asarray(emb), qt, dt), KNRM_MUS, KNRM_SIGMAS))
    np.testing.assert_allclose(got, want, rtol=ERR_TOL, atol=ERR_TOL)


@pytest.mark.parametrize("shape", [(4, 4, 800, 300), (3, 5, 37, 20)])
def test_a_row_with_id_at_most_0_is_known_from_its_id(shape):
    """knrm_inputs zeroes the rows of ids <= 0; the similarity the kernel takes
    from the ids equals the plain version's product with that zero row."""
    _, _, dt, (q_emb, d_emb, qtok, dtok, _, _) = inputs(*shape, seed=5)
    skipped = dtok <= 0
    assert bool(skipped.any()) and bool((dtok < 0).any())
    assert torch.equal(d_emb[skipped], torch.zeros_like(d_emb[skipped]))
    sim = torch.matmul(q_emb, d_emb.transpose(1, 2))  # as knrm_pool_plain forms it
    qt, dtt = qtok[:, :, None], dtok[:, None, :]
    exact = (qt == dtt) & (qt < 0) & (dtt < 0)
    plain = torch.where((qt != 0) & (dtt != 0), sim + exact.to(sim.dtype), 0.0).numpy()
    from_ids = sims_from_ids(q_emb.numpy(), d_emb.numpy(), qtok.numpy(), dtok.numpy())
    cols = np.broadcast_to(skipped.numpy()[:, None, :], plain.shape)
    np.testing.assert_array_equal(from_ids[cols], plain[cols])
