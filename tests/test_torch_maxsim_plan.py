"""K3's launch plan and the identities its Hopper kernel relies on, on the CPU.

``maxsim_plan`` decides how ``csrc/maxsim.cu`` cuts the work: 64-doc tiles,
warpgroups of 64 query rows holding whole queries (or 64-row chunks of a
longer query, taken in passes), and Ld split into ranges whose blocks form a
thread-block cluster; ``maxsim_block`` below replays the kernel's indexing:
what one block computes. The tests here check, over small shapes drawn by
hypothesis (Lq past 64, Ld = 1, C = 1, dims 8-128):
- every (query token, doc, doc token) goes to exactly one block, and a
  query's rows share one warpgroup unless the plan chunks them;
- partial maxima over the plan's Ld ranges, combined by max, equal
  ``maxsim_scores_plain`` bit for bit (max is exact), and the result stays
  within 1e-4 of the JAX package's ``maxsim_scores_ref`` and its Pallas
  ``_maxsim_pallas`` run in interpret mode (bf16 inputs, exact f32 products,
  only the order of the f32 sums differs);
- a corpus whose dim is zero-padded (as the kernel pads dims to 16 and its
  TMA boxes to 64) scores as the unpadded one: within 1e-6 of it, the f32
  rounding of sums in another order, and within 1e-4 of JAX.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.configuration import set_hypothesis_home_dir

from capreolus_tpu.ops.maxsim import maxsim_scores as jax_maxsim_scores
from capreolus_tpu.ops.maxsim import maxsim_scores_ref as jax_maxsim_scores_ref
from capreolus_tpu_torch.ops import maxsim as ms

set_hypothesis_home_dir(str(Path(__file__).resolve().parents[1] / "build" / "hypothesis"))  # git-ignored

MAXSIM_TOL = 1e-4
PAD_TOL = 1e-6
SHAPES = st.tuples(st.integers(1, 6), st.integers(1, 140), st.integers(1, 9), st.integers(1, 140))


def maxsim_block(plan, block, nq, lq, ld, c):
    """What block ``block`` of ``plan`` computes, as ``csrc/maxsim.cu`` indexes it:
    (docs range, Ld range, [[(query, query token) of each warpgroup's 64
    rows, for each pass]]); a row that holds no query token is None."""
    w_count = plan["warpgroups"]
    split = block % plan["splits"]
    group = block // plan["splits"] % plan["groups"]
    c0 = block // plan["splits"] // plan["groups"] * ms.DOC_TILE
    tokens = range(split * ld // plan["splits"], (split + 1) * ld // plan["splits"])
    passes = []
    for p in range(plan["passes"]):
        tiles = []
        for w in range(w_count):
            rows = []
            for r in range(ms.ROW_TILE):
                if plan["chunks"] == 1:
                    query = (group * w_count + w) * plan["qw"] + r // lq
                    ok = r < plan["qw"] * lq and query < nq
                    rows.append((query, r % lq) if ok else None)
                else:
                    i = (p * w_count + w) * ms.ROW_TILE + r
                    rows.append((group, i) if i < lq else None)
            tiles.append(rows)
        passes.append(tiles)
    return range(c0, min(c, c0 + ms.DOC_TILE)), tokens, passes


def case(n_q, lq, ld, c, dim, seed):
    """q [Q, Lq, dim] f32, docs [C, Ld, dim] f32 (L2-normalised) and an int8
    mask [C, Ld] with holes, a fully masked doc 0 and a doc 1 valid only at its
    last token; with the token-major arguments of ``maxsim_scores``."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def unit(*shape):
        x = rng.standard_normal(shape)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    q, docs = unit(n_q, lq, dim), unit(c, ld, dim)
    mask = (rng.random((c, ld)) > 0.3).astype(np.int8)
    mask[0] = 0
    if c > 1:
        mask[1] = 0
        mask[1, ld - 1] = 1
    args = (torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(np.swapaxes(docs, 0, 1))),
            torch.from_numpy(np.where(mask.T > 0, 0.0, -1e9).astype(np.float32)), torch.from_numpy(mask.any(axis=1)))
    return q, docs, mask, args


def assert_scores_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=f"{what}: -inf entries")
    finite = np.isfinite(want)
    err = float(np.abs(got[finite] - want[finite]).max()) if finite.any() else 0.0
    print(f"{what}: max |err| {err:.3g} (tolerance {tol})")
    assert err <= tol, what


@settings(max_examples=80, deadline=None, database=None)
@given(shape=SHAPES, sms=st.sampled_from([1, 8, 132]))
def test_plan_gives_every_cell_to_one_block(shape, sms):
    n_q, lq, ld, c = shape
    plan = ms.maxsim_plan(n_q, lq, ld, c, sms=sms)
    assert plan["warpgroups"] in (1, ms.WARPGROUPS)
    assert 1 <= plan["splits"] <= min(ms.MAX_SPLITS, ld) and plan["splits"] & (plan["splits"] - 1) == 0
    assert plan["blocks"] == plan["tiles"] * plan["groups"] * plan["splits"]
    counts = np.zeros((n_q, lq, c, ld), dtype=np.int32)
    for block in range(plan["blocks"]):
        docs, tokens, passes = maxsim_block(plan, block, n_q, lq, ld, c)
        assert len(docs) >= 1 and len(tokens) >= 1
        for tiles in passes:
            for rows in tiles:
                held = [r for r in rows if r is not None]
                if held:
                    qs, ts = (np.array(x) for x in zip(*held))
                    counts[qs, ts, docs.start:docs.stop, tokens.start:tokens.stop] += 1
                queries = {qq for qq, _ in held}
                if plan["chunks"] == 1:  # whole queries: a query's Lq rows share this warpgroup
                    for qq in queries:
                        assert sorted(i for q2, i in held if q2 == qq) == list(range(lq))
                elif held:  # one query, a run of at most 64 consecutive rows
                    assert len(queries) == 1
                    first = held[0][1]
                    assert [i for _, i in held] == list(range(first, first + len(held)))
    assert (counts == 1).all()


def test_plan_at_the_served_shapes():
    """One served query fills the card by Ld splits; 64 queries put three
    warpgroups (192 rows) on each doc tile and need no split."""
    one = ms.maxsim_plan(1, 32, 180, 20000)
    assert (one["warpgroups"], one["qw"], one["groups"], one["splits"], one["blocks"]) == (1, 2, 1, 4, 1252)
    batch = ms.maxsim_plan(64, 32, 180, 20000)
    assert (batch["warpgroups"], batch["qw"], batch["groups"], batch["splits"], batch["blocks"]) == (3, 2, 11, 1, 3443)
    chunked = ms.maxsim_plan(2, 200, 9, 131)
    assert (chunked["chunks"], chunked["passes"], chunked["splits"]) == (4, 2, 1)


def split_maxsim(plan, q_emb, docs_t, bias_t, valid):
    """The plain version's similarities, their maxima over each of the plan's
    Ld ranges, combined by max, then summed over Lq as the plain version sums."""
    n_q, lq, dim = q_emb.shape
    ld, c = docs_t.shape[:2]
    q2d = q_emb.to(torch.bfloat16).double().reshape(n_q * lq, dim)
    d = docs_t.to(torch.bfloat16).double()
    sim = (q2d @ d.reshape(ld * c, dim).T).float().view(n_q * lq, ld, c)
    sim = sim.masked_fill((bias_t < 0)[None], float("-inf"))
    ranges = [maxsim_block(plan, s, n_q, lq, ld, c)[1] for s in range(plan["splits"])]
    best = sim[:, ranges[0].start:ranges[0].stop].amax(dim=1)
    for r in ranges[1:]:
        best = torch.maximum(best, sim[:, r.start:r.stop].amax(dim=1))
    out = ms.sum_query_tokens(best.view(n_q, lq, c))
    return torch.where(valid.bool()[None, :], out, float("-inf"))


@settings(max_examples=40, deadline=None, database=None)
@given(shape=SHAPES, dim=st.sampled_from([8, 20, 24, 64, 128]), seed=st.integers(0, 2 ** 16))
def test_split_maxima_combine_to_the_plain_version_bit_for_bit(shape, dim, seed):
    q, docs, mask, args = case(*shape, dim, seed)
    plan = ms.maxsim_plan(*shape, sms=132)
    plain = ms.maxsim_scores_plain(*args)
    assert torch.equal(split_maxsim(plan, *args), plain)
    want = np.asarray(jax_maxsim_scores_ref(jnp.asarray(q), jnp.asarray(docs), jnp.asarray(mask)))
    assert_scores_close(plain.numpy(), want, MAXSIM_TOL, f"plain vs JAX maxsim_scores_ref {shape} dim {dim}")


@pytest.mark.parametrize("shape", [(2, 70, 5, 9, 24), (1, 3, 1, 1, 8), (3, 21, 7, 65, 128)])
def test_split_maxima_match_the_pallas_kernel_interpret(shape):
    q, docs, mask, args = case(*shape, seed=sum(shape))
    plan = ms.maxsim_plan(*shape[:4], sms=132)
    jq, docs_t, bias_t, valid = (jnp.asarray(x.numpy()) for x in args)
    want = np.asarray(jax_maxsim_scores(jq, docs_t, bias_t, valid, interpret=True, block_docs=8))
    assert_scores_close(split_maxsim(plan, *args).numpy(), want, MAXSIM_TOL, f"split maxima vs Pallas {shape}")


@pytest.mark.parametrize("dim,padded", [(20, 32), (24, 64), (8, 16), (100, 128)])
def test_zero_padded_dims_score_as_the_unpadded_corpus(dim, padded):
    q, docs, mask, args = case(3, 33, 9, 70, dim, seed=dim)
    q_emb, docs_t, bias_t, valid = args
    q_pad = torch.nn.functional.pad(q_emb, (0, padded - dim))
    docs_pad = torch.nn.functional.pad(docs_t, (0, padded - dim))
    got = ms.maxsim_scores_plain(q_pad, docs_pad, bias_t, valid).numpy()
    assert_scores_close(got, ms.maxsim_scores_plain(*args).numpy(), PAD_TOL, f"dim {dim} padded to {padded}")
    want = np.asarray(jax_maxsim_scores_ref(jnp.asarray(q), jnp.asarray(docs), jnp.asarray(mask)))
    assert_scores_close(got, want, MAXSIM_TOL, f"dim {dim} padded to {padded} vs JAX")
