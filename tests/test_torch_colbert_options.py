"""The ColBERT searcher's options in the PyTorch port against the JAX package,
on the CPU: the two-stage ``prefilter`` (``_prefilter_topk``), host streaming
above ``hbmbudget`` (``_streamed_topk``) and the combinations both refuse.

Tolerances:
- prefilter's stage-1 candidates from one set of embeddings: JAX's, in JAX's
  order, but where two docs' stage-1 scores tie within 1e-5 (the bf16 sums
  of the pooled embeddings may be widened by XLA in another order), as the
  two-stage sparse searchers compare.
- bf16 prefilter hits: JAX's but for near-ties, scores within 1e-4 (stage 2
  is exact MaxSim over bf16 inputs in f32 in both; only the order of the f32
  sums differs).
- int8 prefilter hits: within 2e-2 relative and 1e-2 absolute of JAX's, near-
  ties at that tolerance: the port's stage 2 is its exact int8 engine (X1's
  int32 similarities rounded to bf16 before the max), JAX's prefilter keeps
  int32 similarities; the JAX suite holds its own prefilter to its exact
  engine at the same tolerance.
- each candidate's stage-2 score against the port's exact engine, and the
  streamed engine against the resident one: bit for bit (a doc's score does
  not depend on the other docs or queries of the call: ``maxsim_scores_plain``
  accumulates in f64 and sums query tokens in a fixed order).
- searcher runs against JAX: 1e-2, the ColBERT tests' tolerance.
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

from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.ops.quantization import quantize_rows as jax_quantize_rows  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.searcher.late_interaction import LateInteractionSearcher as JaxColbert  # noqa: E402
from capreolus_tpu.serving import ColbertRetrievalService as JaxColbertService  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.ops.maxsim import maxsim_scores  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from capreolus_tpu_torch.searcher.late_interaction import (prefilter_candidates,  # noqa: E402
                                                           quantized_maxsim_scores)
from capreolus_tpu_torch.serving import ColbertRetrievalService  # noqa: E402
from test_torch_colbert import QUERIES, SEARCHER, assert_same_run, jax_tiny_checkpoint  # noqa: E402
from test_torch_cuda import assert_same_ranking  # noqa: E402
from test_torch_index import torch_cache, write_trec_corpus  # noqa: E402,F401

STAGE1_TOL = 1e-5
BF16_HITS_TOL = 1e-4
INT8_RTOL, INT8_ATOL = 2e-2, 1e-2
SEARCH_TOL = 1e-2


def synthetic_corpus(n, ld, dim, seed):
    """[n, ld, dim] f16 unit token embeddings and [n, ld] int8 masks with
    ragged lengths, two fully masked docs and two duplicate docs (exact ties)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    emb = rng.standard_normal((n, ld, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    lengths = rng.integers(1, ld + 1, size=n)
    mask = (np.arange(ld)[None, :] < lengths[:, None]).astype(np.int8)
    mask[[5, n - 1]] = 0
    emb[n - 2], mask[n - 2] = emb[7], mask[7]
    return emb.astype(np.float16), mask


def queries(nq, lq, dim, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    q = rng.standard_normal((nq, lq, dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def port_searcher(tmp_cache, **options):
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, **options})
    searcher.device = "cpu"
    return searcher


def jax_stage1(q, corpus, n_cand):
    """JAX's stage 1 (``_prefilter_topk``'s arithmetic): scores [Q, N] and the top n_cand."""
    docs, dmask = corpus[0], corpus[1]
    m = (dmask > 0).astype(jnp.bfloat16)[..., None]
    d_f = docs if len(corpus) == 2 else docs.astype(jnp.bfloat16) * corpus[2].astype(jnp.bfloat16)[:, None, None]
    pooled = (d_f * m).sum(axis=1) / jnp.maximum(m.sum(axis=1), 1.0)
    qsum = jnp.asarray(q).astype(jnp.bfloat16).sum(axis=1)
    s1 = jnp.einsum("qe,ne->qn", qsum, pooled, preferred_element_type=jnp.float32)
    return np.asarray(s1), np.asarray(jax.lax.top_k(s1, n_cand)[1])


def assert_same_selection(got, want, scores, tol, what):
    """Per row: the same ordinals in the same order, but where the two docs at
    a position tie within ``tol`` in ``scores``; and a doc in one selection
    only sits at the other's cut within ``tol``."""
    for qi in range(len(got)):
        s = scores[qi]
        for g, w in zip(got[qi], want[qi]):
            assert g == w or abs(s[g] - s[w]) <= tol * max(1.0, abs(s[w])), f"{what}: row {qi} {g} vs {w}"
        cut = s[want[qi][-1]]
        for d in set(got[qi]) ^ set(want[qi]):
            assert abs(s[d] - cut) <= tol * max(1.0, abs(cut)), f"{what}: row {qi} doc {d} off the cut"


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_prefilter_engine_matches_jax_and_the_exact_engine(torch_cache, quantize):
    n, ld, dim, nq, lq, n_cand, hits = 300, 12, 16, 5, 6, 24, 10
    emb, mask = synthetic_corpus(n, ld, dim, seed=16)
    q = queries(nq, lq, dim, seed=17)
    searcher = port_searcher(torch_cache, dim=dim, quantize=quantize, prefilter=n_cand)
    if quantize == "none":
        corpus = searcher._upload(emb, mask)
        jax_corpus = (jnp.asarray(emb, dtype=jnp.bfloat16), jnp.asarray(mask))
    else:
        corpus = searcher._upload_quantized(emb, mask, "int8")
        codes, scale = jax_quantize_rows(emb)
        jax_corpus = (jnp.asarray(codes), jnp.asarray(mask), jnp.asarray(scale))
    q_t = torch.from_numpy(q)

    # stage 1: the candidates
    cand = prefilter_candidates(q_t, searcher.pooled_docs(corpus), n_cand).numpy()
    s1, want_cand = jax_stage1(q, jax_corpus, n_cand)
    assert_same_selection(cand, want_cand, s1, STAGE1_TOL, f"{quantize} stage-1 candidates vs JAX")

    # stage 2 and the final order
    topk = searcher._prefilter_topk(corpus, n, hits, n_cand)
    got_s, got_o = (x.numpy() for x in topk(q_t, *corpus))
    assert got_s.shape == got_o.shape == (nq, hits)
    assert all(len(set(row)) == hits for row in got_o)  # no duplicate docids
    exact = (maxsim_scores(q_t, *corpus) if quantize == "none" else quantized_maxsim_scores(q_t, *corpus)).numpy()
    for qi in range(nq):
        np.testing.assert_array_equal(got_s[qi], exact[qi, got_o[qi]])  # the exact engine's scores, bit for bit
        order = sorted(cand[qi], key=lambda d: (-exact[qi, d], list(cand[qi]).index(d)))[:hits]
        assert list(got_o[qi]) == order  # stable descending sort in candidate order

    jax_topk = JaxColbert._prefilter_topk(None, jax_corpus, n, hits, n_cand, 8)
    want_s, want_o = (np.asarray(x) for x in jax_topk(jnp.asarray(q), *jax_corpus))
    tol = BF16_HITS_TOL if quantize == "none" else INT8_ATOL
    for qi in range(nq):
        got_hits = [(int(o), float(s)) for s, o in zip(got_s[qi], got_o[qi]) if np.isfinite(s)]
        want_hits = [(int(o), float(s)) for s, o in zip(want_s[qi], want_o[qi]) if np.isfinite(s)]
        if quantize == "none":
            assert_same_ranking(got_hits, want_hits, tol, f"bf16 prefilter query {qi} vs JAX")
        else:
            want_of = dict(want_hits)
            for d, s in got_hits:
                if d in want_of:
                    assert s == pytest.approx(want_of[d], rel=INT8_RTOL, abs=INT8_ATOL), (qi, d)
            assert len(set(want_of) & {d for d, _ in got_hits}) >= hits - 2, f"int8 query {qi}: hits vs JAX"


def test_prefilter_clamps_hits_to_the_candidates(torch_cache):
    emb, mask = synthetic_corpus(40, 6, 8, seed=3)
    searcher = port_searcher(torch_cache, prefilter=7)
    corpus = searcher._upload(emb, mask)
    s, o = searcher._prefilter_topk(corpus, 40, 10, 7)(torch.from_numpy(queries(2, 4, 8, seed=4)), *corpus)
    assert tuple(s.shape) == tuple(o.shape) == (2, 7)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_prefilter_at_or_above_the_corpus_equals_exact(tmpdir_as_cache, torch_cache, quantize):
    jax_searcher = JaxSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, "chunk": 2,
                                                  "quantize": quantize, "prefilter": 10})
    jax_searcher.index.create_index()
    ckpt = jax_tiny_checkpoint(jax_searcher, torch_cache / "colbert.npz")
    exact = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": ckpt, "quantize": quantize})
    full = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": ckpt, "quantize": quantize, "prefilter": 10})
    for searcher in (exact, full):
        searcher.device = "cpu"
    q = exact.encode_queries(exact._tokenize(QUERIES, 8))
    (e_fn, e_corpus, _), (f_fn, f_corpus, n) = exact.build_topk(3), full.build_topk(3)
    assert n == 3 and full.prefilter_candidates == 3
    for got, want in zip(f_fn(q, *f_corpus), e_fn(q, *e_corpus)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for query in QUERIES:
        got, want = full.query(query), jax_searcher.query(query)
        if quantize == "none":
            assert_same_run(got, want, f"prefilter 10 '{query}' vs JAX")
        else:
            assert_same_ranking(list(got.items()), list(want.items()), SEARCH_TOL, f"int8 prefilter '{query}' vs JAX")


def test_prefilter_service_and_tight_prefilter_on_a_small_corpus(tmpdir_as_cache, torch_cache):
    corpus = tmpdir_as_cache / "corpus"
    write_trec_corpus(corpus, num_docs=60, seed=31, min_len=10, max_len=60)
    config = {key: value for key, value in SEARCHER.items() if key != "index"}
    qs = ["w1 w7 w30", "w2 w25 galaxy", "w39 w5 w6 w8", "w11", "w3 w4", "orbit w12"]
    jax_exact = JaxColbertService.from_config(collection="dummy", collection_path=str(corpus), max_k=10,
                                              allowrandominit=True, **config)
    ckpt = jax_tiny_checkpoint(jax_exact.searcher, torch_cache / "colbert.npz")
    port = ColbertRetrievalService.from_config(collection="dummy", collection_path=str(corpus), max_k=10,
                                               device="cpu", checkpointfile=ckpt, prefilter=12, **config)
    exact = ColbertRetrievalService.from_config(collection="dummy", collection_path=str(corpus), max_k=10,
                                                device="cpu", checkpointfile=ckpt, **config)
    jax_pre = JaxColbertService.from_config(collection="dummy", collection_path=str(corpus), max_k=10,
                                            allowrandominit=True, prefilter=12, **config)
    got, full, want = port.search(qs, k=10), exact.search(qs, k=10), jax_pre.search(qs, k=10)
    overlap = []
    for hits, ref, jax_hits in zip(got, full, want):
        assert len(hits) == 10 and len({d for d, _ in hits}) == 10
        ref_of = dict(ref)
        for d, s in hits:  # a prefiltered hit scores what the exact engine gives it
            if d in ref_of:
                assert s == ref_of[d]
        assert_same_ranking(hits, jax_hits, SEARCH_TOL, "prefilter 12 service vs JAX")
        overlap.append(len({d for d, _ in hits} & set(ref_of)) / 10)
    jax_overlap = [len({d for d, _ in a} & {d for d, _ in b}) / 10 for a, b in zip(want, jax_exact.search(qs, k=10))]
    print(f"prefilter 12 of 60 docs, random-init encoder: top-10 overlap with exact {overlap} (JAX {jax_overlap})")


def streamed_pair(torch_cache, quantize, budget_docs, chunk, corpus_dir):
    """(resident searcher, streamed searcher) over one cache; the streamed
    budget holds two slices of about ``budget_docs`` docs."""
    index = {"collection": {"name": "dummy", "path": str(corpus_dir)}}
    resident = port_searcher(torch_cache, quantize=quantize, chunk=chunk, index=index)
    q_emb = resident.encode_queries(resident._tokenize(QUERIES, 8))
    row_bytes = 32 * 8 * (1 if quantize == "int8" else 2) + 32 + (4 if quantize == "int8" else 0)
    streamed = port_searcher(torch_cache, quantize=quantize, chunk=chunk, index=index,
                             hbmbudget=2 * budget_docs * row_bytes / 1e6)
    return resident, streamed, q_emb


@pytest.mark.parametrize("quantize,budget_docs,chunk", [("none", 7, 1), ("none", 16, 4), ("int8", 7, 2),
                                                        ("int8", 20, 20)])
def test_streamed_equals_resident_bit_for_bit(tmpdir_as_cache, torch_cache, quantize, budget_docs, chunk):
    corpus_dir = tmpdir_as_cache / "corpus"
    write_trec_corpus(corpus_dir, num_docs=50, seed=5, min_len=10, max_len=60)
    resident, streamed, q = streamed_pair(torch_cache, quantize, budget_docs, chunk, corpus_dir)
    r_fn, r_corpus, n = resident.build_topk(20)
    s_fn, s_corpus, n_s = streamed.build_topk(20)
    assert n == n_s == 50 and s_corpus == ()
    upload = max(chunk, budget_docs - budget_docs % chunk)  # JAX's slice rule
    assert streamed.stream_slices == -(-50 // upload) > 1
    for got, want in zip(s_fn(q), r_fn(q, *r_corpus)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if quantize == "int8":  # the int8 slices come from the disk cache beside the f16 one
        host = streamed._docs_emb
        assert host.emb.dtype == np.int8 and host.emb.shape == (50, 32 * 8)
        assert str(host.emb.filename).endswith(".emb.int8.npy")


def test_streamed_matches_jax(tmpdir_as_cache, torch_cache):
    jax_searcher = JaxSearcher.create("colbert", {**SEARCHER, "allowrandominit": True, "chunk": 1, "hbmbudget": 1e-4})
    jax_searcher.index.create_index()
    ckpt = jax_tiny_checkpoint(jax_searcher, torch_cache / "colbert.npz")
    searcher = TorchSearcher.create("colbert", {**SEARCHER, "checkpointfile": ckpt, "chunk": 1, "hbmbudget": 1e-4})
    searcher.device = "cpu"
    for query in QUERIES:
        assert_same_run(searcher.query(query), jax_searcher.query(query), f"streamed '{query}' vs JAX")
    assert searcher.stream_slices == 3


REFUSALS = [
    ({"quantize": "int4", "hbmbudget": 1e-4}, "query"),  # int4 over the budget: resident-only
    ({"prefilter": 2, "hbmbudget": 1e-4}, "query"),  # prefilter does not stream
    ({"quantize": "int4", "prefilter": 2}, "create"),
    ({"prefilter": 2, "shards": 2}, "create"),
]


@pytest.mark.parametrize("options,when", REFUSALS, ids=["int4-over-budget", "prefilter-streaming",
                                                        "int4-prefilter", "prefilter-shards"])
def test_refusals_raise_jax_messages(tmpdir_as_cache, torch_cache, options, when):
    def attempt(create, error):
        with pytest.raises(error) as info:
            searcher = create("colbert", {**SEARCHER, "allowrandominit": True, **options})
            searcher.device = "cpu"
            searcher.index.create_index()
            searcher.query(QUERIES[0])
        return str(info.value)

    assert attempt(TorchSearcher.create, ConfigError) == attempt(JaxSearcher.create, JaxConfigError)


@pytest.mark.parametrize("options", [{"prefilter": 2}, {"prefilter": 2, "quantize": "int8"}, {"hbmbudget": 1e-4},
                                     {"hbmbudget": 1e-4, "quantize": "int8"}],
                         ids=["prefilter-bf16", "prefilter-int8", "streamed-bf16", "streamed-int8"])
def test_kernel_inputs_meet_the_kernels_layout(torch_cache, monkeypatch, options):
    """On the card K3 and X1 take contiguous tensors only (the CPU's plain
    versions take any): every path hands them contiguous ones."""
    from capreolus_tpu_torch.ops import int8_matmul as im
    from capreolus_tpu_torch.ops import maxsim as ms

    seen = []

    def spy(module, name):
        original = getattr(module, name)

        def check(*tensors):
            seen.append(name)
            assert all(t.is_contiguous() for t in tensors if isinstance(t, torch.Tensor)), name
            return original(*tensors)

        monkeypatch.setattr(module, name, check)

    spy(ms, "maxsim_scores")
    spy(im, "int8_mm")
    searcher = port_searcher(torch_cache, chunk=1, **options)
    assert len(searcher.query(QUERIES[0])) == (2 if "prefilter" in options else 3)
    assert seen
