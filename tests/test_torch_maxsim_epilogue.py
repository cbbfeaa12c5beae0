"""The int8 ColBERT engine's MaxSim epilogue (``ops/maxsim_epilogue.py``) on
the CPU, where ``chunk_scores`` runs the plain version:

- through ``quantized_maxsim_scores``, the plain version gives the bits of the
  arithmetic the engine ran inline before the kernel (a copy kept here), at
  odd and even query lengths, with masks that are not prefixes and docs with
  no valid token, over int8 and int4 corpora, at several chunk sizes;
- the kernel's walk (``csrc/maxsim_epilogue.cu``: a block per query and tile
  of 32 docs, each doc's range of valid vectors, 8 lanes a token row reading
  every 8th vector, two at a time, the pairwise tree, the scale products)
  replayed in Python over the flat int32 buffer gives the plain version's
  bits, at each of its vector widths;
- the dispatcher sends CPU tensors to the plain version, and the binding
  refuses what the kernel does not take.

The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from capreolus_tpu_torch.ops import maxsim_epilogue as mx
from capreolus_tpu_torch.ops import quantization as pq
from capreolus_tpu_torch.ops.int8_matmul import int8_matmul_plain, int8_mm
from capreolus_tpu_torch.ops.maxsim import sum_query_tokens
from capreolus_tpu_torch.searcher import late_interaction as li


def inline_scores(q_emb, docs, mask, dscale):
    """``quantized_maxsim_scores`` as the engine computed it before the
    epilogue kernel: the chunk loop with the epilogue inline."""
    q_i8, qscale = pq.quantize_rows_torch(q_emb)
    nq, lq, dim = q_i8.shape
    n, ld = mask.shape
    q2d = q_i8.reshape(nq * lq, dim)
    step = li.quantized_chunk_docs(nq, lq, ld)
    out = torch.empty((nq, n), dtype=torch.float32, device=q_i8.device)
    for c0 in range(0, n, step):
        d = docs[c0 : c0 + step]
        c = d.shape[0]
        if d.dtype == torch.uint8:
            d = pq.unpack_int4(d)[:, : ld * dim]
        sim = int8_mm(q2d, d.reshape(c * ld, dim).contiguous()).to(torch.bfloat16).view(nq, lq, c, ld)
        sim.masked_fill_(~mask[c0 : c0 + c][None, None], -1e9)
        per_q_token = sim.amax(dim=-1).float()
        out[:, c0 : c0 + c] = sum_query_tokens(per_q_token) * qscale[:, None] * dscale[None, c0 : c0 + c]
    return torch.where(mask.any(dim=1)[None, :], out, float("-inf"))


def corpus(n, ld, dim, seed):
    """Token embeddings [n, ld, dim] and a mask that is no prefix: ~60% of the
    slots valid at random, docs 0 and 11 with no valid token, doc 2 all valid."""
    rng = np.random.Generator(np.random.PCG64(seed))
    emb = (rng.standard_normal((n, ld, dim)) * 0.3).astype(np.float32)
    mask = torch.from_numpy(rng.random((n, ld)) > 0.4)
    mask[[0, 11]] = False
    mask[2] = True
    return emb, mask


@pytest.mark.parametrize("chunk_docs", [None, 4, 1], ids=["whole", "4-docs", "1-doc"])
@pytest.mark.parametrize("quantize", ["int8", "int4"])
@pytest.mark.parametrize("lq", [3, 5, 32])
def test_plain_epilogue_is_the_inline_arithmetic(monkeypatch, lq, quantize, chunk_docs):
    nq, n, ld, dim = 3, 23, 9, 16
    emb, mask = corpus(n, ld, dim, seed=lq)
    codes, scale = pq.quantize_rows(emb) if quantize == "int8" else pq.quantize_rows_int4(emb.reshape(n, -1))
    q = torch.from_numpy(np.random.Generator(np.random.PCG64(lq + 100)).standard_normal((nq, lq, dim))
                         .astype(np.float32))
    if chunk_docs is not None:
        monkeypatch.setattr(li, "SIM_CHUNK_BYTES", 4 * nq * lq * ld * chunk_docs)
        assert li.quantized_chunk_docs(nq, lq, ld) == chunk_docs
    args = (q, torch.from_numpy(codes), mask, torch.from_numpy(scale))
    got, want = li.quantized_maxsim_scores(*args), inline_scores(*args)
    assert torch.equal(got, want)
    assert bool(torch.isneginf(got[:, [0, 11]]).all()) and bool(torch.isfinite(got[:, 1:11]).all())


def kernel_replay(sim, mask, qscale, dscale, out, col0, vec):
    """``csrc/maxsim_epilogue.cu``'s walk at vector width ``vec`` over the flat
    buffers, in f32 as the kernel rounds: each block's docs' [lo, hi) vector
    ranges from the mask, each token row's max from its 8 lanes' vectors (a
    vector read only where it holds a valid token), bf16(-1e9) where a doc has
    a masked token, the pairwise tree in place over the row maxima, then
    ``(sum * qscale) * dscale`` or -inf."""
    docs_per_tile, row_lanes, unroll = 32, 8, 2
    nq, (c, ld) = qscale.shape[0], mask.shape
    lq = sim.shape[0] // nq
    flat = sim.reshape(-1).float().to(torch.bfloat16).float().numpy()  # int32 -> f32 -> bf16, to nearest even
    mflat = mask.reshape(-1).numpy()
    masked_fill = np.float32(torch.tensor(-1e9, dtype=torch.bfloat16).float())
    row_len = c * ld
    tiles = -(-c // docs_per_tile)
    outflat = out.view(-1).numpy()
    for block in range(nq * tiles):
        q, d0 = block // tiles, block % tiles * docs_per_tile
        nd = min(docs_per_tile, c - d0)
        lo, hi, has_masked = [], [], []
        for d in range(nd):
            m = mflat[(d0 + d) * ld : (d0 + d + 1) * ld]
            valid = np.flatnonzero(m)
            lo.append(int(valid[0]) // vec if len(valid) else ld // vec)
            hi.append(int(valid[-1]) // vec + 1 if len(valid) else 0)
            has_masked.append(not m.all())
        row_max = np.zeros((lq, docs_per_tile), np.float32)
        for t in range(lq):
            row = (q * lq + t) * row_len + d0 * ld
            for d in range(nd):
                if hi[d] <= lo[d]:
                    continue
                doc, doc_mask = row + d * ld, (d0 + d) * ld
                lane_best = []
                for g in range(row_lanes):
                    best = np.float32(-np.inf)
                    for v0 in range(lo[d] + g, hi[d], row_lanes * unroll):
                        for v in (v0 + u * row_lanes for u in range(unroll)):
                            if v >= hi[d]:
                                continue
                            bits = mflat[doc_mask + v * vec : doc_mask + (v + 1) * vec]
                            if bits.any():
                                x = flat[doc + v * vec : doc + (v + 1) * vec]
                                best = max([best] + [x[k] for k in range(vec) if bits[k]])
                    lane_best.append(best)
                best = np.float32(max(lane_best))
                row_max[t, d] = max(best, masked_fill) if has_masked[d] else best
        for d in range(nd):
            col, n_left = row_max[:, d], lq
            while n_left > 1:
                half = n_left // 2
                col[:half] = col[:half] + col[half : 2 * half]
                if n_left % 2:
                    col[half] = col[2 * half]
                n_left = half + n_left % 2
            score = (col[0] * np.float32(qscale[q])) * np.float32(dscale[d0 + d])
            outflat[q * out.stride(0) + col0 + d0 + d] = score if lo[d] < hi[d] else -np.inf
    return out


@pytest.mark.parametrize("lq", [5, 32])
@pytest.mark.parametrize("vec,ld", [(4, 12), (2, 6), (1, 7)])
def test_kernel_walk_gives_the_plain_bits(vec, ld, lq):
    nq, c, dim, n, col0 = 3, 70, 16, 90, 13
    emb, mask = corpus(c, ld, dim, seed=ld)
    codes, dscale = (torch.from_numpy(a) for a in pq.quantize_rows(emb))
    q_i8, qscale = pq.quantize_rows_torch(torch.randn(nq, lq, dim, generator=torch.Generator().manual_seed(vec)))
    sim = int8_matmul_plain(q_i8.reshape(nq * lq, dim), codes.reshape(c * ld, dim))
    want = mx.maxsim_epilogue_plain(sim, mask, qscale, dscale, torch.full((nq, n), 7.0), col0)
    got = kernel_replay(sim, mask, qscale, dscale, torch.full((nq, n), 7.0), col0, vec)
    assert torch.equal(got, want)
    assert bool((got[:, :col0] == 7.0).all()) and bool((got[:, col0 + c :] == 7.0).all())
    assert bool(torch.isneginf(got[:, col0 + 11]).all()) and bool(torch.isfinite(got[:, col0 + 2]).all())


def chunk_args(nq=2, lq=3, c=5, ld=4, n=9):
    sim = torch.randint(-2000, 2000, (nq * lq, c * ld), dtype=torch.int32, generator=torch.Generator().manual_seed(1))
    mask = torch.rand(c, ld, generator=torch.Generator().manual_seed(2)) > 0.3
    return [sim, mask, torch.rand(nq) + 0.5, torch.rand(c) + 0.5, torch.zeros(nq, n), 2]


def test_dispatcher_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the CUDA binding was called for CPU tensors")

    monkeypatch.setattr(mx, "maxsim_epilogue", boom)
    args = chunk_args()
    want = mx.maxsim_epilogue_plain(*args[:4], args[4].clone(), args[5])
    assert torch.equal(mx.chunk_scores(*args), want) and torch.equal(args[4], want)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in chunk_args()]
    with pytest.raises(ValueError, match="unsupported device"):
        mx.chunk_scores(*meta)


def bad_args(case):
    """``chunk_args`` with one fault, or none for ``cpu``."""
    args = chunk_args()
    sim, mask = args[0], args[1]
    if case == "sim_dtype":
        args[0] = sim.long()
    elif case == "mask_dtype":
        args[1] = mask.to(torch.uint8)
    elif case == "scale_dtype":
        args[2] = args[2].double()
    elif case == "sim_columns":
        args[0] = torch.zeros(sim.shape[0], sim.shape[1] + 1, dtype=torch.int32)
    elif case == "sim_rows":
        args[0] = torch.zeros(sim.shape[0] + 1, sim.shape[1], dtype=torch.int32)
    elif case == "dscale_length":
        args[3] = torch.ones(mask.shape[0] + 1)
    elif case == "sim_not_contiguous":
        args[0] = torch.zeros(sim.shape[0], 2 * sim.shape[1], dtype=torch.int32)[:, ::2]
    elif case == "out_too_narrow":
        args[5] = args[4].shape[1] - mask.shape[0] + 1
    elif case == "lq_above_limit":
        args[0] = torch.zeros(2 * (mx.MAX_LQ + 1), sim.shape[1], dtype=torch.int32)
    return args


@pytest.mark.parametrize("case,message", [
    ("cpu", "CUDA tensors only"), ("sim_dtype", "sim must be 2-D torch.int32"),
    ("mask_dtype", "mask must be 2-D torch.bool"), ("scale_dtype", "qscale must be 1-D torch.float32"),
    ("sim_columns", "is not \\[Q\\*Lq, C\\*Ld\\]"), ("sim_rows", "is not \\[Q\\*Lq, C\\*Ld\\]"),
    ("dscale_length", "dscale has 6 entries"), ("sim_not_contiguous", "sim must be contiguous"),
    ("out_too_narrow", "cannot take"), ("lq_above_limit", "outside the kernel's limits")])
def test_binding_refuses_what_the_kernel_does_not_take(case, message):
    before = mx.maxsim_epilogue.launches
    with pytest.raises(ValueError, match=message):
        mx.maxsim_epilogue(*bad_args(case))
    assert mx.maxsim_epilogue.launches == before
