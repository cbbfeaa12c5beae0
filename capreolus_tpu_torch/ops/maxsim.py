"""K3: ColBERT MaxSim over a token-major corpus.

The port of the JAX package's ``ops/maxsim.py``, with its public signatures.
For queries q [Q, Lq, dim], docs_t [Ld, C, dim] (token-major), an additive
mask bias_t [Ld, C] (0 valid, -1e9 masked) and valid [C] (doc has a valid
token), the score of (query, doc) is the sum over query tokens of the max over
the doc's valid tokens of ``bf16(q_i) . bf16(d_k)`` computed in f32, and -inf
for an invalid doc: the function of the Pallas ``_maxsim_kernel`` and of the
searcher's exact engine.

- ``maxsim`` is the binding of the hand-written Hopper kernel
  ``csrc/maxsim.cu`` (``wgmma`` on bf16, fed by TMA) and counts its launches
  in ``maxsim.launches``; it has no backward and refuses a query that requires
  grad, on any device (ColBERT trains through ``reranker.colbert.maxsim``);
  ``maxsim_plan`` decides its launch (rows per block, Ld splits, grid);
- ``maxsim_scores_plain`` is the plain torch version of the same function,
  which the kernel is held against on the card;
- ``maxsim_scores`` is what the searcher calls: CUDA tensors go to the kernel,
  CPU tensors to the plain version, and any other device raises;
- ``maxsim_scores_ref`` is the JAX module's [C, Ld, dim] formulation, which the
  tests compare with JAX's.

A valid doc scores the same whether a masked token is biased by -1e9 (Pallas,
XLA) or left out of the max (here): a valid token always wins.
"""

from __future__ import annotations

import ctypes

import torch

from capreolus_tpu_torch.ops import build

_LIMITS = {}
DOC_TILE = 64  # docs per block: the wgmma N
ROW_TILE = 64  # query rows per consumer warpgroup: the wgmma M
WARPGROUPS = 3  # consumer warpgroups of a block with more than 64 query rows: their registers fill an SM
MAX_SPLITS = 8  # Ld ranges per doc tile: the portable thread-block cluster size
SPLIT_WAVES = 4  # a split launch aims at this many waves of resident blocks
PLAIN_CHUNK_ELEMENTS = 1 << 26  # similarity entries per step of the plain version (512 MB of f64)


def sum_query_tokens(x):
    """[Q, Lq, C] -> [Q, C]: the sum over query tokens as a fixed pairwise
    tree of elementwise adds, so that a doc's score is the same bits whatever
    the other docs and queries of its call (a resident chunk, a streamed
    slice, one query's prefilter candidates) and on every device;
    ``sum(dim=1)``'s order may follow the shape."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        head = x[:, :half] + x[:, half : 2 * half]
        x = torch.cat([head, x[:, 2 * half :]], dim=1) if x.shape[1] % 2 else head
    return x[:, 0]


def maxsim_scores_plain(q_emb, docs_t, bias_t, valid):
    """Plain torch version of K3: q_emb [Q, Lq, dim], docs_t [Ld, C, dim],
    bias_t [Ld, C], valid [C] -> [Q, C] f32.

    q and docs are cast to bf16; each similarity is accumulated in f64 (the
    products of bf16 values are exact, and so is their f64 sum but in
    extreme exponent spreads) and rounded to f32, so that it does not depend
    on the shape of the call; a token with a negative bias is left out of the
    max; the maxima are summed over query tokens by ``sum_query_tokens``; an
    invalid doc gets -inf. The docs go in slices of C so that the
    [Q*Lq, Ld, slice] similarities stay near 512 MB."""
    nq, lq, dim = q_emb.shape
    ld, c = docs_t.shape[0], docs_t.shape[1]
    q2d = q_emb.to(torch.bfloat16).double().reshape(nq * lq, dim)
    out = torch.empty((nq, c), dtype=torch.float32, device=q_emb.device)
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(1, nq * lq * ld))
    for start in range(0, c, step):
        d = docs_t[:, start:start + step].to(torch.bfloat16).double()  # [Ld, cc, dim]
        cc = d.shape[1]
        sim = (q2d @ d.reshape(ld * cc, dim).T).float().view(nq * lq, ld, cc)
        sim = sim.masked_fill((bias_t[:, start:start + step] < 0)[None], float("-inf"))
        out[:, start:start + cc] = sum_query_tokens(sim.amax(dim=1).view(nq, lq, cc))
    return torch.where(valid.bool()[None, :], out, float("-inf"))


def maxsim_plan(nq, lq, ld, c, sms=132):
    """K3's launch for Q = ``nq`` queries of ``lq`` tokens over ``c`` docs of
    ``ld`` tokens on a card of ``sms`` SMs, as a dict.

    - ``warpgroups`` (W): consumer warpgroups per block, each 64 query rows:
      1 where one warpgroup holds every row, else ``WARPGROUPS`` (3), so that
      one block's tensor cores run three row tiles on each doc tile it loads;
    - ``qw``: whole queries per warpgroup tile (Lq <= 64: ``64 // lq``), so a
      query's sum never leaves its block; 1 for a longer query, which is cut
      into ``chunks`` of 64 rows that the block's warpgroups take in
      ``passes`` over the tokens;
    - ``groups``: row groups per doc tile; ``tiles``: doc tiles of 64;
    - ``splits``: Ld ranges per (doc tile, row group), one block each in a
      thread-block cluster, so that few queries still fill the card (1 for a
      chunked query);
    - ``blocks``: the grid, tiles x groups x splits."""
    tiles = -(-c // DOC_TILE)
    if lq <= ROW_TILE:
        qw, chunks = ROW_TILE // lq, 1
        wg_tiles = -(-nq // qw)
        w = 1 if wg_tiles == 1 else WARPGROUPS
        groups, passes = -(-wg_tiles // w), 1
        resident = sms * (2 if w == 1 else 1)  # blocks per SM: shared memory and registers
        wanted = -(-SPLIT_WAVES * resident // (tiles * groups))
        splits = 1  # a power of two: a cluster's blocks split the 64 docs evenly at the end
        while splits * 2 <= min(MAX_SPLITS, ld) and splits < wanted:
            splits *= 2
    else:
        qw, chunks = 1, -(-lq // ROW_TILE)
        w = WARPGROUPS
        groups, passes, splits = nq, -(-chunks // w), 1
    return {"warpgroups": w, "qw": qw, "chunks": chunks, "passes": passes, "groups": groups,
            "splits": splits, "tiles": tiles, "blocks": tiles * groups * splits}


def maxsim_scores_ref(q_emb, docs, dmask):
    """The JAX module's reference: q_emb [Q, Lq, dim], docs [C, Ld, dim], dmask
    [C, Ld] -> [Q, C] = sum over Lq of max over Ld of ``q . d`` (bf16 inputs,
    f32 products) with masked tokens at -1e9 and fully masked docs at -inf."""
    sim = torch.einsum("qle,cke->qclk", q_emb.to(torch.bfloat16).float(), docs.to(torch.bfloat16).float())
    sim = torch.where(dmask[None, :, None, :] > 0, sim, -1e9)
    per_q_token = sim.amax(dim=-1)
    valid = (dmask != 0).any(dim=-1)[None, :]
    return torch.where(valid, per_q_token.sum(dim=-1), float("-inf"))


def _lib():
    lib = build.load("maxsim")
    if not _LIMITS:
        lib.maxsim_launch.restype = ctypes.c_int
        lib.maxsim_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        lib.maxsim_max_dim.restype = ctypes.c_int
        lib.maxsim_max_dim.argtypes = []
        _LIMITS["dim"] = lib.maxsim_max_dim()
    return lib


def maxsim(q_emb, docs_t, bias_t, valid):
    """K3 on CUDA tensors: q_emb [Q, Lq, dim] (cast to bf16 here), docs_t
    [Ld, C, dim] bf16, bias_t [Ld, C] f32, valid [C] bool, the corpus tensors
    contiguous and 16-byte aligned, 1 <= dim <= 128. Raises on anything else,
    CPU tensors included (``maxsim_scores`` routes those to the plain version),
    and on a ``q_emb`` that requires grad: the kernel has no backward."""
    if q_emb.requires_grad:
        raise ValueError("maxsim: q_emb requires grad, and the kernel has no backward; "
                         "a training forward takes reranker.colbert.maxsim")
    device = q_emb.device
    if device.type != "cuda":
        raise ValueError(f"maxsim: q_emb is on {device}; the kernel takes CUDA tensors only")
    for name, t in (("docs_t", docs_t), ("bias_t", bias_t), ("valid", valid)):
        if t.device != device:
            raise ValueError(f"maxsim: {name} is on {t.device}, q_emb on {device}")
    if q_emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"maxsim: q_emb dtype {q_emb.dtype} is not float32 or bfloat16")
    for name, t, dtype in (("docs_t", docs_t, torch.bfloat16), ("bias_t", bias_t, torch.float32),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"maxsim: {name} has dtype {t.dtype}, expected {dtype}")
    if q_emb.dim() != 3 or docs_t.dim() != 3:
        raise ValueError(f"maxsim: q_emb and docs_t must be 3-D, got {tuple(q_emb.shape)} and {tuple(docs_t.shape)}")
    nq, lq, dim = q_emb.shape
    ld, c = docs_t.shape[0], docs_t.shape[1]
    if docs_t.shape[2] != dim:
        raise ValueError(f"maxsim: docs_t dim {docs_t.shape[2]} differs from q_emb dim {dim}")
    if tuple(bias_t.shape) != (ld, c) or tuple(valid.shape) != (c,):
        raise ValueError(f"maxsim: bias_t {tuple(bias_t.shape)} and valid {tuple(valid.shape)} must be "
                         f"{(ld, c)} and {(c,)}")
    if not (docs_t.is_contiguous() and bias_t.is_contiguous() and valid.is_contiguous()):
        raise ValueError("maxsim: docs_t, bias_t and valid must be contiguous")
    if docs_t.data_ptr() % 16 or bias_t.data_ptr() % 16:
        raise ValueError("maxsim: docs_t and bias_t must start on a 16-byte boundary")
    lib = _lib()
    if not 1 <= dim <= _LIMITS["dim"] or min(lq, ld) < 1 or nq * lq >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"maxsim: shape Q={nq} Lq={lq} Ld={ld} C={c} dim={dim} outside the kernel's limits "
                         f"(1 <= dim <= {_LIMITS['dim']}, Lq >= 1, Ld >= 1, Q*Lq and C below 2**31)")
    out = torch.empty((nq, c), dtype=torch.float32, device=device)
    if nq == 0 or c == 0:
        return out
    q = q_emb.to(torch.bfloat16).contiguous()
    plan = maxsim_plan(nq, lq, ld, c, sms=torch.cuda.get_device_properties(device).multi_processor_count)
    if plan["blocks"] >= 2 ** 31:
        raise ValueError(f"maxsim: {plan['blocks']} blocks for Q={nq} Lq={lq} C={c}: above the grid's limit")
    plan_args = (ctypes.c_int * 6)(*(plan[k] for k in ("warpgroups", "qw", "chunks", "passes", "groups", "splits")))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.maxsim_launch(q.data_ptr(), docs_t.data_ptr(), bias_t.data_ptr(), valid.data_ptr(),
                                out.data_ptr(), nq, lq, ld, c, dim, ctypes.addressof(plan_args), stream)
    if err != 0:
        raise RuntimeError(f"maxsim kernel launch failed: cudaError {err}")
    maxsim.launches += 1
    return out


maxsim.launches = 0


def maxsim_scores(q_emb, docs_t, bias_t, valid):
    """Fused MaxSim over a token-major corpus (the JAX ``maxsim_scores``):
    K3 for CUDA tensors, ``maxsim_scores_plain`` for CPU tensors. Returns
    [Q, C] f32 with invalid docs at -inf."""
    if q_emb.device.type == "cuda":
        return maxsim(q_emb, docs_t, bias_t, valid)
    if q_emb.device.type == "cpu":
        return maxsim_scores_plain(q_emb, docs_t, bias_t, valid)
    raise ValueError(f"maxsim_scores: unsupported device {q_emb.device}")
