"""IVF (inverted-file) clustering for dense retrieval: spherical k-means and
the cluster-major layout (the JAX package's ``searcher/ivf.py``).

A spherical k-means over the L2-normalised document embeddings partitions
the corpus into K cells; a query scores the K centroids, probes the
``nprobe`` best cells and scores only their documents exactly
(``searcher/dense.py``). ``nprobe = K`` probes every cell and equals exact
search.

Training follows the FAISS recipe, as the JAX function does: Lloyd's
iterations run on a sample of at most ``sample_cap`` rows, initialised from
its first K rows; then one full assignment pass with the final centroids, in
slabs of ``slab`` rows. Each step is the JAX step's arithmetic: a bf16 x bf16
product with f32 scores, the first maximum's cell (``argmax``), f32 segment
sums and counts, the mean re-normalised, an empty cell keeping its centroid.
The sample is the port's own draw (a ``torch.Generator`` permutation seeded
with ``seed``), not JAX's threefry permutation: the two packages' cells
differ for the same corpus unless the caller passes the sample
(``sample_idx``) or the trained layout (the searcher's ``.npz`` cache).
"""

from __future__ import annotations

import numpy as np
import torch

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

_ASSIGN_SLAB = 131072  # rows per assignment slab (a bf16 768-dim slab is 192 MB)


def _slab_f32(docs, start, stop):
    """Rows [start, stop) of a corpus (a bf16 tensor or an int8 (codes,
    scales) pair) as a dequantized slab: int8 codes times their scale, both
    in bf16, as the JAX function dequantizes them."""
    if isinstance(docs, tuple):
        codes, scale = docs
        return codes[start:stop].to(torch.bfloat16) * scale[start:stop, None].to(torch.bfloat16)
    return docs[start:stop]


def bf16_sims(rows, centroids):
    """[n, D] rows x [K, D] centroids -> [n, K] f32 of the bf16-rounded
    operands, as JAX's bf16 product with ``preferred_element_type=float32``:
    a bf16 GEMM with an f32 output on CUDA, else an f32 product of the bf16
    values (each product exact in f32; TF32 stays off). Never a bf16 output,
    which would round the scores to 8 bits."""
    a, b = rows.to(torch.bfloat16), centroids.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def init_centroids(rows, k):
    c = rows[:k].float()
    return c / torch.clamp_min(torch.linalg.vector_norm(c, dim=1, keepdim=True), 1e-9)


def lloyd_step(rows, centroids):
    """One Lloyd iteration over ``rows`` (cosine assignment, f32 means
    re-normalised; an empty cell keeps its centroid)."""
    k = centroids.shape[0]
    a = torch.argmax(bf16_sims(rows, centroids), dim=1)
    rows32 = rows.float()
    sums = torch.zeros((k, rows.shape[1]), dtype=torch.float32, device=rows.device).index_add_(0, a, rows32)
    counts = torch.zeros((k,), dtype=torch.float32, device=rows.device).index_add_(
        0, a, torch.ones((rows.shape[0],), dtype=torch.float32, device=rows.device))
    new = sums / torch.clamp_min(counts[:, None], 1.0)
    new = new / torch.clamp_min(torch.linalg.vector_norm(new, dim=1, keepdim=True), 1e-9)
    return torch.where((counts > 0)[:, None], new, centroids)


def assign_slab(rows, centroids):
    """[n] int32: each row's cell, the first of equal maxima."""
    return torch.argmax(bf16_sims(rows, centroids), dim=1).to(torch.int32)


def spherical_kmeans(docs, k, iters=10, seed=0, sample_cap=None, slab=_ASSIGN_SLAB, sample_idx=None):
    """Spherical k-means over [N, D] embeddings on their device.

    ``docs`` is a bf16 tensor [N, D] or an int8 pair (codes [N, D], scales
    [N]), dequantized a slab at a time. Returns (centroids [K, D] f32,
    L2-normalised, assign [N] int32 numpy). ``sample_idx`` replaces the
    port's draw of the sample (a JAX permutation reproduces JAX's cells).
    """
    n = docs[0].shape[0] if isinstance(docs, tuple) else docs.shape[0]
    device = docs[0].device if isinstance(docs, tuple) else docs.device
    k = int(min(k, n))
    if sample_cap is None:
        sample_cap = max(10_000, 64 * k)
    n_sample = int(min(n, sample_cap))
    if sample_idx is None:
        sample_idx = torch.randperm(n, generator=torch.Generator().manual_seed(int(seed)))[:n_sample]
    sample_idx = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64).to(device)
    if isinstance(docs, tuple):
        sample = _slab_f32((docs[0][sample_idx], docs[1][sample_idx]), 0, n_sample)
    else:
        sample = docs[sample_idx]
    centroids = init_centroids(sample, k)
    for _ in range(max(1, int(iters))):
        centroids = lloyd_step(sample, centroids)
    del sample
    parts = [assign_slab(_slab_f32(docs, start, min(n, start + slab)), centroids).cpu().numpy()
             for start in range(0, n, slab)]
    assign = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
    return centroids, assign


def build_cells(assign_np, k):
    """Cluster-major permutation + per-cell extents from an assignment vector.

    Returns (order [N] int64, starts [K] int32, sizes [K] int32, max_size int).
    """
    order = np.argsort(assign_np, kind="stable")
    sizes = np.bincount(assign_np, minlength=k).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32)
    max_size = int(sizes.max()) if len(sizes) else 0
    return order, starts, sizes, max_size
