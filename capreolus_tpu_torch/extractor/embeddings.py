"""Word-embedding tables with npy+vocab caching (the JAX package's
``extractor/embeddings.py``).

Pretrained vectors are read from ``<cache>/embeddings/<name>.npy`` plus
``<name>.vocab.txt``; the port never downloads them. The deterministic
``random*`` families derive each term's vector from its text (``hash_embed``),
so the whole pipeline runs offline at the published widths (``random300`` is
GloVe-6B's 300).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from capreolus_tpu_torch.core import constants
from capreolus_tpu_torch.utils.exceptions import OfflineEnvironmentError
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

EMBEDDING_DIMS = {"glove6b": 300, "glove6b.50d": 50, "w2vnews": 300, "fasttext": 300}
RANDOM_DIMS = {"random": 50, "random8": 8, "random300": 300}


def embedding_dim(name: str) -> int:
    if name in RANDOM_DIMS:
        return RANDOM_DIMS[name]
    if name in EMBEDDING_DIMS:
        return EMBEDDING_DIMS[name]
    raise ValueError(f"unknown embedding source {name!r}")


def load_pretrained_embeddings(name: str):
    """Returns (matrix float32 [V, dim], vocab dict term->row), or (None, None)
    for the random families, whose vectors are derived per term at lookup time."""
    cache_dir = Path(constants["CACHE_BASE_PATH"]) / "embeddings"
    npy_fn = cache_dir / f"{name}.npy"
    vocab_fn = cache_dir / f"{name}.vocab.txt"
    if npy_fn.exists() and vocab_fn.exists():
        matrix = np.load(npy_fn)
        vocab = {t: i for i, t in enumerate(vocab_fn.read_text(encoding="utf-8").splitlines())}
        return matrix, vocab
    if name in RANDOM_DIMS:
        return None, None
    if name not in EMBEDDING_DIMS:
        raise ValueError(f"unknown embedding source {name!r}; known: {sorted(EMBEDDING_DIMS) + sorted(RANDOM_DIMS)}")
    raise OfflineEnvironmentError(
        f"embeddings {name!r} not cached at {npy_fn}; convert the vectors to a "
        f"[V,{EMBEDDING_DIMS[name]}] .npy + vocab.txt there, or use embeddings=random300"
    )


def hash_embed(term: str, dim: int) -> np.ndarray:
    """Deterministic pseudo-random unit vector for a term (offline embedding mode)."""
    seed = np.frombuffer(term.encode("utf-8").ljust(8, b"\0")[:8], dtype=np.uint64)[0]
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    v = rng.standard_normal(dim).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-9)


def build_embedding_matrix(name: str, terms):
    """Build an embedding matrix for ``terms`` with row 0 = padding zeros.

    Returns (matrix [n_found+1, dim], stoi). Terms present in the pretrained
    vectors map to rows >= 1; terms absent from them get *negative* ids (the OOV
    exact-match convention). In the ``random`` modes every term gets a hash vector.
    """
    matrix_full, vocab = load_pretrained_embeddings(name)
    dim = embedding_dim(name)
    stoi = {}
    rows = [np.zeros(dim, dtype=np.float32)]
    next_oov = -1
    for term in terms:
        if matrix_full is not None:
            row = vocab.get(term)
            if row is not None:
                stoi[term] = len(rows)
                rows.append(matrix_full[row])
            else:
                stoi[term] = next_oov
                next_oov -= 1
        else:
            stoi[term] = len(rows)
            rows.append(hash_embed(term, dim))
    if matrix_full is not None and next_oov < -1:
        logger.info("%d/%d terms missing from %s embeddings (negative OOV ids)", -next_oov - 1, len(stoi), name)
    return np.stack(rows), stoi
