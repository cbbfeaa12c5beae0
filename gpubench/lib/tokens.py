"""A ColBERT corpus that exists only as token embeddings made from the seed,
generated on the device a (token position, block of docs) at a time, so that
no copy of the whole corpus is ever held on the host or twice on the card.

Doc ``i`` has ``lengths[i]`` valid tokens. Token ``t`` of doc ``i`` is a
centre (one of ``centres`` seeded unit vectors) plus N(0, noise^2 / dim)
noise, normalised, rounded to f16 as the searcher's disk cache holds it; a
token past the doc's length is 0. Its values depend only on (seed, t, i //
block), whichever way the corpus is read: by token position (the searcher's
upload, the reference's token-major MaxSim) or by doc (``np.asarray``, the
int8 upload at a small corpus).

Lengths: the same multiset for every seed, in a seeded order: the quantiles
of a lognormal (``median``, ``sigma``) at (j + 0.5) / N, rounded and clipped
to [``min``, ``max``]."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from lib import weights
from lib.corpus import rng_of


def docid(i):
    """The docid the benchmark gives doc ``i`` of a token corpus."""
    return f"D{i:07d}"


def ordinal(docid_string):
    return int(docid_string[1:])


def length_quantiles(spec, n):
    """``n`` doc lengths (int64, ascending) of ``spec`` {"median", "sigma", "min", "max"}."""
    p = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    x = torch.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return torch.round(x).clamp_(spec["min"], spec["max"]).to(torch.int64).numpy()


class TokenCorpus:
    """[N, ld, dim] f16 token embeddings of ``spec`` {"docs", "centres",
    "noise", "block", "len"} under ``seed``, read as a numpy array is:
    ``shape``, ``dtype``, ``corpus[docs, tokens]`` (slices) and
    ``np.asarray(corpus)``; ``block(t, b)`` gives a device tensor."""

    dtype = np.dtype(np.float16)

    def __init__(self, spec, dim, ld, seed, device):
        self.n, self.ld, self.dim, self.seed = spec["docs"], ld, dim, seed
        self.device = torch.device(device)
        self.bs = min(spec["block"], self.n)
        self.noise = spec["noise"] / dim ** 0.5
        self.n_centres = spec["centres"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(weights.torch_seed(seed, "doc_centres"))
        self.centres = F.normalize(torch.randn((spec["centres"], dim), generator=gen, device=self.device), dim=1)
        self.lengths = rng_of(seed, "doc_lengths").permutation(length_quantiles(spec["len"], self.n))
        self.lengths_t = torch.from_numpy(self.lengths).to(self.device)
        self.shape = (self.n, ld, dim)
        self.blocks = -(-self.n // self.bs)

    @property
    def mask(self):
        """int8 [N, ld] numpy: 1 where a token is valid."""
        return (np.arange(self.ld)[None, :] < self.lengths[:, None]).astype(np.int8)

    @property
    def valid_tokens(self):
        return int(np.minimum(self.lengths, self.ld).sum())

    def docs_of(self, b):
        return b * self.bs, min(self.n, (b + 1) * self.bs)

    def valid(self, t, b):
        """bool [docs of block b] on the device: token t is valid."""
        d0, d1 = self.docs_of(b)
        return self.lengths_t[d0:d1] > t

    def block(self, t, b):
        """f16 [docs of block b, dim] on the device: token t of each doc of block b."""
        d0, d1 = self.docs_of(b)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(weights.torch_seed(self.seed, f"doc_tokens.{t}.{b}"))
        picks = torch.randint(0, self.n_centres, (d1 - d0,), generator=gen, device=self.device)
        noise = torch.randn((d1 - d0, self.dim), generator=gen, device=self.device)
        e = F.normalize(self.centres[picks] + noise * self.noise, dim=-1)
        return (e * self.valid(t, b)[:, None]).half()

    def __getitem__(self, key):
        """A numpy f16 [docs, tokens, dim] of ``corpus[docs]`` or
        ``corpus[docs, tokens]`` (slices of step 1), over page-locked memory
        on a card, so that the copies to and from the card run at full rate
        (the array keeps its buffer; the buffer returns to torch's cache of
        such memory once the array is gone)."""
        docs, tokens = key if isinstance(key, tuple) else (key, slice(None))
        d0, d1, _ = docs.indices(self.n)
        t0, t1, _ = tokens.indices(self.ld)
        out = torch.empty((max(0, d1 - d0), max(0, t1 - t0), self.dim), dtype=torch.float16,
                          pin_memory=self.device.type == "cuda")
        for b in range(d0 // self.bs, -(-d1 // self.bs) if d1 > d0 else 0):
            b0, b1 = self.docs_of(b)
            lo, hi = max(b0, d0), min(b1, d1)
            out[lo - d0:hi - d0] = torch.stack([self.block(t, b)[lo - b0:hi - b0] for t in range(t0, t1)], dim=1)
        return out.numpy()

    def __array__(self, dtype=None, copy=None):
        out = self[:, :]
        return out if dtype is None else out.astype(dtype)
