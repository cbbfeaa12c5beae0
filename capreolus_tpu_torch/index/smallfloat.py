"""Lucene SmallFloat int4/byte4 length quantization.

Lucene stores each document's length as a single byte norm (SmallFloat.intToByte4)
and BM25 scores against the decoded (lossy) length. Reproducing this quantization is
required for score parity with an Anserini/Lucene backend.

Encoding: values < 24 are exact; larger values are stored as a 3-bit mantissa with
implicit leading 1 plus an exponent, giving exact values up to 39 and progressively
coarser buckets beyond. A copy of the JAX package's ``index/smallfloat.py``.
"""

from __future__ import annotations

import numpy as np


def _long_to_int4(i: int) -> int:
    if i < 0:
        raise ValueError("only non-negative values supported")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07
    return encoded | ((shift + 1) << 3)


def _int4_to_long(i: int) -> int:
    bits = i & 0x07
    shift = (i >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift

# MAX_INT4 = _long_to_int4(2**31 - 1) = 231, so 255 - 231 = 24 byte values are "free"
NUM_FREE_VALUES = 255 - _long_to_int4(2**31 - 1)


def int_to_byte4(i: int) -> int:
    """Encode a non-negative int into Lucene's byte4 format (returned as 0..255)."""
    if i < NUM_FREE_VALUES:
        return i
    return NUM_FREE_VALUES + _long_to_int4(i - NUM_FREE_VALUES)


def byte4_to_int(b: int) -> int:
    """Decode a byte4 value (0..255) back to its (bucket-representative) int."""
    if b < NUM_FREE_VALUES:
        return b
    return NUM_FREE_VALUES + _int4_to_long(b - NUM_FREE_VALUES)


# Decode table for all 256 byte values (Lucene precomputes the same LENGTH_TABLE).
LENGTH_TABLE = np.array([byte4_to_int(b) for b in range(256)], dtype=np.int64)


def quantize_lengths(lengths: np.ndarray) -> np.ndarray:
    """Vectorized intToByte4 -> byte4ToInt roundtrip: doc lengths as BM25 sees them."""
    lengths = np.asarray(lengths, dtype=np.int64)
    out = np.empty_like(lengths)
    flat = lengths.reshape(-1)
    res = out.reshape(-1)
    for idx in range(flat.shape[0]):
        res[idx] = byte4_to_int(int_to_byte4(int(flat[idx])))
    return out
