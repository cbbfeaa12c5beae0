"""Minimal TensorBoard event-file writer, without TensorFlow (the JAX
package's ``utils/tensorboard.py``, which is framework-free: this is a copy).

The trainer writes scalars for the loss and the dev metrics and, for models
of up to 4M parameters, per-parameter weight histograms at each validation.
The event-file format is implemented directly:

- file framing: TFRecord records — [len u64le][masked crc32c(len)][payload]
  [masked crc32c(payload)]
- payload: an Event protobuf, hand-encoded (wall_time=1 double, step=2 int64,
  file_version=3 string, summary=5). Summary.Value carries tag=1,
  simple_value=2 float, histo=5 HistogramProto.

Files are readable by standard TensorBoard. Volume is small (scalars per
iteration + histograms per validation), so the pure-python crc32c is fine.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ------------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(value))


def _int64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _string(field: int, value: str) -> bytes:
    return _bytes(field, value.encode("utf-8"))


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _bytes(field, payload)


def _histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto from raw values using TB's default exponential buckets."""
    values = np.asarray(values, dtype=np.float64).ravel()
    if values.size == 0:
        values = np.zeros(1)
    # TensorBoard's bucketing: +/- 1e-12 * 1.1^k edges
    limits = [-1e38]
    neg, pos = [], []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        neg.append(-v)
        v *= 1.1
    limits = neg[::-1] + pos + [1e38]
    counts, _ = np.histogram(values, bins=[-np.inf] + limits)
    # drop empty leading/trailing buckets but keep proto small
    nz = np.nonzero(counts)[0]
    if len(nz):
        lo, hi = int(nz[0]), int(nz[-1]) + 1
    else:
        lo, hi = 0, 1
    bucket_limit = limits[lo:hi]
    bucket = counts[lo:hi]
    msg = b"".join([
        _double(1, float(values.min())),
        _double(2, float(values.max())),
        _double(3, float(values.size)),
        _double(4, float(values.sum())),
        _double(5, float((values ** 2).sum())),
        _packed_doubles(6, bucket_limit),
        _packed_doubles(7, bucket),
    ])
    return msg


def _event(wall_time: float, step: int = None, file_version: str = None,
           summary: bytes = None) -> bytes:
    msg = _double(1, wall_time)
    if step is not None:
        msg += _int64(2, step)
    if file_version is not None:
        msg += _string(3, file_version)
    if summary is not None:
        msg += _bytes(5, summary)
    return msg


class EventWriter:
    """Append-only writer of a single events.out.tfevents file."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        fn = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fn)
        self._f = open(self.path, "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        value_msg = _string(1, tag) + _float(2, value)
        self._write(_event(time.time(), step=step, summary=_bytes(1, value_msg)))

    def add_histogram(self, tag: str, values, step: int):
        value_msg = _string(1, tag) + _bytes(5, _histogram_proto(np.asarray(values)))
        self._write(_event(time.time(), step=step, summary=_bytes(1, value_msg)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
