"""Common utilities (the JAX package's ``utils/common.py``): download with hash
verification, gated by ``CAPREOLUS_OFFLINE``, file hashing, padding and an
insertion-ordered default dict."""

from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


class OfflineEnvironmentError(Exception):
    """Raised when a download is required but the environment has no network access."""


def hash_file(path, algo="sha256", chunk_size=1 << 20) -> str:
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def download_file(url: str, destination, expected_hash: str = None, algo="sha256"):
    """Download ``url`` to ``destination``, verifying its hash when given.

    Honors CAPREOLUS_OFFLINE=1 (and plain network failure) by raising
    OfflineEnvironmentError so callers can surface actionable errors; collections
    gate their download_if_missing on this.
    """
    destination = Path(destination)
    if destination.exists():
        if expected_hash is None or hash_file(destination, algo) == expected_hash:
            return destination
        logger.warning("hash mismatch for existing %s; re-downloading", destination)
        destination.unlink()

    if os.environ.get("CAPREOLUS_OFFLINE", "").lower() in ("1", "true", "yes"):
        raise OfflineEnvironmentError(f"offline mode: cannot download {url}")

    destination.parent.mkdir(parents=True, exist_ok=True)
    tmp = destination.with_suffix(destination.suffix + f".tmp{os.getpid()}")
    try:
        import urllib.request

        logger.info("downloading %s -> %s", url, destination)
        with urllib.request.urlopen(url, timeout=60) as resp, open(tmp, "wb") as out:
            shutil.copyfileobj(resp, out)
    except OSError as e:
        tmp.unlink(missing_ok=True)
        raise OfflineEnvironmentError(f"cannot download {url}: {e}") from e

    if expected_hash is not None:
        got = hash_file(tmp, algo)
        if got != expected_hash:
            tmp.unlink(missing_ok=True)
            raise IOError(f"hash mismatch for {url}: expected {expected_hash}, got {got}")
    os.replace(tmp, destination)
    return destination


def padlist(items, padlen, pad_token=0):
    """Pad (right) or truncate a list to exactly ``padlen`` items."""
    items = list(items[:padlen])
    return items + [pad_token] * (padlen - len(items))


class OrderedDefaultDict(dict):
    """A dict with ``defaultdict``'s missing-key factory that keeps insertion order."""

    def __init__(self, default_factory=None):
        super().__init__()
        self.default_factory = default_factory

    def __missing__(self, key):
        if self.default_factory is None:
            raise KeyError(key)
        value = self.default_factory()
        self[key] = value
        return value
