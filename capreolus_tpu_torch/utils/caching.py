"""Atomic create-once file writes (a copy of the JAX package's
``utils/caching.py``).

``cached_file`` writes to a tmp file and atomically renames it into place; a
second writer racing on the same target raises ``TargetFileExists`` so callers
can fall back to reading the existing artifact. ``done_file`` is the
done-marker protocol of index builds and searches.
"""

from __future__ import annotations

import contextlib
import os
import random
from pathlib import Path


class TargetFileExists(Exception):
    """Raised when the cached file already exists (another writer won the race)."""


@contextlib.contextmanager
def cached_file(path, mode: str = "wt"):
    """Context manager yielding a tmp-file handle that is renamed to ``path`` on success.

    Raises TargetFileExists immediately if ``path`` already exists. On exception the
    tmp file is removed and nothing is left at ``path``.
    """
    path = Path(path)
    if path.exists():
        raise TargetFileExists(str(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{path.name}.tmp_{os.getpid()}_{random.randrange(1 << 30)}"
    try:
        with open(tmp, mode) as f:
            yield f
        if path.exists():
            tmp.unlink(missing_ok=True)
            raise TargetFileExists(str(path))
        os.replace(tmp, path)
    except Exception:
        tmp.unlink(missing_ok=True)
        raise


@contextlib.contextmanager
def done_file(directory):
    """Idempotent work-unit protocol: skip if ``<dir>/done`` exists, else run and mark.

    Usage::

        with done_file(outdir) as already_done:
            if not already_done:
                ... produce artifacts in outdir ...
    """
    directory = Path(directory)
    marker = directory / "done"
    if marker.exists():
        yield True
        return
    directory.mkdir(parents=True, exist_ok=True)
    yield False
    marker.write_text("done")
