"""Native (C++) host helpers of the port (the JAX package's ``native/``).

Three plain C libraries, driven through ``ctypes``:

- ``analyzer.cpp``: the English analysis chain (tokenize, possessive, lowercase,
  stopwords, Porter) for ASCII text, equal to ``analysis/analyzer.py``'s
  Python chain; the index build's and every query's analyzer;
- ``trec_reader.cpp``: the TREC document parser of ``utils/trec.py`` for plain
  files with the default content tags;
- ``pruner.cpp``: the block-max span builder of ``searcher/scoring.py``
  (threshold, per-range bounds and tile-coarsened spans in one pass).

Each ``.cpp`` is the JAX package's source. It is compiled by ``g++`` with the
JAX package's flags on first use into ``build/capreolus_tpu_torch/native/``
beside the package, named by a hash of the source and the flags, written to
a temporary file and renamed, so processes building at once never load a
partial library. Without ``g++``, when a build fails, or with
``CAPREOLUS_NATIVE=0`` (read at every call), the callers take the numpy and
Python paths; ``native_status()`` says which libraries loaded and why the
others did not. ctypes releases the GIL during a call, so native work on
several threads overlaps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent.parent / "build" / "capreolus_tpu_torch" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
LIBRARIES = ("analyzer", "trec_reader", "pruner")

_lock = threading.Lock()
_libs: dict = {}  # name -> ctypes.CDLL, or None once a load failed in this process
_status: dict = {}  # name -> {"loaded": bool, "path" and "build_s", or "reason"}


def native_disabled() -> bool:
    """The JAX package's switch: CAPREOLUS_NATIVE=0 (or false/no) keeps every
    caller on its numpy or Python path."""
    return os.environ.get("CAPREOLUS_NATIVE", "1").lower() in ("0", "false", "no")


def library_path(name: str) -> Path:
    """The library of ``native/<name>.cpp``, named by a hash of the source and the flags."""
    source = NATIVE_DIR / f"{name}.cpp"
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def _build(name: str, out: Path) -> float:
    """Compile ``name`` into ``out`` through a temporary file; returns the seconds."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [gxx, *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o", str(tmp)]
    logger.info("building native %s: %s", name, " ".join(cmd))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """The ``argtypes`` and ``restype`` of each library's functions."""
    if name == "analyzer":
        lib.ctpu_analyze.restype = ctypes.c_void_p
        lib.ctpu_analyze.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.ctpu_free.argtypes = [ctypes.c_void_p]
        lib.ctpu_porter_stem.restype = ctypes.c_void_p
        lib.ctpu_porter_stem.argtypes = [ctypes.c_char_p]
    elif name == "trec_reader":
        lib.ctpu_parse_trec.restype = ctypes.c_void_p
        lib.ctpu_parse_trec.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.ctpu_free_trec.argtypes = [ctypes.c_void_p]
    else:
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ctpu_prune_spans.restype = ctypes.c_int64
        lib.ctpu_prune_spans.argtypes = [
            i64p, ctypes.c_int64,                       # q_offsets, num_queries
            i64p, f32p, i64p, i64p,                     # tids, w1, starts, ends
            i64p, i32p, i64p, i64p, f32p, f32p,         # rt_offsets/range/start/end/max_tf/min_dl
            f32p, f32p,                                 # gmax_tf, gmin_dl (table-less terms)
            i32p, i32p, i32p,                           # doc_ids, tfs, norm_doclens
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # k1, b, avgdl
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,  # num_ranges, topk, tile, min_savings
            i32p, i64p, i64p, f32p, i64p,               # out_qix, out_s, out_e, out_w1, out_stats
        ]


def _get_lib(name: str):
    """The loaded library ``name``, built on first use; None when it is switched
    off or cannot be built or loaded (the reason is in ``native_status()``)."""
    if native_disabled():
        return None
    if name in _libs:
        return _libs[name]
    with _lock:
        if name in _libs:
            return _libs[name]
        path = library_path(name)
        try:
            build_s = None if path.exists() else _build(name, path)
            lib = ctypes.CDLL(str(path))
            _declare(name, lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native %s unavailable (%s); using the Python path", name, e)
            _status[name] = {"loaded": False, "reason": str(e)}
            lib = None
        else:
            _status[name] = {"loaded": True, "path": str(path), "build_s": build_s}
        _libs[name] = lib
    return lib


def get_analyzer_lib():
    return _get_lib("analyzer")


def get_trec_reader_lib():
    return _get_lib("trec_reader")


def get_pruner_lib():
    return _get_lib("pruner")


def native_status() -> dict:
    """Loads every library (building what is missing) and returns
    {name: {"loaded": True, "path", "build_s" (None when this process found it
    built)} or {"loaded": False, "reason"}}."""
    if native_disabled():
        return {name: {"loaded": False, "reason": "CAPREOLUS_NATIVE=0"} for name in LIBRARIES}
    for name in LIBRARIES:
        _get_lib(name)
    return {name: dict(_status[name]) for name in LIBRARIES}


def native_analyze(text: str, use_porter: bool, keep_stops: bool):
    """Analyze ASCII text with the native library; returns None if unavailable."""
    lib = get_analyzer_lib()
    if lib is None:
        return None
    ptr = lib.ctpu_analyze(text.encode("ascii"), int(use_porter), int(keep_stops))
    try:
        raw = ctypes.string_at(ptr)
    finally:
        lib.ctpu_free(ptr)
    if not raw:
        return []
    return raw.decode("ascii").rstrip("\n").split("\n")


def native_parse_trec(data: bytes):
    """Parse a TREC file's bytes into [(docid, contents)]; None if unavailable."""
    lib = get_trec_reader_lib()
    if lib is None:
        return None
    ptr = lib.ctpu_parse_trec(data, len(data))
    try:
        raw = ctypes.string_at(ptr)
    finally:
        lib.ctpu_free_trec(ptr)
    if not raw:
        return []
    out = []
    for rec in raw.decode("utf-8", errors="replace").split("\x1e"):  # docid \x1f contents \x1e
        if rec:
            docid, _, contents = rec.partition("\x1f")
            out.append((docid, contents))
    return out


def native_porter_stem(word: str):
    """Porter-stem one ASCII word with the native library; None if unavailable."""
    lib = get_analyzer_lib()
    if lib is None:
        return None
    ptr = lib.ctpu_porter_stem(word.encode("ascii"))
    try:
        return ctypes.string_at(ptr).decode("ascii")
    finally:
        lib.ctpu_free(ptr)
