"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. Libraries go
to ``build/capreolus_tpu_torch/`` beside the package, named by a hash of the
source, so an edited source is rebuilt and an unchanged one is reused. Nothing
is built when a module is imported: the first launch builds what it needs, and
``build_all`` builds every kernel at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "capreolus_tpu_torch"
KERNEL_SOURCES = {"knrm_pool": "knrm_pool.cu", "flash_attention": "flash_attention.cu", "maxsim": "maxsim.cu",
                  "int8_matmul": "int8_matmul.cu", "quantize_per_token": "quantize_per_token.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or nvcc on PATH."""
    candidates = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] if os.environ.get("CUDA_HOME") else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels are built at first use")
    return found


def on_card(t, what: str) -> bool:
    """How a dispatcher routes ``t``: True for a CUDA tensor (the kernel),
    False for a CPU tensor (the plain version); ValueError on any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def library_path(name: str) -> Path:
    source = CSRC_DIR / KERNEL_SOURCES[name]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build_all(names=None) -> dict:
    """Compile every missing kernel library, one nvcc per source started together.

    Returns {name: ptxas report (str)} for the kernels built by this call; raises
    RuntimeError with the compiler's output when a build fails."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / KERNEL_SOURCES[name])]
        logger.info("building %s: %s", name, " ".join(cmd))
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{output}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
            reports[name] = output
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            t0 = time.perf_counter()
            build_all([name])
            logger.info("built %s in %.1f s", name, time.perf_counter() - t0)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
