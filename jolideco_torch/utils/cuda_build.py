"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads at once. A missing ``nvcc`` or a failed build raises: there is no
fallback to the plain PyTorch versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "BUILD_INFO", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> {"path", "seconds", "ptxas"} of libraries this process built
# or loaded (seconds is 0.0 when an existing build was reused)
BUILD_INFO = {}
_LOADED = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built on this machine"
    )


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"

    seconds, ptxas = 0.0, ""
    if not target.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        ptxas = proc.stderr
        os.replace(tmp, target)

    lib = ctypes.CDLL(str(target))
    BUILD_INFO[name] = {"path": str(target), "seconds": seconds,
                        "ptxas": ptxas}
    _LOADED[name] = lib
    return lib
