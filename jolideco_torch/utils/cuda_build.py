"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads at once; ``ptxas``' report of a build (registers, spills) is kept
beside it and read back when it is reused. A missing ``nvcc`` or a
failed build raises: there is no fallback to the plain PyTorch
versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "BUILD_INFO", "LIBRARIES", "load_libraries",
           "load_library"]

# the package's kernel libraries: the fused GMM scorer's MAP backward
# (K2), the GMM scorers on the warpgroup instructions (K1 MAP and
# logsumexp and K4 of every mode, K5 MAP of the bf16 modes, and K5's
# logsumexp, K8 and K9a of every mode), the patch-level float32 kernels
# (K5 MAP, K6, K7, K9b) and the matrix-DFT convolution's (K3) three
# passes on the warpgroup instructions in every mode
LIBRARIES = ("gmm_fused", "gmm_score_wg", "gmm_patch", "pfft_conv_wg")
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> {"path", "seconds", "ptxas"} of libraries this process built
# or loaded (seconds is 0.0 when an existing build was reused; ptxas is
# then the output its build kept beside it)
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


def _target(name):
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return source, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _ptxas_log(target):
    """Where a build keeps ``nvcc``'s ``-Xptxas -v`` output."""
    return target.with_name(target.name + ".ptxas")


def load_libraries(*names):
    """Build (if needed) and load ``csrc/<name>.cu`` for each name.

    The builds that are needed run at the same time, one ``nvcc`` per
    source. Returns the CDLLs in the order of ``names``.
    """
    builds = {}
    for name in dict.fromkeys(names):
        if name in _LOADED:
            continue
        source, target = _target(name)
        if target.exists():
            builds[name] = (target, None, None, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        builds[name] = (target, tmp, proc, time.perf_counter())

    for name, (target, tmp, proc, t0) in builds.items():
        seconds, ptxas = 0.0, ""
        if proc is None:
            log = _ptxas_log(target)
            ptxas = log.read_text() if log.exists() else ""
        else:
            stdout, stderr = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {CSRC_DIR / name}.cu (exit "
                    f"{proc.returncode}):\n{stdout}\n{stderr}"
                )
            ptxas = stderr
            _ptxas_log(target).write_text(ptxas)
            os.replace(tmp, target)
        BUILD_INFO[name] = {"path": str(target), "seconds": seconds,
                            "ptxas": ptxas}
        _LOADED[name] = ctypes.CDLL(str(target))
    return [_LOADED[name] for name in names]


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    return load_libraries(name)[0]
