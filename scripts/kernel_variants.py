"""Source variants of the port's CUDA kernels, built for timing on a card.

The variant scripts (``torch_k3_variants.py``, ``torch_wg_variants.py``,
``torch_k9b_variants.py``) build copies of one ``csrc/<name>.cu`` with a
few lines or constants changed. This module holds what they share: the
source with its local headers inlined and text patches applied, and the
build of every variant at once (one ``nvcc`` each, the package's flags)
into a folder under ``build/``. Nothing of the package changes.
"""

import ctypes
import re
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jolideco_torch" / "csrc"
_INCLUDE = re.compile(r'^#include "([\w.]+)"$', re.MULTILINE)


def patched_source(name, patches=()):
    """``csrc/<name>.cu`` with its local headers inlined (each at its
    first include) and each ``(old, new)`` of ``patches`` replaced at
    every occurrence; an ``old`` that does not occur raises."""
    seen = set()

    def inline(match):
        header = match.group(1)
        if header in seen:
            return ""
        seen.add(header)
        return _INCLUDE.sub(inline, (CSRC / header).read_text())

    text = _INCLUDE.sub(inline, (CSRC / f"{name}.cu").read_text())
    for old, new in patches:
        if old not in text:
            raise ValueError(f"variant text not found: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(sources, out):
    """Compile each ``{variant: source text}`` into ``out/<variant>.so``,
    all at once; returns ``{variant: (ctypes.CDLL, ptxas output)}``.
    A failed build raises."""
    from jolideco_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    built = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        built[name] = (ctypes.CDLL(str(out / f"{name}.so")), err)
    return built
