"""Variants of the MAP scorer on the warpgroup instructions
(``jolideco_torch/csrc/gmm_score_wg.cu``), timed on a CUDA card.

Each variant is the source with a few lines replaced (``VARIANTS``),
built by ``nvcc`` like the package's libraries (all at once, into
``build/wg_variants/``, ``kernel_variants.py``) and loaded with
``ctypes``; each runs K5's entry
point (``gmm_score_wg_rows``) on the rows of ``chip_smoke.py`` phase 2's
random 1024² image (65,025 rows) under ``astro-snr-v1`` (K = 200), in
both modes, ``--reps`` calls after one (CUDA events):

- ``base``: the source as it is;
- ``no_turns``: the two multiplying warpgroups issue their products
  whenever they are ready, not in turns;
- ``no_products``: no wgmma at all (every other instruction, copy and
  wait as in ``base``; the results are wrong): what the rest costs;
- ``two_stages``: a ring of two stages in both modes.

Prints one JSON line: ms by variant and mode, whether the argmax agrees
with the plain version of the mode on at least 99.9% of the rows (only
``base`` and ``no_turns`` should), ``ptxas``' spill lines, and the
card's name and power limit. Run from the root of a checkout:

    python3 scripts/torch_wg_variants.py
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import kernel_variants as kv  # this script's directory

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "wg_variants"

TURN_WAIT = ("  __device__ __forceinline__ void wait() const "
             "{ wg::bar_sync(1 + wgi, 256); }")
TURN_PASS = "    wg::bar_arrive(2 - wgi, 256);\n  }"
PRODUCTS_1 = ("    wg::wgmma_n200_zero(t, hi, b_hi);\n  } else {\n"
              "    wg::wgmma_n200_acc(t, hi, b_hi);")
PRODUCTS_3 = ("    if constexpr (fresh)\n      wg::wgmma_n200_zero(t, lo, b_hi);\n"
              "    else\n      wg::wgmma_n200_acc(t, lo, b_hi);\n"
              "    wg::wgmma_n200_acc(t, hi, b_lo);\n"
              "    wg::wgmma_n200_acc(t, hi, b_hi);")
LINEAR = ("  wg::wgmma_n200_zero(t, x[2], part(0));\n"
              "  wg::wgmma_n200_acc(t, x[1], part(1));\n"
              "  wg::wgmma_n200_acc(t, x[0], part(2));\n"
              "  wg::wgmma_n200_acc(t, x[1], part(0));\n"
              "  wg::wgmma_n200_acc(t, x[0], part(1));\n"
              "  wg::wgmma_n200_acc(t, x[0], part(0));")
VARIANTS = {
    "base": [],
    "no_turns": [(TURN_WAIT, "  __device__ __forceinline__ void wait() "
                             "const {}"),
                 (TURN_PASS, "  }")],
    "no_products": [(PRODUCTS_1, ""), (PRODUCTS_3, ""),
                    (LINEAR, "  (void)part;")],
    "two_stages": [("kProd == 3 ? 3 : 6;", "2;")],
}


def build(names):
    """The variants ``names`` built and loaded, and their spill lines."""
    built = kv.build({name: kv.patched_source("gmm_score_wg", VARIANTS[name])
                      for name in names}, OUT)
    libs, spills = {}, {}
    for name, (lib, err) in built.items():
        spills[name] = [line.strip() for line in err.splitlines()
                        if "spill" in line]
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gmm_score_wg_rows.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp,
                                          vp]
        lib.gmm_score_wg_rows.restype = ci
        libs[name] = lib
    return libs, spills


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    if not torch.cuda.is_available():
        print("torch_wg_variants: no CUDA device", file=sys.stderr)
        return 1
    libs, spills = build(list(VARIANTS))
    device = torch.device("cuda", 0)
    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        device)
    image = np.random.RandomState(0).uniform(0.1, 2.0, (cs.FIELD, cs.FIELD))
    x = cs.normalised_rows(torch, torch.as_tensor(
        image.astype(np.float32), device=device), ZERO_FLUX_SENTINEL)
    n, k = x.shape[0], bufs["rec"].shape[0]
    values = torch.empty(n, device=device)
    argmax = torch.empty(n, dtype=torch.int32, device=device)
    plain = {mode: gf.PLAIN_SCORES[mode, False](x, bufs)[1]
             for mode in ("split", "bf16")}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        out[name] = {}
        for mode in ("split", "bf16"):
            def call():
                code = lib.gmm_score_wg_rows(
                    x.data_ptr(), n, bufs["pair_wg"].data_ptr(),
                    bufs["lin_wg"].data_ptr(), k, gf.TC_PRODUCTS[mode],
                    values.data_ptr(), argmax.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"{name} {mode}: CUDA error {code}")
            call()
            torch.cuda.synchronize()
            agree = float((argmax == plain[mode]).float().mean())
            out[name][mode] = {"ms": cs.cuda_ms(torch, call, args.reps),
                               "argmax_agrees": agree >= 0.999}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"wg_variants": out, "rows": n, "spills": spills,
                      "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
