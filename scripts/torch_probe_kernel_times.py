"""The MAP flux-error probe's kernels (K5, K6, K7), timed on a CUDA card
in the port (``jolideco_torch``) of the checkout it runs from.

The wrappers ``gmm_score_rows_cuda``, ``gmm_unit_map_cuda`` and
``gmm_hvp_map_cuda`` keep their signatures from commit to commit, so two
commits are compared on one card in one run: unpack each into a
directory of its own (``git archive``), then run this script from each
checkout's root in turns (parent, change, change, parent). Each checkout
builds its own kernels.

    cd <checkout> && python3 <this repo>/scripts/torch_probe_kernel_times.py \\
        --tag parent --cases <dir>/probe_cases.pt

The probe's rows (grouped 8x8 patches, stride 4, masked and
mean-subtracted) under ``astro-snr-v1`` and their argmax are made by the
first run and saved to ``--cases``, so that every run sees the same:

- ``uniform``: ``chip_smoke.py`` phase 2's random 1024² image (65,025
  rows), the float32 plain scorer's argmax;
- ``trained``: the flux after the 20 steps of ``chip_smoke.py``'s main
  path, its argmax;
- ``many``: the rows of ``uniform`` with argmax = row index mod K: 128
  components in every block of 128 rows;
- ``ragged``: phase 2's 1000 x 904 image (56,025 rows).

For each case: the distinct components per block of 128 rows, and K6's
and K7's ms a call (CUDA events, 50 calls after one) and of device time
(``chip_smoke.device_ms``: the host side of a call outlasts the kernel)
and their error against the plain versions over those versions'
max-abs; at ``uniform``, K5's ms in float32 and, where the checkout has
it, on the tensor cores (``"split"``). The timing helpers are this repository's
``chip_smoke.py``. Prints one JSON line, with the card's name and power
limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def smoke():
    """This repository's ``chip_smoke.py`` (not the checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_cases(torch, cs, device, gmm):
    """The rows and argmax of every case (see the module's docstring)."""
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=cs.N_OBS, size=cs.FIELD, psf_size=33,
                             seed=0)
    rs = np.random.RandomState(0)
    ragged = rs.uniform(0.1, 2.0, cs.RAGGED).astype(np.float32)
    ragged[96:160, 200:260] = 2.0 * ZERO_FLUX_SENTINEL
    images = {
        "uniform": rs.uniform(0.1, 2.0, (cs.FIELD, cs.FIELD)),
        "trained": cs.run_slice(datasets, gmm, device, cycle_spin=True,
                                ).flux_upsampled_total,
        "ragged": ragged,
    }
    bufs = gmm.kernel_buffers(device)
    cases = {}
    for name, flux in images.items():
        image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                                device=device)
        x = cs.normalised_rows(torch, image, ZERO_FLUX_SENTINEL)
        cases[name] = (x, gp.score_rows_plain(x, bufs)[1])
    x, _ = cases["uniform"]
    cases["many"] = (x, (torch.arange(x.shape[0], device=device)
                         % bufs["rec"].shape[0]).to(torch.int32))
    return {name: tuple(t.cpu() for t in case)
            for name, case in cases.items()}


def row_map_times(torch, cs, x, argmax, bufs):
    """K6's and K7's ms a call and errors; the components per block."""
    from jolideco_torch.ops import gmm_pallas as gp

    n = x.shape[0]
    t = torch.randn(x.shape, device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(2))
    tile = torch.arange(n, device=x.device) // 128
    width = int(argmax.max()) + 1
    per_tile = torch.bincount(
        torch.unique(tile * width + argmax.long()) // width).float()
    out = {"rows": n, "per_block_mean": float(per_tile.mean()),
           "per_block_max": int(per_tile.max())}
    for name, kern, plain, arg in (
            ("unit", gp.gmm_unit_map_cuda, gp.unit_map_plain, x),
            ("hvp", gp.gmm_hvp_map_cuda, gp.hvp_map_plain, t)):
        want = plain(arg, argmax, bufs)
        err = float((kern(arg, argmax, bufs) - want).abs().max()
                    / want.abs().max())
        out[name] = {
            "ms": cs.cuda_ms(torch, lambda: kern(arg, argmax, bufs), 50),
            "device_ms": cs.device_ms(torch, lambda: kern(arg, argmax, bufs),
                                      50, "::gmm_row_map_kernel<"),
            "err": err}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    parser.add_argument("--cases", required=True, type=Path)
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = smoke()
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    cuda_build.load_libraries(*cuda_build.LIBRARIES)
    registers = {name: cs.ptxas_summary(
        cuda_build.BUILD_INFO.get(name, {}).get("ptxas", ""))
        for name in ("gmm_patch", "gmm_score_wg")}
    gmm = GaussianMixtureModel.from_registry("astro-snr-v1")
    if not args.cases.exists():
        torch.save(make_cases(torch, cs, device, gmm), args.cases)
    cases = torch.load(args.cases)
    bufs = gmm.kernel_buffers(device)
    row_map = {}
    for name, case in cases.items():
        x, argmax = (t.to(device) for t in case)
        row_map[name] = row_map_times(torch, cs, x, argmax, bufs)
        print(f"{args.tag} K6/K7 {name}: {row_map[name]}")
    x, _ = (t.to(device) for t in cases["uniform"])
    k5 = {"f32": cs.cuda_ms(torch, lambda: gp.gmm_score_rows_cuda(x, bufs),
                            10)}
    if hasattr(gp, "gmm_score_rows_tc_cuda"):
        k5["split"] = cs.cuda_ms(
            torch, lambda: gp.gmm_score_rows_tc_cuda(x, bufs), 10)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": card, "row_map": row_map,
                      "k5": k5, "registers": registers}))


if __name__ == "__main__":
    main()
