"""K2 (the MAP backward), timed on a CUDA card in the port
(``jolideco_torch``) of the checkout it runs from.

The wrapper ``gmm_fused_bwd_cuda`` keeps its signature from commit to
commit, so two commits are compared on one card in one run: unpack each into a directory of its own (``git
archive``), then run this script from each checkout's root in turns
(parent, change, change, parent). Each checkout builds its own kernels.

    cd <checkout> && python3 <this repo>/scripts/torch_k2_pass1_times.py \\
        --tag parent --cases <dir>/k2_cases.pt

K2's inputs, at 1024² with stride 4 under ``astro-snr-v1``, are made by
the first run (its K1 split, its ``MAPDeconvolver``) and saved to
``--cases``, so that every run sees the same ones:

- ``flat``: the main path's first step, a flux of ones;
- ``step1``: the flux after one step of ``chip_smoke.py``'s main path;
- ``trained``: after its 20 steps;
- ``uniform``: ``chip_smoke.py`` phase 2's random 1024² image;
- ``many``: the patches of ``uniform`` with argmax = patch index mod K:
  128 components in every tile of 128 patches.

Each case gives the distinct components per tile of 128 patches, K2's ms
a call (CUDA events) and of device time (``torch.profiler``: every kernel
and fill of the call), and its error against the float32 plain version. The timing and case
helpers are this repository's ``chip_smoke.py``. Prints one JSON line,
with the card's name and power limit. (K3's passes, pass 1 among them,
are timed in turns by ``scripts/torch_k3_times.py``.)
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
    """K2's inputs of every case (see the module's docstring)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=cs.N_OBS, size=cs.FIELD, psf_size=33,
                             seed=0)
    rs = np.random.RandomState(0)
    rs.uniform(0.1, 2.0, cs.RAGGED)  # chip_smoke.py phase 2's draws
    images = {
        "flat": np.ones((cs.FIELD, cs.FIELD), np.float32),
        "step1": cs.run_slice(datasets, gmm, device, cycle_spin=True,
                              n_steps=1).flux_upsampled_total,
        "trained": cs.run_slice(datasets, gmm, device, cycle_spin=True,
                                ).flux_upsampled_total,
        "uniform": rs.uniform(0.1, 2.0, (cs.FIELD, cs.FIELD)),
    }
    bufs = gmm.kernel_buffers(device)
    gen = torch.Generator(device=device).manual_seed(3)
    cases = {}
    for name, flux in images.items():
        image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                                device=device)
        _, argmax, valid, xtn = gf.gmm_fused_fwd_tc_cuda(
            image, bufs, 4, ZERO_FLUX_SENTINEL)
        dv = torch.randn(valid.shape, generator=gen, device=device) * valid
        cases[name] = (xtn, argmax, valid, dv)
    xtn, _, valid, _ = cases["uniform"]
    every = (torch.arange(xtn.shape[0], device=device)
             % bufs["rec"].shape[0]).to(torch.int32)
    cases["many"] = (xtn, every, valid, torch.randn(
        every.shape, generator=gen, device=device) * valid)
    return {name: tuple(t.cpu() for t in case)
            for name, case in cases.items()}


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
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    cuda_build.load_libraries(*cuda_build.LIBRARIES)
    # registers and spills, where this process built the library
    registers = {name: cs.ptxas_summary(
        cuda_build.BUILD_INFO.get(name, {}).get("ptxas", ""))
        for name in ("gmm_fused",)}
    gmm = GaussianMixtureModel.from_registry("astro-snr-v1")
    if not args.cases.exists():
        torch.save(make_cases(torch, cs, device, gmm), args.cases)
    cases = torch.load(args.cases)
    bufs = gmm.kernel_buffers(device)
    k2 = {}
    for name, case in cases.items():
        xtn, argmax, valid, dv = (t.to(device) for t in case)
        # every checkout's K2 has a kernel of this name
        k2[name] = cs.k2_case(torch, xtn, argmax, valid, dv, bufs,
                              (cs.FIELD, cs.FIELD), names=cs.K2_KERNELS[:1])
        print(f"{args.tag} K2 {name}: {cs.k2_case_line(k2[name])}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": card, "k2": k2,
                      "registers": registers}))


if __name__ == "__main__":
    main()
