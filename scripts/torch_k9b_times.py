"""The second stage of the marginalised Hessian action (K9b,
``gmm_hvp_marg_mix_cuda``), timed on a CUDA card in the port
(``jolideco_torch``) of the checkout it runs from.

The wrapper keeps its signature from commit to commit, so two commits
are compared on one card in one run: unpack each into a directory of its
own (``git archive``), then run this script from each checkout's root in
turns (parent, change, change, parent). Each checkout builds its own
kernels.

    cd <checkout> && python3 <this repo>/scripts/torch_k9b_times.py \\
        --tag parent --cases <dir>/k9b_cases.pt

The inputs are made by the first run and saved to ``--cases``, so that
every run sees the same: the probe's rows (grouped 8x8 patches, stride 4,
masked and mean-subtracted) of an image, seeded random tangents, and the
weights ``p`` and ``dp`` ``(K, N)`` of the float32 plain first stage
(``hvp_marg_weights_plain``) on the card:

- ``uniform``: ``chip_smoke.py`` phase 2's random 1024² image (65,025
  rows) under ``astro-snr-v1`` (K = 200, one-hot weights);
- ``trained``: the flux after the 20 steps of ``chip_smoke.py``'s
  marginalised path, under ``astro-snr-v1``;
- ``ragged``: phase 2's 1000 x 904 image (56,025 rows);
- ``mixed``: the rows of ``uniform`` under ``chip_smoke.mixed_gmm()``
  (K = 200, about 200 nonzero weights a row).

For each case: the nonzero (component, row) entries, the distinct
components per tile of 128 rows, K9b's ms a call by CUDA events (``--reps``
calls after one) and by device time (``chip_smoke.device_ms``), its
error against the float64 plain version over the anchored bar
(``chip_smoke.anchored``: at most 1 passes), whether two calls give the
same bits, and the bound (``chip_smoke.bound``, counted as phase 2 counts
it). Each run saves its outputs beside ``--cases`` and says whether they
equal, bit for bit, those of every run before it with another tag. The
timing helpers are this repository's ``chip_smoke.py``. Prints one JSON
line, with the card's name and power limit.
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


def make_cases(torch, cs, device):
    """Rows, tangents and weights of every case (see the docstring)."""
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=cs.N_OBS, size=cs.FIELD, psf_size=33,
                             seed=0)
    rs = np.random.RandomState(0)
    uniform = rs.uniform(0.1, 2.0, (cs.FIELD, cs.FIELD))
    ragged = rs.uniform(0.1, 2.0, cs.RAGGED).astype(np.float32)
    ragged[96:160, 200:260] = 2.0 * ZERO_FLUX_SENTINEL
    trained = cs.run_slice(datasets, astro, device, cycle_spin=True,
                           marginalize=True).flux_upsampled_total
    cases = {}
    for name, flux, gmm in (("uniform", uniform, astro),
                            ("trained", trained, astro),
                            ("ragged", ragged, astro),
                            ("mixed", uniform, cs.mixed_gmm())):
        bufs = gmm.kernel_buffers(device)
        image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                                device=device)
        x = cs.normalised_rows(torch, image, ZERO_FLUX_SENTINEL)
        t = torch.randn(x.shape, device=device, generator=torch.Generator(
            device=device).manual_seed(3))
        lse, _ = gp.score_rows_plain(x, bufs, True)
        p, dp = gp.hvp_marg_weights_plain(x, t, lse, bufs)
        cases[name] = {"x": x.cpu(), "t": t.cpu(), "p": p.cpu(),
                       "dp": dp.cpu(), "gmm": "mixed" if gmm is not astro
                       else "astro-snr-v1"}
    return cases


def k9b_case(torch, cs, case, bufs, reps):
    """K9b's numbers on one case (see the docstring)."""
    from jolideco_torch.ops import gmm_pallas as gp

    x, t, p, dp = (case[key] for key in ("x", "t", "p", "dp"))
    n, k = x.shape[0], p.shape[0]
    used = (p != 0) | (dp != 0)
    nnz = int(used.sum())
    tile = torch.arange(n, device=x.device) // 128
    per_tile = (torch.zeros(k, int(tile.max()) + 1, device=x.device)
                .index_add_(1, tile, used.float()) > 0).sum(dim=0)
    out = gp.gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs)
    again = gp.gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs)
    b64 = {name: v.double() for name, v in bufs.items()}
    want64 = gp.hvp_marg_mix_plain(x.double(), t.double(), p.double(),
                                   dp.double(), b64)
    err, err32, scale = cs.anchored(
        "k9b", "K9b", out, gp.hvp_marg_mix_plain(x, t, p, dp, bufs), want64)
    a_bytes = 4 * 64 * 64 * int(used.any(dim=1).sum())
    bnd = cs.bound(2.0 * (4096 + 3 * 64) * nnz,
                   4 * (3 * n * 64 + 2 * k * n) + a_bytes)
    call = lambda: gp.gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs)  # noqa: E731
    return out, {
        "rows": n, "nonzero": nnz,
        "components_per_tile_mean": float(per_tile.float().mean()),
        "components_per_tile_max": int(per_tile.max()),
        "ms": cs.cuda_ms(torch, call, reps),
        "device_ms": cs.device_ms(torch, call, reps,
                                  "gmm_hvp_marg_mix_kernel"),
        "err": err, "plain_float32_err": err32, "max_abs": scale,
        "bar_share": err / (cs.MARG_ERR_FACTOR * err32
                            + cs.MARG_ERR_FLOOR * scale),
        "repeat_bitwise": bool(torch.equal(out, again)), **bnd}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    parser.add_argument("--cases", required=True, type=Path)
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = smoke()
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.load_libraries(*cuda_build.LIBRARIES)
    registers = [line for line in cs.ptxas_summary(
        cuda_build.BUILD_INFO["gmm_patch"]["ptxas"]) if "mix" in line]
    if not args.cases.exists():
        torch.save(make_cases(torch, cs, device), args.cases)
    cases = torch.load(args.cases)
    gmms = {"astro-snr-v1": GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers(device),
            "mixed": cs.mixed_gmm().kernel_buffers(device)}
    results, same_bits = {}, {}
    for name, case in cases.items():
        case = {key: v.to(device) if isinstance(v, torch.Tensor) else v
                for key, v in case.items()}
        out, results[name] = k9b_case(torch, cs, case, gmms[case["gmm"]],
                                      args.reps)
        saved = args.cases.with_name(f"k9b_out_{args.tag}_{name}.pt")
        torch.save(out.cpu(), saved)
        for other in sorted(args.cases.parent.glob(f"k9b_out_*_{name}.pt")):
            tag = other.name[len("k9b_out_"):-len(f"_{name}.pt")]
            if tag != args.tag:
                same_bits[f"{name} vs {tag}"] = bool(torch.equal(
                    out.cpu(), torch.load(other)))
        print(f"{args.tag} K9b {name}: {results[name]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": card, "k9b": results,
                      "same_bits": same_bits, "registers": registers}))


if __name__ == "__main__":
    main()
