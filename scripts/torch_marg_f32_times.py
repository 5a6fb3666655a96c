"""K1 (MAP and logsumexp) and K4 of every mode of the precision dial
timed at the main path's size, to compare checkouts in turns.

Imports ``jolideco_torch`` and ``chip_smoke`` from ``--root`` (a checkout
of the repository, this one by default), builds its kernels, and times,
for each mode of ``--modes`` (``"f32"``, the ``"highest"`` dial;
``"split"``, the default; ``"bf16"``, ``"default"``), K1's MAP forward
(``chip_smoke.K1_KERNELS``), its logsumexp forward and K4 (fed K1 lse's
own outputs and random cotangents; ``chip_smoke.MARG_KERNELS``) at
1024², K = 200, stride 4: under ``astro-snr-v1`` on ``chip_smoke.py``
phase 2's image (one nonzero softmax weight a patch) and, for K1 lse and
K4, under ``chip_smoke.mixed_gmm()`` (about 200), ``--reps`` calls after
one (CUDA events). The wrappers keep their names across checkouts, so
the same script times a parent's kernels. Beside each time its bound
(the larger of the operations and the bytes: every logit over the pair
form, and the ``A_k x`` terms of the nonzero weights; the bytes of the
image, the rows and the buffers the warpgroup core reads): on the
tensor cores as the mode's bf16 products (six for ``"f32"``;
``bound_ms``) and, for ``"f32"``, on the float32 CUDA cores
(``bound_fp32_ms``). Prints one JSON line (ms and bounds by mode, GMM
and kernel, the card's name and power limit, ``--label``). Two
checkouts compare on one card when their runs alternate (parent,
change, change, parent), each in its own process:

    for r in parent . . parent; do
        python3 scripts/torch_marg_f32_times.py --root $r --label $r
    done
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

PRODUCTS = {"f32": 6, "split": 3, "bf16": 1}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                               .parents[1]))
    parser.add_argument("--label", default="this")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--modes", default="f32,split,bf16")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as cs
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    assert Path(gf.__file__).resolve().is_relative_to(root)
    device = torch.device("cuda", 0)
    # phase 2's 1024^2 image: the second draw of its generator
    rs = np.random.RandomState(0)
    rs.uniform(0.1, 2.0, cs.RAGGED)
    img = rs.uniform(0.1, 2.0, (cs.FIELD, cs.FIELD)).astype(np.float32)
    image = torch.as_tensor(img, device=device)
    stride, sentinel = 4, ZERO_FLUX_SENTINEL
    gmms = (("astro-snr-v1",
             GaussianMixtureModel.from_registry("astro-snr-v1")),
            ("mixed", cs.mixed_gmm()))
    out = {}
    for mode in args.modes.split(","):
        out[mode] = {}
        fwd_map = getattr(gf, cs.K1_KERNELS[mode] + "_cuda")
        fwd, bwd = (getattr(gf, name + "_cuda")
                    for name in cs.MARG_KERNELS[mode])
        for name, gmm in gmms:
            bufs = gmm.kernel_buffers(device)
            lse, _, valid, xtn = fwd(image, bufs, stride, sentinel)
            gen = torch.Generator(device=device).manual_seed(3)
            dv = torch.randn(lse.shape, generator=gen, device=device) * valid
            ms = {"fwd": cs.cuda_ms(torch, lambda: fwd(
                      image, bufs, stride, sentinel), args.reps),
                  "bwd": cs.cuda_ms(torch, lambda: bwd(
                      xtn, lse, valid, dv, bufs, img.shape, stride),
                      args.reps)}
            if name == "astro-snr-v1":
                ms["map"] = cs.cuda_ms(torch, lambda: fwd_map(
                    image, bufs, stride, sentinel), args.reps)
            m = valid > 0.5
            nnz, used = cs.support(torch, xtn[m], lse[m], bufs, mode)
            k = bufs["rec"].shape[0]
            n, n_valid = lse.numel(), int(m.sum())
            logit_flop = 2.0 * (2080 + 64) * k
            if mode == "f32":
                pair_bytes = bufs["pair_wg3"].numel()
            else:
                pair_bytes = bufs["pair_wg"].numel() // (2 if mode == "bf16"
                                                         else 1)
            wg_bytes = pair_bytes + bufs["lin_wg"].numel()
            fwd_work = (logit_flop * n,
                        4 * (img.size + n * (3 + 64)) + wg_bytes)
            bwd_ax = 2.0 * (4096 + 64) * nnz
            bwd_bytes = (4 * (n_valid * 64 + 3 * n + img.size) + wg_bytes
                         + 4 * used * 64 * 64)
            bounds = {
                "fwd": cs.split_bound(*fwd_work, products=PRODUCTS[mode]),
                "map": cs.split_bound(*fwd_work, products=PRODUCTS[mode]),
                "bwd": cs.bound(
                    PRODUCTS[mode] * logit_flop * n_valid
                    * cs.PEAK_FP32_FLOPS / cs.PEAK_BF16_FLOPS + bwd_ax,
                    bwd_bytes)}
            fp32 = {"fwd": cs.bound(*fwd_work), "map": cs.bound(*fwd_work),
                    "bwd": cs.bound(logit_flop * n_valid + bwd_ax,
                                    bwd_bytes)}
            out[mode][name] = {"nonzero_weights": nnz, "n_valid": n_valid}
            for key, t in ms.items():
                row = {"ms": t, "bound_ms": bounds[key]["bound_ms"],
                       "share": bounds[key]["bound_ms"] / t}
                if mode == "f32":
                    row.update(bound_fp32_ms=fp32[key]["bound_ms"],
                               share_fp32=fp32[key]["bound_ms"] / t)
                out[mode][name][key] = row
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"marg_f32_times": {
        "label": args.label, "root": str(root),
        "shape": "1024^2, stride 4, K = 200", "kernels": {
            "map": "K1 MAP (chip_smoke.K1_KERNELS)",
            "fwd": "K1 lse (chip_smoke.MARG_KERNELS[mode][0])",
            "bwd": "K4, fed K1 lse (chip_smoke.MARG_KERNELS[mode][1])"},
        "modes": out, "card": card}}))


if __name__ == "__main__":
    main()
