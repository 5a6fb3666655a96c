"""K1 (MAP and logsumexp) and K4, and the marginalised probe's K5 lse,
K8 and K9a, of every mode of the precision dial timed at the main path's
size, to compare checkouts in turns.

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
(``bound_fp32_ms``). With ``--probe`` it also times the probe's row
kernels on the image's rows (the probe's grouped patches, masked and
mean-subtracted: 65,025 rows) and on their first 16,384 (one offset
class, ``chip_smoke.py`` phase 10(c)), under both GMMs: K5's logsumexp,
then K8 and K9a fed its logsumexp and a random tangent, by the
wrappers' names (``gmm_score_rows_cuda(..., True)``,
``gmm_unit_marg_cuda``, ``gmm_hvp_marg_weights_cuda`` and their
``_tc`` and ``_bf16`` twins), with their bounds likewise (the logits'
products, the ``A_k x`` terms of the nonzero weights in float32; the
rows, tangents, logsumexp and outputs, K9a's ``(K, N)`` p and dp, and
the buffers the warpgroup core reads). Prints one JSON line (ms and
bounds by mode, GMM and kernel, the card's name and power limit,
``--label``). Two
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
    parser.add_argument("--probe", action="store_true",
                        help="also the probe's K5 lse, K8 and K9a")
    parser.add_argument("--no-fused", action="store_true",
                        help="leave out K1 and K4")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as cs
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
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
    x_all = cs.normalised_rows(torch, image, sentinel)
    t_all = torch.randn(x_all.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(4))
    for mode in args.modes.split(","):
        out[mode] = {}
        if args.probe:
            for name, gmm in gmms:
                bufs = gmm.kernel_buffers(device)
                for n in (x_all.shape[0], 16384):
                    out[mode][f"probe {name} {n}"] = probe_times(
                        torch, cs, gp, mode, x_all[:n].contiguous(),
                        t_all[:n].contiguous(), bufs, args.reps)
        if args.no_fused:
            continue
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
            "bwd": "K4, fed K1 lse (chip_smoke.MARG_KERNELS[mode][1])",
            "lse": "K5 lse, on rows", "unit": "K8, fed K5 lse",
            "weights": "K9a, fed K5 lse"},
        "modes": out, "card": card}}))


# the probe's row kernels by mode, by the wrappers' names (the same in
# every checkout since the dial's modes came in)
PROBE_WRAPPERS = {
    "f32": ("gmm_score_rows_cuda", "gmm_unit_marg_cuda",
            "gmm_hvp_marg_weights_cuda"),
    "split": ("gmm_score_rows_marg_tc_cuda", "gmm_unit_marg_tc_cuda",
              "gmm_hvp_marg_weights_tc_cuda"),
    "bf16": ("gmm_score_rows_marg_bf16_cuda", "gmm_unit_marg_bf16_cuda",
             "gmm_hvp_marg_weights_bf16_cuda"),
}


def probe_times(torch, cs, gp, mode, x, t, bufs, reps):
    """K5 lse, K8 and K9a of ``mode`` on rows ``x`` (tangents ``t``):
    ms a call and bounds (see the module's docstring)."""
    score, unit, weights = (getattr(gp, name)
                            for name in PROBE_WRAPPERS[mode])
    if mode == "f32":
        def lse_call():
            return score(x, bufs, True)
    else:
        def lse_call():
            return score(x, bufs)
    lse, _ = lse_call()
    ms = {"lse": cs.cuda_ms(torch, lse_call, reps),
          "unit": cs.cuda_ms(torch, lambda: unit(x, lse, bufs), reps),
          "weights": cs.cuda_ms(torch, lambda: weights(x, t, lse, bufs),
                                reps)}
    nnz, used = cs.support(torch, x, lse, bufs, mode)
    k, n = bufs["b_rows"].shape[0], x.shape[0]
    if mode == "f32":
        wg_bytes = bufs["pair_wg3"].numel() + bufs["lin_wg"].numel()
    else:
        wg_bytes = (bufs["pair_wg"].numel() // (2 if mode == "bf16" else 1)
                    + bufs["lin_wg"].numel())
    logits = PRODUCTS[mode] * 2.0 * (2080 + 64) * k * n
    terms = 2.0 * (4096 + 64) * nnz
    a_bytes = 4 * used * (64 * 64 + 64)
    nbytes = {"lse": 4 * (n * 64 + 2 * n),
              "unit": 4 * (2 * n * 64 + n) + a_bytes,
              "weights": 4 * (2 * n * 64 + n + 2 * k * n) + a_bytes}
    row = {"nonzero_weights": nnz, "rows": n}
    for key, t_ms in ms.items():
        t_ops = (logits / cs.PEAK_BF16_FLOPS
                 + (terms / cs.PEAK_FP32_FLOPS if key != "lse" else 0.0))
        t_bytes = (nbytes[key] + wg_bytes) / cs.PEAK_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        row[key] = {"ms": t_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes", "share": bound_ms / t_ms}
    return row


if __name__ == "__main__":
    main()
