"""K1 lse and K4 of the ``"f32"`` mode timed at the main path's size, to
compare checkouts in turns.

Imports ``jolideco_torch`` and ``chip_smoke`` from ``--root`` (a checkout
of the repository, this one by default), builds its kernels, and times
``gmm_fused_fwd_marg_cuda`` (K1's logsumexp forward) and
``gmm_fused_bwd_marg_cuda`` (K4, fed K1 lse's own outputs and random
cotangents) under ``"highest"`` at 1024², K = 200, stride 4: under
``astro-snr-v1`` on ``chip_smoke.py`` phase 2's image (one nonzero
softmax weight a patch) and under ``chip_smoke.mixed_gmm()`` (about 200),
``--reps`` calls after one (CUDA events). Beside each time its bound
(the larger of the operations and the bytes, ``chip_smoke.marg_timing``'s
work: every logit over the pair form, and the ``A_k x`` terms of the
nonzero weights): on the tensor cores as six bf16 products
(``bound_ms``) and on the float32 CUDA cores (``bound_fp32_ms``). Prints
one JSON line (ms and bounds by GMM and kernel, the card's name and
power limit, ``--label``). Two checkouts compare on one card when their
runs alternate (parent, change, change, parent), each in its own
process:

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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                               .parents[1]))
    parser.add_argument("--label", default="this")
    parser.add_argument("--reps", type=int, default=20)
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
    out = {}
    for name, gmm in (("astro-snr-v1",
                       GaussianMixtureModel.from_registry("astro-snr-v1")),
                      ("mixed", cs.mixed_gmm())):
        bufs = gmm.kernel_buffers(device)
        lse, _, valid, xtn = gf.gmm_fused_fwd_marg_cuda(image, bufs, stride,
                                                        sentinel)
        gen = torch.Generator(device=device).manual_seed(3)
        dv = torch.randn(lse.shape, generator=gen, device=device) * valid
        fwd = cs.cuda_ms(torch, lambda: gf.gmm_fused_fwd_marg_cuda(
            image, bufs, stride, sentinel), args.reps)
        bwd = cs.cuda_ms(torch, lambda: gf.gmm_fused_bwd_marg_cuda(
            xtn, lse, valid, dv, bufs, img.shape, stride), args.reps)
        m = valid > 0.5
        nnz, used = cs.support(torch, xtn[m], lse[m], bufs)
        k = bufs["rec"].shape[0]
        n, n_valid = lse.numel(), int(m.sum())
        logit_flop = 2.0 * (2080 + 64) * k
        rec_bytes = 4 * bufs["rec"].numel()
        work = {"fwd": (logit_flop * n,
                        4 * (img.size + n * (3 + 64)) + rec_bytes),
                "bwd": (logit_flop * n_valid + 2.0 * (4096 + 64) * nnz,
                        4 * (n_valid * 64 + 3 * n + img.size) + rec_bytes
                        + 4 * used * 64 * 64)}
        out[name] = {"nonzero_weights": nnz, "n_valid": n_valid}
        for key, ms in (("fwd", fwd), ("bwd", bwd)):
            six = cs.split_bound(*work[key], products=6)
            fp32 = cs.bound(*work[key])
            out[name][key] = {"ms": ms, "bound_ms": six["bound_ms"],
                              "bound_fp32_ms": fp32["bound_ms"],
                              "share": six["bound_ms"] / ms,
                              "share_fp32": fp32["bound_ms"] / ms}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"marg_f32_times": {
        "label": args.label, "root": str(root),
        "shape": "1024^2, stride 4, K = 200", "kernels": {
            "fwd": "gmm_fused_fwd_marg_cuda (K1 lse)",
            "bwd": "gmm_fused_bwd_marg_cuda (K4)"},
        "gmms": out, "card": card}}))


if __name__ == "__main__":
    main()
