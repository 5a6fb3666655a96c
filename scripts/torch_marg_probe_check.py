"""The marginalised probe's row kernels on a CUDA card, a quick check.

Builds ``gmm_score_wg`` and ``gmm_patch`` (printing ptxas' registers and
spills of every instance) and holds K5's logsumexp, K8 and K9a of every
mode (``"f32"``, ``"split"``, ``"bf16"``: the wrappers of
``jolideco_torch.ops.gmm_pallas``, K8 and K9a fed the kernel's own
logsumexp) against their plain versions fed the plain logsumexp: the
largest relative differences of the logsumexp, the unit rows, p and dp,
the argmax flips, the rows whose weight is one-hot (dp exactly 0 there,
p summing to 1), and under ``"f32"`` the distance of both to float64.
Cases: 300 random rows under ``astro-snr-v1``, then the probe's 65,025
rows of a random 1024^2 image (``chip_smoke.normalised_rows``) and
their first 16,384 under ``astro-snr-v1`` (timed: ms a call of each
kernel, CUDA events, ``chip_smoke.cuda_ms``), under
``chip_smoke.mixed_gmm()`` (timed) and ``chip_smoke.wide_gmm()`` (K =
256). Run from the root of a checkout:

    python3 scripts/torch_marg_probe_check.py

One line a case and mode; a new kernel's first call on the card should
be this one, under ``timeout``.
"""
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from jolideco_torch.ops import gmm_fused as gf  # noqa: E402
from jolideco_torch.ops import gmm_pallas as gp  # noqa: E402
from jolideco_torch.priors import GaussianMixtureModel  # noqa: E402
from jolideco_torch.utils.cuda_build import BUILD_INFO, load_libraries  # noqa: E402

t0 = time.perf_counter()
load_libraries("gmm_score_wg", "gmm_patch")
print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
for line in cs.ptxas_summary(BUILD_INFO["gmm_score_wg"]["ptxas"]):
    print("ptxas", line)
print([l for l in BUILD_INFO["gmm_score_wg"]["ptxas"].splitlines()
       if "warning" in l or "C75" in l][:10])
dev = torch.device("cuda")
KERNELS = {"f32": (lambda x, b: gp.gmm_score_rows_cuda(x, b, True),
                   gp.gmm_unit_marg_cuda, gp.gmm_hvp_marg_weights_cuda),
           "split": (gp.gmm_score_rows_marg_tc_cuda, gp.gmm_unit_marg_tc_cuda,
                     gp.gmm_hvp_marg_weights_tc_cuda),
           "bf16": (gp.gmm_score_rows_marg_bf16_cuda,
                    gp.gmm_unit_marg_bf16_cuda,
                    gp.gmm_hvp_marg_weights_bf16_cuda)}
PLAIN = {"f32": (lambda x, b: gp.score_rows_plain(x, b, True),
                 gp.unit_marg_plain, gp.hvp_marg_weights_plain),
         "split": (gf.score_split_marg_plain, gf.marg_unit_split_plain,
                   gp.hvp_marg_weights_split_plain),
         "bf16": (gf.score_bf16_marg_plain, gf.marg_unit_bf16_plain,
                  gp.hvp_marg_weights_bf16_plain)}


def rel(a, b):
    return float(((a.double() - b.double()).abs()).max()
                 / max(float(b.double().abs().max()), 1e-30))


def case(label, x, t, bufs, timed=False):
    b64 = {k: v.double() for k, v in bufs.items()}
    for mode in ("f32", "split", "bf16"):
        score, unit, weights = KERNELS[mode]
        pscore, punit, pweights = PLAIN[mode]
        lse, am = score(x, bufs)
        u = unit(x, lse, bufs)
        p, dp = weights(x, t, lse, bufs)
        torch.cuda.synchronize()
        lse_p, am_p = pscore(x, bufs)
        u_p = punit(x, lse_p, bufs)
        p_p, dp_p = pweights(x, t, lse_p, bufs)
        lrel = float(((lse - lse_p).abs() / lse_p.abs().clamp_min(1e-30)).max())
        flips = int((am != am_p).sum())
        one_hot = (p != 0).sum(dim=0) == 1
        dp_bad = int((dp[:, one_hot] != 0).sum())
        p_one = float((p[:, one_hot].sum(dim=0) - 1).abs().max()) if one_hot.any() else 0.0
        line = (f"{label} {mode}: lse rel {lrel:.3g} flips {flips}; unit "
                f"{rel(u, u_p):.3g}; p {rel(p, p_p):.3g}; dp {rel(dp, dp_p):.3g}"
                f"; finite {bool(torch.isfinite(u).all() and torch.isfinite(p).all() and torch.isfinite(dp).all())}"
                f"; one-hot rows {int(one_hot.sum())} dp!=0 {dp_bad} p-1 {p_one:.3g}")
        if mode == "f32":
            lse64, _ = gp.score_rows_plain(x.double(), b64, True)
            u64 = gp.unit_marg_plain(x.double(), lse64, b64)
            p64, dp64 = gp.hvp_marg_weights_plain(x.double(), t.double(), lse64, b64)
            line += (f"; vs f64 (kernel, plain): unit {rel(u, u64):.3g}, {rel(u_p, u64):.3g}"
                     f"; dp {rel(dp, dp64):.3g}, {rel(dp_p, dp64):.3g}")
        if timed:
            ms = [cs.cuda_ms(torch, lambda f=f: f(), 10) for f in (
                lambda: score(x, bufs), lambda: unit(x, lse, bufs),
                lambda: weights(x, t, lse, bufs))]
            line += "; ms K5 lse %.4f K8 %.4f K9a %.4f" % tuple(ms)
        print(line, flush=True)


gen = torch.Generator(device=dev).manual_seed(0)
astro = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(dev)
# small first: a ragged tile of rows
x = torch.randn((300, 64), generator=gen, device=dev) * 0.3
x = (x - x.mean(dim=1, keepdim=True)).contiguous()
x[0] = 0
t = torch.randn((300, 64), generator=gen, device=dev)
case("small astro", x, t, astro)
img = np.random.RandomState(0).uniform(0.1, 2.0, (1024, 1024)).astype(np.float32)
from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL  # noqa: E402
xr = cs.normalised_rows(torch, torch.as_tensor(img, device=dev), ZERO_FLUX_SENTINEL)
tr = torch.randn(xr.shape, generator=gen, device=dev)
case("65025 astro", xr, tr, astro, timed=True)
case("16384 astro", xr[:16384].contiguous(), tr[:16384].contiguous(), astro, timed=True)
case("65025 mixed", xr, tr, cs.mixed_gmm().kernel_buffers(dev), timed=True)
case("65025 wide", xr, tr, cs.wide_gmm().kernel_buffers(dev))
