"""Smoke run of the PyTorch/CUDA port (``jolideco_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line:

0. the device: ``torch.cuda.get_device_name(0)`` and the card's name and
   power limit as ``nvidia-smi`` reports them;
1. build the CUDA kernels from ``jolideco_torch/csrc`` with ``nvcc``;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shape (1024², the ``astro-snr-v1`` GMM, K = 200) and on a
   ragged 1000x904 image with a block of zero-flux sentinel pixels,
   with the time per call of both;
3. the main path: joint MAP deconvolution of 10 observations of 1024²
   Poisson counts (33² Gaussian PSFs) under the GMM patch prior
   (stride 4, cycle spin), 20 Adam steps through ``MAPDeconvolver``.
   The kernels' launch counts are set to zero just before and read just
   after; then a small run (4 x 128², 20 steps) on the card is held
   against the same run on the CPU's plain path.

It then prints a JSON line with each kernel's numbers and, last, the
device line ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero without the last line; it also exits
non-zero when there is no CUDA device or no ``jolideco_torch`` package
beside it. It imports nothing of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMALL_FLUX_RTOL = 1e-4
STEPS = 20


def check(condition, message):
    if not condition:
        raise AssertionError(message)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"phase 0 device: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name


def phase_build():
    from jolideco_torch.utils.cuda_build import BUILD_INFO, load_library

    t0 = time.perf_counter()
    load_library("gmm_fused")
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in BUILD_INFO["gmm_fused"]["ptxas"]
             .splitlines() if "registers" in line or "spill" in line]
    print(f"phase 1 build: gmm_fused in {seconds:.2f} s; "
          + " | ".join(ptxas))


def phase_kernels(torch, device):
    """Each kernel against its plain version; returns per-kernel numbers."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    gmm = GaussianMixtureModel.from_registry("astro-snr-v1")
    bufs = gmm.kernel_buffers(device)
    rs = np.random.RandomState(0)
    ragged = rs.uniform(0.1, 2.0, (1000, 904)).astype(np.float32)
    ragged[96:160, 200:260] = 2.0 * ZERO_FLUX_SENTINEL
    cases = {
        "1024x1024": rs.uniform(0.1, 2.0, (1024, 1024)).astype(np.float32),
        "1000x904": ragged,
    }
    stride, sentinel = 4, ZERO_FLUX_SENTINEL
    out = {}
    for label, img in cases.items():
        image = torch.as_tensor(img, device=device)
        vk, ak, valk, xk = gf.gmm_fused_fwd_cuda(image, bufs, stride, sentinel)
        vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride,
                                                   sentinel)
        torch.cuda.synchronize()
        check(torch.equal(valk, valp), f"{label}: valid differs")
        m = valp > 0.5
        check(bool(m.any()), f"{label}: no valid patch")
        # values: rtol 1e-5 elementwise on valid patches (float32 sums
        # in different orders in the kernel and the matmul)
        value_err = (vk - vp).abs()[m]
        check(bool((value_err <= 1e-5 * vp.abs()[m]).all()),
              f"{label}: values beyond rtol 1e-5 "
              f"(max rel {float((value_err / vp.abs()[m]).max()):.3g})")
        flips = int((ak != ap)[m].sum())
        n_valid = int(m.sum())
        check(flips <= 1e-4 * n_valid,
              f"{label}: argmax flips {flips} of {n_valid}")
        xtn_err = float((xk - xp).abs().max())
        check(xtn_err <= 1e-5, f"{label}: normalised patches differ "
              f"by {xtn_err:.3g}")
        # backward on identical inputs: gradient to 1e-4 of its max-abs
        gen = torch.Generator(device=device).manual_seed(1)
        dv = torch.randn(vp.shape, generator=gen, device=device) * valp
        gk = gf.gmm_fused_bwd_cuda(xp, ap, valp, dv, bufs, img.shape, stride)
        gp = gf.fused_backward_plain(xp, ap, valp, dv, bufs, img.shape,
                                     stride)
        torch.cuda.synchronize()
        grad_err = float((gk - gp).abs().max())
        grad_scale = float(gp.abs().max())
        check(grad_err <= 1e-4 * grad_scale,
              f"{label}: gradient error {grad_err:.3g} vs max {grad_scale:.3g}")
        out[label] = {
            "value_max_abs_err": float(value_err.max()),
            "value_max_rel_err": float((value_err / vp.abs()[m]).max()),
            "argmax_flips": flips, "n_valid": n_valid,
            "grad_max_abs_err": grad_err, "grad_max_abs": grad_scale,
        }
        if label == "1024x1024":
            out["timing"] = {
                "fwd_ms": cuda_ms(torch, lambda: gf.gmm_fused_fwd_cuda(
                    image, bufs, stride, sentinel), 10),
                "fwd_plain_ms": cuda_ms(torch, lambda: gf.fused_forward_plain(
                    image, bufs, stride, sentinel), 3),
                "bwd_ms": cuda_ms(torch, lambda: gf.gmm_fused_bwd_cuda(
                    xp, ap, valp, dv, bufs, img.shape, stride), 10),
                "bwd_plain_ms": cuda_ms(torch, lambda: gf.fused_backward_plain(
                    xp, ap, valp, dv, bufs, img.shape, stride), 3),
            }
        print(f"phase 2 kernels {label}: valid identical; "
              f"values max rel err {out[label]['value_max_rel_err']:.3g}; "
              f"argmax flips {flips}/{n_valid}; "
              f"grad max abs err {grad_err:.3g} (max {grad_scale:.3g})")
    t = out["timing"]
    print(f"phase 2 timing 1024x1024 K=200: fwd kernel {t['fwd_ms']:.3f} ms, "
          f"plain {t['fwd_plain_ms']:.3f} ms; bwd kernel {t['bwd_ms']:.3f} ms, "
          f"plain {t['bwd_plain_ms']:.3f} ms")
    return out


def run_slice(datasets, gmm, device, cycle_spin, n_steps=STEPS):
    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
    )

    size = next(iter(datasets.values()))["counts"].shape
    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=cycle_spin)
    component = SpatialFluxComponent.from_numpy(
        np.ones(size, np.float32), prior=prior
    )
    deco = MAPDeconvolver(
        n_epochs=n_steps, learning_rate=0.1, update_strategy="joint",
        conv_mode="fft", trace_every=0, seed=0, device=device,
    )
    return deco.run(datasets, components=component)


def data_term(datasets, flux, device):
    """Summed Poisson NLL of the datasets at a 2-D ``flux``."""
    import torch

    from jolideco_torch import FluxComponents, SpatialFluxComponent
    from jolideco_torch.parallel.stacked import StackedPoissonLoss

    components = FluxComponents(
        flux=SpatialFluxComponent.from_numpy(flux, device=device)
    )
    poisson = StackedPoissonLoss.from_datasets(datasets, components,
                                               device=device)
    with torch.no_grad():
        return poisson(components.fluxes_from()).item()


def phase_slice(torch, device):
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=10, size=1024, psf_size=33, seed=0)
    run_slice(datasets, astro, device, cycle_spin=True, n_steps=2)  # warm-up

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gf.reset_counters()
    result = run_slice(datasets, astro, device, cycle_spin=True)
    launches = {
        "gmm_fused_fwd": gf.gmm_fused_fwd_cuda.launches,
        "gmm_fused_bwd": gf.gmm_fused_bwd_cuda.launches,
    }
    plain_calls = (gf.fused_forward_plain.calls
                   + gf.fused_backward_plain.calls + gf.score_plain.calls)
    peak = torch.cuda.max_memory_allocated()

    loss = result.loss_per_step
    flux = result.flux_upsampled_total
    check(loss.shape == (STEPS,) and bool(np.isfinite(loss).all()),
          f"non-finite loss: {loss}")
    check(flux.shape == (1024, 1024), f"flux shape {flux.shape}")
    check(bool(np.isfinite(flux).all() and (flux > 0).all()),
          "flux not finite and positive")
    # The total loss is not a progress measure over 20 steps here: the
    # flat start is the mode of the patch prior (every mean-subtracted
    # patch is zero), so the first steps leave it and the total rises
    # in both packages. The data term is: it must fall.
    data_start = float(data_term(datasets, np.ones_like(flux), device))
    data_end = float(data_term(datasets, flux, device))
    check(data_end < data_start,
          f"Poisson data term did not fall: {data_start} -> {data_end}")
    for name, count in launches.items():
        check(count == STEPS, f"{name} launched {count} times, not {STEPS}")
    check(plain_calls == 0, f"plain scorer ran {plain_calls} times")
    steps_per_s = STEPS / result.train_seconds
    print(f"phase 3 slice 10x1024^2 K=200: {STEPS} steps at "
          f"{steps_per_s:.3f} steps/s; loss {loss[0]:.6f} -> {loss[-1]:.6f}; "
          f"data term {data_start:.6f} -> {data_end:.6f}; "
          f"launches {launches}; plain calls {plain_calls}; "
          f"peak memory {peak} B")

    # small input: the card's run against the CPU's plain path
    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    on_card = run_slice(small, builtin, device, cycle_spin=False)
    on_cpu = run_slice(small, builtin, "cpu", cycle_spin=False)
    a, b = on_card.flux_upsampled_total, on_cpu.flux_upsampled_total
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    check(rel <= SMALL_FLUX_RTOL,
          f"4x128^2 flux on the card vs CPU: max rel err {rel:.3g}")
    print(f"phase 3 small 4x128^2 card vs CPU plain path: flux max rel err "
          f"{rel:.3g} (limit {SMALL_FLUX_RTOL})")
    return {"launches": launches, "steps_per_s": steps_per_s,
            "peak_bytes": peak}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "jolideco_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (no "
              "jolideco_torch package beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    device = torch.device("cuda", 0)
    name = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch, device)
    slice_ = phase_slice(torch, device)

    timing = kernels["timing"]
    print(json.dumps({"kernels": [
        {"name": "gmm_fused_fwd", "route": "cuda",
         "source": "jolideco_torch/csrc/gmm_fused.cu",
         "replaces": "jolideco_tpu/ops/gmm_fused.py:309",
         "launches": slice_["launches"]["gmm_fused_fwd"],
         "max_abs_err": kernels["1024x1024"]["value_max_abs_err"],
         "ms": timing["fwd_ms"], "plain_ms": timing["fwd_plain_ms"]},
        {"name": "gmm_fused_bwd", "route": "cuda",
         "source": "jolideco_torch/csrc/gmm_fused.cu",
         "replaces": "jolideco_tpu/ops/gmm_fused.py:405",
         "launches": slice_["launches"]["gmm_fused_bwd"],
         "max_abs_err": kernels["1024x1024"]["grad_max_abs_err"],
         "ms": timing["bwd_ms"], "plain_ms": timing["bwd_plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
