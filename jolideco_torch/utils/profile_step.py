"""Where the time of a step and of a flux-error probe goes, on a card.

Builds the port's main path (joint MAP deconvolution of 10 observations
of 1024² counts with 33² PSFs under the ``astro-snr-v1`` GMM patch
prior, stride 4, cycle spin; with ``--marginalize`` the prior scores
each patch by the logsumexp over its components; ``--conv-mode pfft``
convolves through the matrix-DFT kernels instead of cuFFT, ``ct``
through the pair-packed Cooley-Tukey matrix DFT, ``mxu`` through the
per-observation 4-step matrix DFT and ``direct`` through a grouped
``conv2d``; ``--precision``
sets the precision dial, whose default ``"high"`` runs the fused
scorer (its MAP and logsumexp forwards and its marginalise backward),
the probe's patch-level scorer and marginalise kernels (K5, K8, K9a) and
K3's three passes on the tensor cores with three bf16 products a step,
and whose ``"default"`` runs the same kernels with one), runs a few
warm-up steps, then
traces
``--steps`` steps with ``torch.profiler``; then, at the fluxes those
steps reached, the same for ``--steps`` Hessian probes
(``TotalLoss.fluxes_error``, what ``compute_error=True`` runs once after
training). For each it reports:

- the wall time per call (host clock around synchronised calls, no
  profiler);
- device time by kernel name, summed over the traced calls;
- the device's busy share of the traced window (union of kernel
  intervals over the window's wall time) and so its idle share.

Run on a machine with a CUDA card:

    python -m jolideco_torch.utils.profile_step [--steps 10] [--marginalize] [--conv-mode {fft,pfft,ct,mxu,direct}] [--precision {highest,high,default}] [--update-strategy {joint,sequential}] [--upsampling N] [--calibrations] [--prior {gmm,multiscale,jitter,group,fraction,smooth}] [--bands N [--fallback]] [--sparse] [--out DIR]

``--bands N`` swaps the main path's data for four event classes of
``N``-band stacks at 1024² with the energy redistribution
(:func:`multiband_setup`: King PSFs of 129² to 49², one shared 2-D flux
from the data's estimate); ``--fallback`` drops the first class's RMF, so
that the joint strategy falls back to per-dataset models. ``--sparse``
adds 256 point sources to the main path's data and fits them with a
``SparseSpatialFluxComponent`` beside the diffuse one
(:func:`sparse_setup`). These are ``chip_smoke.py`` phase 11's paths;
their tags join the files' names (``bandsN``, ``fallback``, ``sparse``).

``--prior`` swaps the main path's prior (``gmm``) for another of
:func:`make_prior`: ``multiscale`` (``MultiScalePrior`` over three
levels of the GMM prior under an asinh image norm: the fused scorer at
1024², 512² and 256²), ``jitter`` and ``group``/``fraction`` (the GMM
prior on its patch-level branch: jittered patches; one offset class of
patches, ``patch_fraction=0.25``; a random subset of half the patches,
``patch_fraction=0.5``, whose indices are copied to the card each step)
or ``smooth`` (``SmoothnessPrior(width=2)``, no GMM kernel); the
``--marginalize`` flag applies to the GMM priors. Its tag joins the
files' names.

``--update-strategy sequential`` profiles the default deconvolver's
epoch instead of the joint step: one step per observation, then the
epoch's trace row (reported as ``epoch_sequential``, per epoch).
``--upsampling N`` puts the flux on a grid ``N`` times finer than the
data's (a 2048² flux at ``N = 2``) and ``--calibrations`` gives every
observation an ``NPredCalibration`` (the first one's shift frozen); with
either, the flux starts from the data's mean estimate
(``SpatialFluxComponent.from_flux_init_datasets``), as ``chip_smoke.py``
phase 9 runs it. The full tables and Chrome traces go to ``--out``,
their names tagged ``marg`` under ``--marginalize``, the mode under
``--conv-mode`` other than ``fft``, ``upN`` and ``cal`` under the last
two flags, and with the dial's name when it is not ``"high"``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..parallel.stacked import CONV_MODES

PRIORS = ("gmm", "multiscale", "jitter", "group", "fraction", "smooth")


def make_prior(kind, gmm, marginalize=False):
    """The prior ``kind`` of :data:`PRIORS` over ``gmm`` (stride 4, cycle
    spins), as the module's ``--prior`` flag and ``chip_smoke.py`` phase
    10 build it."""
    from .. import (
        ASinhImageNorm,
        GMMPatchPrior,
        MultiScalePrior,
        SmoothnessPrior,
    )

    if kind == "smooth":
        return SmoothnessPrior(width=2)
    options = {"multiscale": {"norm": ASinhImageNorm()},
               "jitter": {"jitter": True},
               "group": {"patch_fraction": 0.25},
               "fraction": {"patch_fraction": 0.5}}.get(kind, {})
    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True,
                          marginalize=marginalize, **options)
    if kind == "multiscale":
        prior = MultiScalePrior(prior, n_levels=3)
    return prior


def multiband_setup(size=1024, n_bands=3, n_classes=4, psf_scale=1.0,
                    fallback=False, device="cuda"):
    """``chip_smoke.py`` phase 11 (a) and (b): ``n_classes`` event
    classes of ``n_bands``-band stacks with the energy redistribution
    (``bench_data.make_multiband_datasets``, simulated on ``device``),
    the first class's RMF dropped with ``fallback``; and the one shared
    2-D flux of the data's estimate (``bench_data.band_flux_estimate``).
    """
    from .bench_data import band_flux_estimate, make_multiband_datasets

    datasets, _ = make_multiband_datasets(
        n_classes=n_classes, size=size, n_bands=n_bands, psf_scale=psf_scale,
        device=device)
    if fallback:
        datasets[next(iter(datasets))].pop("rmf")
    return datasets, band_flux_estimate(datasets)


def sparse_setup(n_obs=10, size=1024, psf_size=33, n_sources=256, seed=0,
                 device="cuda"):
    """``chip_smoke.py`` phase 11 (c): the main path's data with
    ``n_sources`` point sources injected (``bench_data.inject_point_sources``,
    simulated on ``device``), a PSF per component, the true sources, and
    ``components(prior)``: ``"diffuse"`` under ``prior`` from the mean
    estimate of the data before the sources were added (a model of the
    field without them), beside ``"points"``, the sources started up to
    half a pixel off in each axis at half their flux, under
    ``UniformPrior``."""
    from .. import (
        FluxComponents,
        SparseSpatialFluxComponent,
        SpatialFluxComponent,
        UniformPrior,
    )
    from .bench_data import inject_point_sources, make_datasets

    field = make_datasets(n_obs=n_obs, size=size, psf_size=psf_size,
                          seed=seed)
    diffuse = SpatialFluxComponent.from_flux_init_datasets(
        list(field.values()))
    datasets, sources = inject_point_sources(field, n_sources=n_sources,
                                             seed=seed + 1, device=device)
    for dataset in datasets.values():
        dataset["psf"] = {"diffuse": dataset["psf"],
                          "points": dataset["psf"]}
    rng = np.random.RandomState(seed + 2)
    start = {"flux": 0.5 * sources["flux"],
             "x_pos": sources["x_pos"] + rng.uniform(-0.5, 0.5, n_sources),
             "y_pos": sources["y_pos"] + rng.uniform(-0.5, 0.5, n_sources)}

    def components(prior):
        start_diffuse = diffuse.copy()
        start_diffuse.prior = prior
        return FluxComponents({
            "diffuse": start_diffuse,
            "points": SparseSpatialFluxComponent(
                shape=(size, size), prior=UniformPrior(), **start)})

    return datasets, sources, components


def build(n_obs, size, marginalize=False, conv_mode="fft",
          update_strategy="joint", upsampling=1, calibrations=False,
          prior="gmm", bands=0, fallback=False, sparse=False):
    """``step()`` of the main path on the first card, and ``probe()``,
    the flux-error probe at the current parameters; ``prior`` a kind of
    :data:`PRIORS`. Under
    ``update_strategy="sequential"`` (with the JAX package's default
    ``trace_every=1``) ``step()`` is one epoch: a step per observation,
    then the epoch's trace row. ``upsampling``, ``calibrations``,
    ``bands``, ``fallback`` and ``sparse`` as the module's flags."""
    from .. import (
        GaussianMixtureModel,
        MAPDeconvolver,
        NPredCalibration,
        NPredCalibrations,
        SpatialFluxComponent,
    )
    from .bench_data import make_datasets

    prior = make_prior(prior, GaussianMixtureModel.from_registry(
        "astro-snr-v1"), marginalize=marginalize)
    if bands:
        datasets, estimate = multiband_setup(size, bands, fallback=fallback)
        component = SpatialFluxComponent.from_numpy(estimate, prior=prior)
    elif sparse:
        datasets, _, components = sparse_setup(n_obs, size)
        component = components(prior)
    else:
        datasets = make_datasets(n_obs=n_obs, size=size, psf_size=33,
                                 seed=0)
        if upsampling > 1 or calibrations:
            component = SpatialFluxComponent.from_flux_init_datasets(
                list(datasets.values()), upsampling_factor=upsampling,
                prior=prior)
        else:
            component = SpatialFluxComponent.from_numpy(
                np.ones((size, size), np.float32), prior=prior)
    cals = None
    if calibrations:
        cals = NPredCalibrations({
            name: NPredCalibration(frozen_shift=idx == 0)
            for idx, name in enumerate(datasets)})
    deco = MAPDeconvolver(
        learning_rate=0.1, update_strategy=update_strategy,
        conv_mode=conv_mode, trace_every=int(update_strategy != "joint"),
        device="cuda")
    trainer = deco.make_trainer(datasets, component, calibrations=cals)

    def step():
        return trainer.epoch(0)

    def probe():
        return trainer.total_loss.fluxes_error(
            trainer.components.fluxes_from(trainer.params),
            calibration_params=trainer.calibration_params)

    return step, probe


def busy_share(events, window_us):
    """Union of device-kernel intervals over the window, as a share."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -1.0
    for start, stop in spans:
        if start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / window_us


def profile_calls(torch, fn, reps, out, tag):
    """Wall and device time of ``reps`` calls of ``fn``; prints a summary."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t1) * 1e6

    trace = out / f"profile_{tag}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], [0.0, 0])
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    device_us = sum(v[0] for v in by_name.values())
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    (out / f"profile_{tag}_table.txt").write_text(table)

    share = busy_share(events, traced_us) if events else 0.0
    traced_ms = traced_us / 1e3 / reps
    busy_ms = device_us / 1e3 / reps
    print(f"{tag}: wall {wall_ms:.3f} ms/call untraced; traced "
          f"{traced_ms:.3f} ms/call; device busy {busy_ms:.3f} ms/call "
          f"({100 * share:.1f}% of the traced window, "
          f"idle {100 * (1 - share):.1f}%)")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"{us / 1e3 / reps:9.4f} ms/call {count // reps:4d}x/call "
              f"{100 * us / device_us:5.1f}%  {name[:110]}")


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--n-obs", type=int, default=10)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--marginalize", action="store_true")
    parser.add_argument("--conv-mode", choices=CONV_MODES, default="fft")
    parser.add_argument("--precision", choices=("highest", "high", "default"),
                        default="high")
    parser.add_argument("--update-strategy", choices=("joint", "sequential"),
                        default="joint")
    parser.add_argument("--upsampling", type=int, default=1)
    parser.add_argument("--calibrations", action="store_true")
    parser.add_argument("--prior", choices=PRIORS, default="gmm")
    parser.add_argument("--bands", type=int, default=0)
    parser.add_argument("--fallback", action="store_true")
    parser.add_argument("--sparse", action="store_true")
    parser.add_argument("--out", default="chiprun_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    from .. import config

    config.set_gmm_precision(args.precision)

    step, probe = build(args.n_obs, args.size, args.marginalize,
                        args.conv_mode, args.update_strategy,
                        args.upsampling, args.calibrations, args.prior,
                        args.bands, args.fallback, args.sparse)
    suffix = (f"_bands{args.bands}" if args.bands else "") + (
        "_fallback" if args.fallback else "") + (
        "_sparse" if args.sparse else "") + (
        "_marg" if args.marginalize else "") + (
        "" if args.conv_mode == "fft" else f"_{args.conv_mode}") + (
        f"_up{args.upsampling}" if args.upsampling > 1 else "") + (
        "_cal" if args.calibrations else "") + (
        "" if args.prior == "gmm" else f"_{args.prior}") + (
        "" if args.precision == "high" else f"_{args.precision}")
    sequential = args.update_strategy == "sequential"
    profile_calls(torch, step, args.steps, out,
                  ("epoch_sequential" if sequential else "step") + suffix)
    profile_calls(torch, probe, args.steps, out, "probe" + suffix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
