"""Where the time of one step of the PyTorch/CUDA port goes, on a card.

Builds the port's main path (joint MAP deconvolution of 10 observations
of 1024² counts with 33² PSFs under the ``astro-snr-v1`` GMM patch
prior, stride 4, cycle spin), runs a few warm-up steps, then traces
``--steps`` steps with ``torch.profiler`` and reports:

- the wall time per step (host clock around synchronised steps, no
  profiler);
- device time by kernel name, summed over the traced steps;
- the device's busy share of the traced window (union of kernel
  intervals over the window's wall time) and so its idle share.

Run on a machine with a CUDA card:

    python -m jolideco_torch.utils.profile_step [--steps 10] [--out chiprun_out]

The full table and a Chrome trace go to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build(n_obs, size):
    """``step()`` of the main path on the first card."""
    from .. import (
        GaussianMixtureModel,
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
    )
    from .bench_data import make_datasets

    datasets = make_datasets(n_obs=n_obs, size=size, psf_size=33, seed=0)
    prior = GMMPatchPrior(gmm=GaussianMixtureModel.from_registry(
        "astro-snr-v1"), stride=4, cycle_spin=True)
    component = SpatialFluxComponent.from_numpy(
        np.ones((size, size), np.float32), prior=prior)
    deco = MAPDeconvolver(learning_rate=0.1, update_strategy="joint",
                          conv_mode="fft", trace_every=0, device="cuda")
    step, _, _ = deco.make_step(datasets, component)
    return step


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


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--n-obs", type=int, default=10)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--out", default="chiprun_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    step = build(args.n_obs, args.size)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t1) * 1e6

    trace = out / "profile_step_trace.json"
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
    (out / "profile_step_table.txt").write_text(table)

    share = busy_share(events, traced_us) if events else 0.0
    traced_ms = traced_us / 1e3 / args.steps
    busy_ms = device_us / 1e3 / args.steps
    print(f"wall {wall_ms:.3f} ms/step untraced; traced {traced_ms:.3f} "
          f"ms/step; device busy {busy_ms:.3f} ms/step "
          f"({100 * share:.1f}% of the traced window, "
          f"idle {100 * (1 - share):.1f}%)")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{us / 1e3 / args.steps:9.4f} ms/step {count // args.steps:4d}x/step "
              f"{100 * us / device_us:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
