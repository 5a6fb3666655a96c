"""What one checkpoint write costs in the port at the main path, piece by
piece, on a CUDA card.

``MAPDeconvolver(checkpoint_path=)`` writes a result file after each
epoch (``MAPDeconvolver._write_checkpoint``): the parameters copied into
the components, the flux taken to the host (``exp`` on the card, 4 MB
copied), the ASDF tree written (each array block's md5, its bytes, the
YAML tree, the file), and the epoch's trace row fetched scalar by scalar.
This script builds the main path (10 observations of 1024², ``astro-snr-v1``
K = 200, stride 4, cycle spin, the joint strategy with a trace row each
epoch) with ``make_trainer``, runs a few epochs, then times, each the
median of ``--reps`` calls with the card idle before and after
(``torch.cuda.synchronize``; host clock):

- ``write``: the whole ``_write_checkpoint``;
- its pieces: ``set_parameters``, ``flux_to_host``
  (``FluxComponents.to_dict(include_data="numpy")``), ``write_asdf`` of
  the same tree, and inside that ``md5`` and ``to_bytes`` of the flux and
  ``file_write`` of its bytes;
- ``trace_row``: ``append_trace_device_row`` of a computed row;
- ``epoch``: one epoch alone (``Trainer.epoch``), and ``epoch_and_write``:
  an epoch followed by its checkpoint, so that the host waits for the
  epoch's device work at the write.

    python3 scripts/torch_checkpoint_write_times.py [--reps 20]

Writes its files under ``build/`` and removes them. Prints one JSON line
with the card's name and power limit.
"""

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def median_ms(torch, fn, reps):
    """Median and all of ``reps`` host-clock times of ``fn()`` in ms, the
    card idle before and after each."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), times


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--epochs", type=int, default=3,
                        help="epochs run before the timing")
    parser.add_argument("--size", type=int, default=1024,
                        help="the images' side (the main path's 1024)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from jolideco_torch import GMMPatchPrior, MAPDeconvolver, \
        SpatialFluxComponent
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets
    from jolideco_torch.utils.io.asdf_lite import write_asdf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    folder = REPO / "build" / "checkpoint_write_times"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)

    datasets = make_datasets(n_obs=10, size=args.size, psf_size=33, seed=0)
    gmm = GaussianMixtureModel.from_registry("astro-snr-v1")
    component = SpatialFluxComponent.from_numpy(
        np.ones((args.size, args.size), np.float32),
        prior=GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True))
    deco = MAPDeconvolver(n_epochs=args.epochs, update_strategy="joint",
                          trace_every=1, learning_rate=0.1,
                          checkpoint_path=folder / "run")
    trainer = deco.make_trainer(datasets, component)
    loss = trainer.total_loss
    epoch = 0

    def run_epoch():
        nonlocal epoch
        _, row = trainer.epoch(epoch)
        epoch += 1
        return row

    for _ in range(args.epochs):
        loss.append_trace_device_row(run_epoch())
    names = (f"timed-{i}.asdf" for i in range(10**6))

    def write():
        deco._write_checkpoint(trainer, None, next(names))

    tree = {"components": trainer.components.to_dict(include_data="numpy"),
            "trace-loss": loss.trace.to_dict(), "config": deco.to_dict()}
    flux = tree["components"]["flux"]["flux_upsampled"]
    raw = flux.astype("<f4").tobytes()
    out = {"card": card, "device": torch.cuda.get_device_name(0),
           "size": args.size, "reps": args.reps, "flux_bytes": len(raw),
           "ms": {}}
    pieces = {
        "write": write,
        "set_parameters": lambda: trainer.components.set_parameters(
            trainer.params),
        "flux_to_host": lambda: trainer.components.to_dict(
            include_data="numpy"),
        "write_asdf": lambda: write_asdf(tree, folder / next(names)),
        "md5": lambda: hashlib.md5(raw).digest(),
        "to_bytes": lambda: flux.astype("<f4").tobytes(),
        "file_write": lambda: (folder / "raw.bin").write_bytes(raw),
        "epoch": run_epoch,
        "epoch_and_write": lambda: (run_epoch(), write()),
    }
    for name, fn in pieces.items():
        out["ms"][name], out.setdefault("repeats", {})[name] = median_ms(
            torch, fn, args.reps)
    rows = []
    for _ in range(args.reps):
        row = run_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.append_trace_device_row(row)
        rows.append(1e3 * (time.perf_counter() - t0))
    out["ms"]["trace_row"] = float(np.median(rows))
    out["repeats"]["trace_row"] = rows
    out["trace_columns"] = len(loss.trace.colnames)
    shutil.rmtree(folder, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
