"""K3's passes timed at the main path's batch, to compare checkouts in turns.

Imports ``jolideco_torch`` and ``chip_smoke`` from ``--root`` (a checkout
of the repository, this one by default), builds its kernels, and times
each pass of each mode of the precision dial (``pallas_fft.PASSES``:
``"f32"``, ``"split"``, ``"bf16"``) at 5 pairs of ``--size``² (1024 by
default, n = 1152; 2048 is the x2 path's batch, n = 2176;
``chip_smoke.pfft_inputs``), ``--reps`` calls after one (CUDA events),
beside the one ``torch.fft.fft`` and ``torch.fft.ifft`` that compute
the functions of passes 1 and 3; ``--passes`` times only the passes
named. Prints one JSON line (ms by mode and pass, the card's name and
power limit, ``--label``). Two checkouts
compare on one card when their runs alternate (parent, change, change,
parent), each in its own process:

    for r in parent . . parent; do
        python3 scripts/torch_k3_times.py --root $r --label $r
    done
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                               .parents[1]))
    parser.add_argument("--label", default="this")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--passes", nargs="*",
                        choices=("cols_fwd", "rows", "cols_inv"),
                        default=("cols_fwd", "rows", "cols_inv"))
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as cs
    from jolideco_torch.ops import pallas_fft as pf

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    assert Path(pf.__file__).resolve().is_relative_to(root)
    device = torch.device("cuda", 0)
    size = (args.size, args.size)
    x0, x1, planes, _, n = cs.pfft_inputs(torch, device, size, 4)
    h = x0.shape[1]
    ms = {}
    for mode, (cols_fwd, rows, cols_inv) in pf.PASSES.items():
        u = cols_fwd(x0, x1, n)
        v = rows(u, *planes)
        calls = {"cols_fwd": lambda: cols_fwd(x0, x1, n),
                 "rows": lambda: rows(u, *planes),
                 "cols_inv": lambda: cols_inv(*v, h)}
        ms[mode] = {name: cs.cuda_ms(torch, calls[name], args.reps)
                    for name in args.passes}
    vpm = torch.stack((v[0] + v[1].conj(), v[0] - v[1].conj()))
    ms["torch_fft_cols"] = cs.cuda_ms(
        torch, lambda: torch.fft.fft(torch.complex(x0, x1), n=n, dim=1),
        args.reps)
    ms["torch_ifft_cols"] = cs.cuda_ms(
        torch, lambda: torch.fft.ifft(vpm, dim=-2), args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    line = json.dumps({"k3_times": {
        "label": args.label, "root": str(root),
        "batch": f"5 pairs of {args.size}^2, n = {n}", "ms": ms,
        "card": card}})
    print(line)


if __name__ == "__main__":
    main()
