"""Tile variants of the marginalised Hessian action's second stage (K9b,
``csrc/gmm_patch.cu::gmm_hvp_marg_mix_kernel``), timed on a CUDA card.

The kernel takes a tile of ``kMixTile`` rows a block of ``kMixThreads``
threads, ``kMixBlocks`` blocks an SM (``__launch_bounds__``), the
components in chunks of ``kMixChunk``, ``kMixLoads`` slab entries of a
thread in flight, and unrolls ``kMixUnroll`` four-column steps of a
product. This script builds copies of the source with other
values (``build/kernels/variants/``, ``kernel_variants.py``; nothing of
the package changes), one ``nvcc`` each, all at once, loads each with the wrapper's ``ctypes``
signature and, on the cases of ``scripts/torch_k9b_times.py`` (made
there, or here if ``--cases`` does not exist yet), checks that each
variant gives the bits of the package's kernel and times them in turns
(each twice, in forward then in reverse order): ms a call by CUDA events
and by device time (``chip_smoke.device_ms``). Run from the root of a
checkout on a machine with a card and ``nvcc``:

    python3 scripts/torch_k9b_variants.py --cases build/k9b/cases.pt

Prints a line per case and one JSON line, with the card's name and power
limit and each variant's registers.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch_k9b_times as times  # noqa: E402  (this script's directory)
import kernel_variants as kv  # noqa: E402

# name -> (kMixTile, kMixBlocks, kMixThreads, kMixChunk, kMixLoads,
# kMixUnroll)
VARIANTS = {
    "t128": (128, 1, 256, 64, 16, 2),
    "t64b2": (64, 2, 256, 64, 16, 2),
    "t64b2u4": (64, 2, 256, 64, 16, 4),
    "t64b2u16": (64, 2, 256, 64, 16, 16),
    "t64b2w128": (64, 2, 128, 64, 32, 2),
    "t128w512u4": (128, 1, 512, 64, 16, 4),
}
CONSTANTS = ("kMixTile", "kMixBlocks", "kMixThreads", "kMixChunk",
             "kMixLoads", "kMixUnroll")


def variant_source(text, values):
    """``gmm_patch.cu`` with other K9b constants."""
    for name, value in zip(CONSTANTS, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} not found once in gmm_patch.cu")
    return text


def build(names, summary):
    from jolideco_torch.utils import cuda_build as cb

    text = kv.patched_source("gmm_patch")
    built = kv.build({f"k9b_{name}": variant_source(text, VARIANTS[name])
                      for name in names}, cb.BUILD_DIR / "variants")
    libs, ptxas = {}, {}
    for name in names:
        lib, err = built[f"k9b_{name}"]
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gmm_hvp_marg_mix.argtypes = [vp] * 6 + [ci, ci, vp, vp]
        lib.gmm_hvp_marg_mix.restype = ci
        libs[name] = lib
        ptxas[name] = [line for line in summary(err) if "mix" in line]
    return libs, ptxas


def launcher(torch, lib, case, bufs):
    """A call of the variant's C entry on a case; returns its output."""
    x, t, p, dp = (case[key] for key in ("x", "t", "p", "dp"))
    n, k = x.shape[0], p.shape[0]

    def call():
        out = torch.empty_like(x)
        code = lib.gmm_hvp_marg_mix(
            x.data_ptr(), t.data_ptr(), p.data_ptr(), dp.data_ptr(),
            bufs["a_full"].data_ptr(), bufs["b_rows"].data_ptr(), n, k,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")
        return out
    return call


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", required=True, type=Path)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = times.smoke()
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.load_libraries(*cuda_build.LIBRARIES)
    libs, ptxas = build(args.variants, cs.ptxas_summary)
    if not args.cases.exists():
        torch.save(times.make_cases(torch, cs, device), args.cases)
    cases = torch.load(args.cases)
    gmms = {"astro-snr-v1": GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers(device),
            "mixed": cs.mixed_gmm().kernel_buffers(device)}
    results = {}
    for label, case in cases.items():
        case = {key: v.to(device) if isinstance(v, torch.Tensor) else v
                for key, v in case.items()}
        bufs = gmms[case["gmm"]]
        want = gp.gmm_hvp_marg_mix_cuda(case["x"], case["t"], case["p"],
                                        case["dp"], bufs)
        calls = {name: launcher(torch, libs[name], case, bufs)
                 for name in args.variants}
        res = {name: {"same_bits": bool(torch.equal(call(), want)),
                      "ms": [], "device_ms": []}
               for name, call in calls.items()}
        order = list(args.variants)
        for names in (order, order[::-1]):
            for name in names:
                res[name]["ms"].append(cs.cuda_ms(torch, calls[name],
                                                  args.reps))
                res[name]["device_ms"].append(cs.device_ms(
                    torch, calls[name], args.reps, "gmm_hvp_marg_mix_kernel"))
        results[label] = res
        print(f"K9b variants {label}: " + "; ".join(
            f"{name} {min(r['device_ms']):.4f} ms device, "
            f"{min(r['ms']):.4f} events, same bits {r['same_bits']}"
            for name, r in res.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"card": card, "variants": {
        name: VARIANTS[name] for name in args.variants}, "k9b": results,
        "ptxas": ptxas}))


if __name__ == "__main__":
    main()
