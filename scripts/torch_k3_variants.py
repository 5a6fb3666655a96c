"""Text variants of K3's tensor-core passes 2 and 3, timed on a CUDA card.

Each variant is a kernel source with a few lines replaced (``VARIANTS``),
built by ``nvcc`` like the package's libraries (all at once, into
``build/k3_variants/``, ``kernel_variants.py``) and loaded with
``ctypes``. Each runs its pass 2
and pass 3 entry points in both modes ("split": three bf16 products a
step, "bf16": one) at the main path's batch (5 pairs of 1024², n = 1152,
``chip_smoke.py``'s inputs), ``--reps`` calls after one (CUDA events),
the variants in turns (in order, then in reverse order; the two
readings' mean).

``--source mma`` takes ``csrc/pfft_conv_tc.cu``'s ``mma.sync`` kernels
(``pfft_rows_tc_kernel``, ``pfft_cols_inv_tc_kernel``), whose output
sums are read, added to and written once per k2:

- ``base``: the source as it is;
- ``no_rereads``: the epilogues store without reading the earlier sums
  back (the results are wrong): what the re-reads cost;
- ``write_last``: no re-reads, and the epilogues store at the last k2
  only: what the output traffic of the k2 sums costs;
- ``no_products``: no ``mma`` at all (every copy, load and store as in
  ``base``);
- ``no_tables``: no copy of the stage matrices into shared memory;
- ``u_once``: pass 2 reads its rows of U at the first k2 only.

``--source wg`` takes ``csrc/pfft_conv_wg.cu``'s kernels:

- ``base``; ``no_products``: no ``wgmma``; ``no_tables``: the producer
  issues no bulk copy and the consumers do not wait for one;
  ``no_epilogue``: the k2 sums are not stored; ``no_loads``: U, the
  spectra and V are not read (constants in their place).

Prints one JSON line (ms by variant, pass and mode, each variant's
largest difference from the plain version of its mode over its max-abs
(``rows_combine_plain``, ``cols_inv_plain``), which only ``base``
must keep small, ``ptxas``' register and spill lines, the
card's name and power limit) and writes it to
``chiprun_out/k3_variants_<source>.json``. Run from the root of a
checkout:

    python3 scripts/torch_k3_variants.py --source mma
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import kernel_variants as kv  # this script's directory

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_variants"

STORE2 = "dst[mt][half][kLane * a + nt * 4] = val;"
STORE3 = "dst[mt][half][row_a + (size_t)nt * 4 * W] = part;"
MMA = ("mma(acc[mt][nt], al, bhp);", "mma(acc[mt][nt], ah, blp);",
       "mma(acc[mt][nt], ah, bhp);")
ULOAD = "x[i] = urow[(size_t)(e / kLane) * W + kLane * n2 + e % kLane];"
MMA_VARIANTS = {
    "base": [],
    "no_rereads": [("k2 > 0", "false")],
    "write_last": [("k2 > 0", "false"),
                   (STORE2, "if (k2 == m - 1) " + STORE2),
                   (STORE3, "if (k2 == m - 1) " + STORE3)],
    "no_products": [(line, "") for line in MMA],
    "no_tables": [("cp_async16(dst + (c >> 2) * kLdB + (c & 3) * 8, "
                   "src + c * 8);", "(void)dst;")],
    "u_once": [(ULOAD, ULOAD.replace("x[i] = ", "x[i] = k2 > 0 ? "
                                     "make_float2(0.f, 0.f) : "))],
}
WG_VARIANTS = {
    "base": [],
    "no_products": [("wg::wgmma_ss_n8<kSign>(", "(void)("),
                    ("wg::wgmma_ss_n16<kSign>(", "(void)(")],
    "no_tables": [("wg::bulk_load(", "(void)("),
                  ("wg::mbar_arrive_expect_tx(full + stage, L::kStage);",
                   "wg::mbar_arrive(full + stage);")],
    "no_epilogue": [
        ("v1[at] = o1;\n            v2[at] = o2;", "(void)at;"),
        ("*reinterpret_cast<float2*>(y0 + at) = r0;\n"
         "          *reinterpret_cast<float2*>(y1 + at) = r1;", "(void)at;")],
    "no_loads": [
        ("? urow[kLane * (n0 + jj) + 4 * (warp + 8 * it) + q]",
         "? make_float2(1.f, (float)jj)"),
        ("sp[h][e] = make_float4(__ldg(a_re + at), __ldg(a_im + at),\n"
         "                                   __ldg(b_re + at), "
         "__ldg(b_im + at));",
         "sp[h][e] = make_float4(1.f, (float)at, 1.f, 0.f);"),
        ("a[it] = in1[at];", "a[it] = make_float2((float)at, 1.f);"),
        ("b[it] = in2[at];", "b[it] = make_float2(1.f, 0.f);")],
}
SOURCES = {"mma": ("pfft_conv_tc", MMA_VARIANTS),
           "wg": ("pfft_conv_wg", WG_VARIANTS)}


def calls(torch, pf, kind, lib, s, mode):
    """The pass 2 and pass 3 calls of one variant library on the inputs
    ``s``: outputs allocated once, each call one launch."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    p_, n, w = s["u"].shape
    h, m = s["h"], n // 128
    tab = s["tables"]
    prods = 3 if mode == "split" else 1
    stream = torch.cuda.current_stream().cuda_stream
    v1, v2 = torch.empty_like(s["u"]), torch.empty_like(s["u"])
    y0 = torch.empty((p_, h, w), dtype=torch.float32, device=s["u"].device)
    y1 = torch.empty_like(y0)
    planes = [t.data_ptr() for t in s["planes"]]
    if kind == "mma":
        lib.pfft_rows_tc.argtypes = [vp] * 5 + [ci] * 4 + [vp] * 6 + [ci, vp]
        lib.pfft_cols_inv_tc.argtypes = [vp, vp] + [ci] * 4 + [vp] * 4 + [
            ci, vp]

        def rows():
            return lib.pfft_rows_tc(
                s["u"].data_ptr(), *planes, p_, w, m, 0,
                tab["mf_tc"].data_ptr(), tab["mi_tc"].data_ptr(),
                tab["wf"].data_ptr(), tab["wi"].data_ptr(), v1.data_ptr(),
                v2.data_ptr(), prods, stream)

        def cols():
            return lib.pfft_cols_inv_tc(
                s["v"][0].data_ptr(), s["v"][1].data_ptr(), p_, h, w, m,
                tab["mi_tc"].data_ptr(), tab["wi"].data_ptr(),
                y0.data_ptr(), y1.data_ptr(), prods, stream)
    else:
        lib.pfft_rows_wg.argtypes = [vp] * 5 + [ci] * 4 + [vp] * 5 + [ci, vp]
        lib.pfft_cols_inv_wg.argtypes = [vp, vp] + [ci] * 4 + [vp] * 4 + [
            ci, vp]

        def rows():
            return lib.pfft_rows_wg(
                s["u"].data_ptr(), *planes, p_, w, m, 0, tab["wg"].data_ptr(),
                tab["wf"].data_ptr(), tab["wi"].data_ptr(), v1.data_ptr(),
                v2.data_ptr(), prods, stream)

        def cols():
            return lib.pfft_cols_inv_wg(
                s["v"][0].data_ptr(), s["v"][1].data_ptr(), p_, h, w, m,
                tab["wg"].data_ptr(), tab["wi"].data_ptr(), y0.data_ptr(),
                y1.data_ptr(), prods, stream)

    def checked(fn):
        def run():
            code = fn()
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
        return run

    return checked(rows), checked(cols), (v1, v2), (y0, y1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", choices=sorted(SOURCES), default="mma")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from jolideco_torch.ops import pallas_fft as pf

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_name, variants = SOURCES[args.source]
    built = kv.build({name: kv.patched_source(lib_name, patches)
                      for name, patches in variants.items()}, OUT)
    libs = {name: lib for name, (lib, _) in built.items()}
    ptxas = {name: [line.strip() for line in err.splitlines()
                    if "registers" in line or "spill" in line
                    or "Function properties" in line]
             for name, (_, err) in built.items()}
    x0, x1, planes, _, n = cs.pfft_inputs(torch, device, (1024, 1024), 4)
    u = pf.pfft_cols_fwd_cuda(x0, x1, n)
    v = pf.pfft_rows_combine_cuda(u, *planes)
    s = {"u": u, "v": v, "h": 1024, "planes": planes,
         "tables": pf._device_tables(n // 128, device)}
    ref = {mode: (pf.rows_combine_plain(u, *planes, mode=mode),
                  pf.cols_inv_plain(*v, 1024, mode=mode))
           for mode in ("split", "bf16")}
    runs = {(name, mode): calls(torch, pf, args.source, lib, s, mode)
            for name, lib in libs.items() for mode in ("split", "bf16")}
    errors = {}
    for (name, mode), (rows, cols, vk, yk) in runs.items():
        rows()
        cols()
        torch.cuda.synchronize()
        errors[f"{name} {mode}"] = max(
            float((a - b).abs().max() / b.abs().max())
            for a, b in zip((*vk, *yk), (*ref[mode][0], *ref[mode][1])))
    ms = {f"{name} {mode}": {"rows": [], "cols_inv": []}
          for name, mode in runs}
    order = list(runs)
    for keys in (order, order[::-1]):
        for key in keys:
            rows, cols, _, _ = runs[key]
            ms[" ".join(key)]["rows"].append(
                cs.cuda_ms(torch, rows, args.reps))
            ms[" ".join(key)]["cols_inv"].append(
                cs.cuda_ms(torch, cols, args.reps))
    mean = {key: {p: sum(t) / len(t) for p, t in val.items()}
            for key, val in ms.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for key in mean:
        print(f"{key}: rows {mean[key]['rows']:.4f} ms, cols_inv "
              f"{mean[key]['cols_inv']:.4f} ms (from the plain version "
              f"{errors[key]:.3g} of its max-abs)")
    line = json.dumps({"k3_variants": {
        "source": f"jolideco_torch/csrc/{lib_name}.cu",
        "batch": "5 pairs of 1024^2, n = 1152", "ms": mean, "readings": ms,
        "error_share": errors, "ptxas": ptxas, "card": card}})
    print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"k3_variants_{args.source}.json").write_text(line + "\n")


if __name__ == "__main__":
    main()
