"""Text variants of K3's tensor-core kernels, timed on a CUDA card.

Each variant is a kernel source with a few lines replaced (``VARIANTS``),
built by ``nvcc`` like the package's libraries (all at once, into
``build/k3_variants/``, ``kernel_variants.py``) and loaded with
``ctypes``. Each runs at the main path's batch (5 pairs of 1024², n =
1152, ``chip_smoke.py``'s inputs), ``--reps`` calls after one (CUDA
events), the variants in turns (in order, then in reverse order; the
two readings' mean).

``--source wg`` (the default) takes ``csrc/pfft_conv_wg.cu``'s three
passes in both bf16 modes ("split": three bf16 products a step, "bf16":
one):

- ``base``; ``no_products``: no ``wgmma`` in passes 2 and 3;
  ``no_tables``: the producer issues no bulk copy and the consumers do
  not wait for one; ``no_epilogue``: the k2 sums are not stored;
  ``no_loads``: U, the spectra and V are not read (constants in their
  place); ``walk_own``, ``walk_full``: the consumers' walk over a
  table's stages unrolled by ptxas' own choice or fully, not one stage
  at a time;
- pass 1 (``pfft_cols_fwd_wg_kernel``): ``fwd_regs``: 136 registers
  for the multiplying warpgroup and 184 for the stage-A ones, not 120
  and 192; ``fwd_runs``: each CTA a contiguous run of units, not rounds
  of neighbouring items; ``fwd_3buf``: three operand buffers, not two;
  ``fwd_n48``: 48 operand rows a product (m64n48k16: 3 k2 of 16
  columns, 6 of 8), not 32; ``fwd_no_products``: no ``wgmma``;
  ``fwd_no_x``: x not read (constants in its place); ``fwd_no_sums``: no
  stage-A sums over the row blocks kept in registers and no twiddles;
  ``fwd_no_stores``: U not stored (ptxas then drops the products too);
  ``fwd_stcs``: U's stores streaming (evict-first).

``--source f32`` takes the same file's three float32 passes
(``"highest"``: six bf16 products of three-way splits a step):

- ``base``; ``no_products``, ``no_tables`` as above; ``no_stores``: U
  and y are not stored (ptxas then drops the products whose sums nobody
  reads, so this is ``no_products`` without the epilogues); ``no_sums``:
  pass 3 keeps its last k2's terms in its sums y_a, adding none;
  ``no_loads``: x0, x1 (pass 1) are not read and V (pass 3) is not
  copied into its staging; ``no_wi``: pass 3's weights wi are
  constants, not loads; ``four_blocks``: pass 1 keeps four row
  blocks' loads in flight, not two; ``y0_only``: pass 3 stores y0
  alone; ``y_stcs``: its stores streaming (evict-first); ``y_dense``:
  the same bytes to a dense layout, each item's rows of 8 columns back
  to back (wrong values, whole lines); ``walk_by_1``: passes 1 and 3
  walk a table's stages one at a time, not fully unrolled;
- pass 2: ``rows_walk_full``: its walk fully unrolled, not one stage at
  a time; ``rows_no_u``: U is not read (constants in its place);
  ``rows_no_spectra``: nor are the spectra; ``rows_no_epilogue``: V1
  and V2 are not stored; ``rows_reg<k>``: the first k products of a
  round in registers (``kRegK2``), the others in shared memory.

``--variants`` builds and times only the variants named (``base`` is
always among them), ``--passes`` only the passes named (``cols_fwd``,
``rows``, ``cols_inv``), ``--size`` at 5 pairs of that square size (1024
by default; 2048 is the x2 path's batch, n = 2176). Prints one JSON line
(ms by variant, pass and mode,
each variant's largest difference from the plain version of its mode
over its max-abs (``rows_combine_plain``, ``cols_inv_plain``,
``cols_fwd_plain``), which only ``base`` and the variants that keep the
arithmetic must keep small, ``ptxas``' register and spill lines, the
card's name and power limit; ptxas' C7517 lines, where it injected a
``wgmma`` wait) and writes it to
``k3_variants_<source>.json`` in the checkout's output folder (beside
``build/``, listed in ``.gitignore``). Run from the root of a checkout:

    python3 scripts/torch_k3_variants.py --source f32

``--sweep`` builds no variant: it holds the package's float32 pass 2
(``pallas_fft.pfft_rows_combine_cuda``) at every m from 1 to 37 (one
round of k2 up to 9, then several), one pair of random U (W = 256, 128
at m = 1) and spectra, both directions, to ``chip_smoke.py`` phase 2's
bar (at most twice the float32 plain version's error from float64,
plus 1e-6 of the max-abs), and prints each m's error as a share of the
bar in one JSON line (``k3_sweep_f32.json`` in the same folder).
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
    # the walk over a table's stages unrolled by ptxas' own choice, or
    # fully, instead of one stage at a time
    "walk_own": [("#pragma unroll(kUnroll)\n", "")],
    "walk_full": [("walk_table<L, 1, 1>(", "walk_table<L, 1, 4>(")],
    # pass 1
    "fwd_regs": [("constexpr int kMmaRegs = 120, kStageRegs = 192;",
                  "constexpr int kMmaRegs = 136, kStageRegs = 184;")],
    "fwd_runs": [("    rounds = items / gridDim.x;", "    rounds = 0;")],
    "fwd_3buf": [("constexpr int kFwdBufs = 2;",
                  "constexpr int kFwdBufs = 3;")],
    "fwd_n48": [("constexpr int kN1 = 32;", "constexpr int kN1 = 48;")],
    "fwd_no_products": [("wg::wgmma_ss_n32<kSign>(", "(void)(")],
    "fwd_no_x": [
        ("z[n2][r] = make_float2(__ldg(x0 + at), __ldg(x1 + at));",
         "z[n2][r] = make_float2((float)at, 1.f);"),
        ("x[r] = make_float2(__ldg(x0 + at), __ldg(x1 + at));",
         "x[r] = make_float2((float)at, 1.f);")],
    "fwd_no_sums": [("      for (int n2 = 0; n2 < kRes; ++n2) {\n"
                     "        if (n2 >= hb)",
                     "      for (int n2 = 0; n2 < 0; ++n2) {\n"
                     "        if (n2 >= hb)"),
                    ("        if (k2 < m) {\n          // the twiddle",
                     "        if (k2 < 0) {\n          // the twiddle")],
    "fwd_no_stores": [
        ("          *reinterpret_cast<float4*>(\n"
         "              out + ((size_t)kLane * k2 + 64 * t + 8 * h) * W +\n"
         "              8 * j % kCols) =\n"
         "              make_float4(re[t][r], im[t][r], re[t][r + 1], "
         "im[t][r + 1]);",
         "          (void)out;")],
    "fwd_stcs": [
        ("          *reinterpret_cast<float4*>(\n"
         "              out + ((size_t)kLane * k2 + 64 * t + 8 * h) * W +\n"
         "              8 * j % kCols) =\n"
         "              make_float4(re[t][r], im[t][r], re[t][r + 1], "
         "im[t][r + 1]);",
         "          __stcs(reinterpret_cast<float4*>(\n"
         "              out + ((size_t)kLane * k2 + 64 * t + 8 * h) * W +\n"
         "              8 * j % kCols),\n"
         "              make_float4(re[t][r], im[t][r], re[t][r + 1], "
         "im[t][r + 1]));")],
}
F32_VARIANTS = {
    "base": [],
    "no_products": [("wg::wgmma_rs_n32<kSign>(", "(void)("),
                    ("wg::wgmma_rs_n16<kSign>(", "(void)("),
                    ("wg::wgmma_rs_n8<kSign>(", "(void)(")],
    "no_tables": WG_VARIANTS["no_tables"],
    "no_stores": [
        ("*reinterpret_cast<float4*>(out + (size_t)8 * h * W + 8 * j) =\n"
         "            make_float4(re[i], im[i], re[i + 1], im[i + 1]);",
         "(void)out;"),
        ("*reinterpret_cast<float2*>(out + at) =\n"
         "              make_float2(y[j][4 * e + 2 * h], "
         "y[j][4 * e + 2 * h + 1]);", "(void)(out + at);")],
    "no_sums": [("          y[j][i] += i < 4 ?",
                 "          y[j][i] = i < 4 ?")],
    "no_loads": [
        ("xr[b][r] = __ldg(x0 + row + (size_t)r * W);",
         "xr[b][r] = (float)(row + r);"),
        ("xi[b][r] = __ldg(x1 + row + (size_t)r * W);", "xi[b][r] = 1.f;"),
        ("tc::cp_async16(staging + buf * kStaging3 + 16 * c, from);",
         "(void)from;")],
    "four_blocks": [("constexpr int kInFlight = 2;",
                     "constexpr int kInFlight = 4;")],
    "no_wi": [("w[j] = __ldg(wi + (a0 + (j < na ? j : 0)) * m + k2);",
               "w[j] = make_float2(1.f, 0.25f * j);")],
    # pass 3's stores: only y0's; streaming (evict-first) stores; the same
    # bytes to a dense layout (each item's rows of 8 columns back to back:
    # wrong values, whole lines)
    "y0_only": [("          float* out = e == 0 ? y0 : y1;",
                 "          if (e == 1) continue;\n"
                 "          float* out = y0;")],
    "y_stcs": [("          *reinterpret_cast<float2*>(out + at) =\n"
                "              make_float2(y[j][4 * e + 2 * h], "
                "y[j][4 * e + 2 * h + 1]);",
                "          __stcs(reinterpret_cast<float2*>(out + at),\n"
                "              make_float2(y[j][4 * e + 2 * h], "
                "y[j][4 * e + 2 * h + 1]));")],
    # passes 1 and 3 walk a table's stages one stage at a time, not fully
    # unrolled
    "walk_by_1": [("constexpr int kColsUnroll = kChunks3;",
                   "constexpr int kColsUnroll = 1;")],
    # pass 2: the walk fully unrolled; U, the spectra not read; V1, V2
    # not stored; k products of a round in registers
    "rows_walk_full": [("constexpr int kRowsUnroll = 1;",
                        "constexpr int kRowsUnroll = kChunks3;")],
    "rows_no_u": WG_VARIANTS["no_loads"][:1],
    "rows_no_spectra": WG_VARIANTS["no_loads"][1:2],
    "rows_no_epilogue": WG_VARIANTS["no_epilogue"][:1],
    **{f"rows_reg{k}": [("constexpr int kRegK2 = 5;",
                         f"constexpr int kRegK2 = {k};")]
       for k in (3, 4, 6, 7)},
    "y_dense": [("          const size_t at = (row0 + 8 * h) * W + c0 + "
                 "2 * q;",
                 "          const size_t at = ((size_t)it * H + kLane * "
                 "(a0 + j) + b0 + 8 * h) * 8 % ((size_t)P * H * W) + "
                 "2 * q;")],
}
SOURCES = {"wg": ("pfft_conv_wg", WG_VARIANTS, ("split", "bf16")),
           "f32": ("pfft_conv_wg", F32_VARIANTS, ("f32",))}


def calls(torch, kind, lib, s, mode):
    """The passes of one variant library on the inputs ``s`` (the three
    passes: ``wg`` of ``mode``, ``f32`` in float32), outputs
    allocated once, each call one launch: ``{pass: (call, outputs)}``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    p_, n, w = s["u"].shape
    h, m = s["h"], n // 128
    tab = s["tables"]
    stream = torch.cuda.current_stream().cuda_stream
    v1, v2 = torch.empty_like(s["u"]), torch.empty_like(s["u"])
    y0 = torch.empty((p_, h, w), dtype=torch.float32, device=s["u"].device)
    y1 = torch.empty_like(y0)
    planes = [t.data_ptr() for t in s["planes"]]
    rows_args = (s["u"].data_ptr(), *planes, p_, w, m, 0)
    cols_args = (s["v"][0].data_ptr(), s["v"][1].data_ptr(), p_, h, w, m)
    if kind == "f32":
        lib.pfft_cols_fwd_f32.argtypes = [vp, vp] + [ci] * 4 + [vp] * 4
        lib.pfft_rows_f32.argtypes = [vp] * 5 + [ci] * 4 + [vp] * 6
        lib.pfft_cols_inv_f32.argtypes = [vp, vp] + [ci] * 4 + [vp] * 5
        u = torch.empty_like(s["u"])
        tables = tab["wg3"].data_ptr()
        passes = {
            "cols_fwd": (lambda: lib.pfft_cols_fwd_f32(
                s["x0"].data_ptr(), s["x1"].data_ptr(), p_, h, w, m, tables,
                tab["wf"].data_ptr(), u.data_ptr(), stream), (u,)),
            "rows": (lambda: lib.pfft_rows_f32(
                *rows_args, tables, tab["wf"].data_ptr(),
                tab["wi"].data_ptr(), v1.data_ptr(), v2.data_ptr(), stream),
                (v1, v2)),
            "cols_inv": (lambda: lib.pfft_cols_inv_f32(
                *cols_args, tables, tab["wi"].data_ptr(), y0.data_ptr(),
                y1.data_ptr(), stream), (y0, y1))}
    else:
        prods = 3 if mode == "split" else 1
        lib.pfft_cols_fwd_wg.argtypes = [vp, vp] + [ci] * 4 + [vp] * 4 + [
            ci, vp]
        lib.pfft_rows_wg.argtypes = [vp] * 5 + [ci] * 4 + [vp] * 5 + [ci, vp]
        lib.pfft_cols_inv_wg.argtypes = [vp, vp] + [ci] * 4 + [vp] * 4 + [
            ci, vp]
        tables = tab["wg"].data_ptr()
        u = torch.empty_like(s["u"])
        passes = {
            "cols_fwd": (lambda: lib.pfft_cols_fwd_wg(
                s["x0"].data_ptr(), s["x1"].data_ptr(), p_, h, w, m, tables,
                tab["wf"].data_ptr(), tab["tw"].data_ptr(), u.data_ptr(),
                prods, stream), (u,)),
            "rows": (lambda: lib.pfft_rows_wg(
                *rows_args, tables, tab["wf"].data_ptr(),
                tab["wi"].data_ptr(), v1.data_ptr(), v2.data_ptr(), prods,
                stream), (v1, v2)),
            "cols_inv": (lambda: lib.pfft_cols_inv_wg(
                *cols_args, tables, tab["wi"].data_ptr(), y0.data_ptr(),
                y1.data_ptr(), prods, stream), (y0, y1))}

    def checked(fn):
        def run():
            code = fn()
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
        return run

    return {name: (checked(fn), out) for name, (fn, out) in passes.items()
            if name in s["passes"]}


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def sweep(torch, cs, pf, device):
    """The package's float32 pass 2 at m = 1 .. 37 against phase 2's bar;
    returns one JSON line of each m's error as a share of the bar (both
    directions, V1 and V2, the largest)."""
    shares = {}
    for m in range(1, 38):
        n, w = 128 * m, 128 if m == 1 else 256
        gen = torch.Generator(device=device).manual_seed(m)
        u = torch.randn((1, n, w), generator=gen, device=device,
                        dtype=torch.complex64)
        spectra = [torch.randn((1, n, n), generator=gen, device=device)
                   for _ in range(4)]
        worst = 0.0
        for conj in (False, True):
            v = pf.pfft_rows_combine_cuda(u, *spectra, conj)
            v32 = pf.rows_combine_plain(u, *spectra, conj)
            v64 = pf.rows_combine_plain(u.to(torch.complex128), *spectra,
                                        conj, torch.float64)
            for got, want32, want64 in zip(v, v32, v64):
                err = float((got.to(want64.dtype) - want64).abs().max())
                err32 = float((want32.to(want64.dtype) - want64).abs().max())
                scale = float(want64.abs().max())
                worst = max(worst, err / (cs.MARG_ERR_FACTOR * err32
                                          + cs.MARG_ERR_FLOOR * scale))
        shares[m] = worst
        print(f"m = {m}: pass 2 f32 error {worst:.3f} of the bar")
    return json.dumps({"k3_sweep_f32": {
        "bar_share": shares, "within": max(shares.values()) <= 1.0,
        "card": card_name()}})


def timed_variants(torch, cs, pf, device, args):
    """The variants of ``args.source`` built, checked and timed in turns;
    returns one JSON line."""
    lib_name, variants, modes = SOURCES[args.source]
    names = ["base"] + [v for v in args.variants or variants if v != "base"]
    built = kv.build({name: kv.patched_source(lib_name, variants[name])
                      for name in names}, OUT)
    libs = {name: lib for name, (lib, _) in built.items()}
    ptxas = {name: [line.strip() for line in err.splitlines()
                    if "registers" in line or "spill" in line
                    or "Function properties" in line or "C7517" in line]
             for name, (_, err) in built.items()}
    size = args.size
    x0, x1, planes, _, n = cs.pfft_inputs(torch, device, (size, size), 4)
    u = pf.pfft_cols_fwd_cuda(x0, x1, n)
    v = pf.pfft_rows_combine_cuda(u, *planes)
    s = {"x0": x0, "x1": x1, "u": u, "v": v, "h": size, "planes": planes,
         "tables": pf._device_tables(n // 128, device),
         "passes": args.passes or ("cols_fwd", "rows", "cols_inv")}
    ref = {mode: {"rows": pf.rows_combine_plain(u, *planes, mode=mode),
                  "cols_inv": pf.cols_inv_plain(*v, size, mode=mode),
                  "cols_fwd": (pf.cols_fwd_plain(x0, x1, n, mode=mode),)}
           for mode in modes}
    runs = {(name, mode): calls(torch, args.source, lib, s, mode)
            for name, lib in libs.items() for mode in modes}
    errors = {}
    for (name, mode), passes in runs.items():
        for run, _ in passes.values():
            run()
        torch.cuda.synchronize()
        errors[f"{name} {mode}"] = max(
            float((a - b).abs().max() / b.abs().max())
            for key, (_, out) in passes.items()
            for a, b in zip(out, ref[mode][key]))
    ms = {f"{name} {mode}": {key: [] for key in passes}
          for (name, mode), passes in runs.items()}
    order = list(runs)
    for keys in (order, order[::-1]):
        for key in keys:
            for pass_, (run, _) in runs[key].items():
                ms[" ".join(key)][pass_].append(
                    cs.cuda_ms(torch, run, args.reps))
    mean = {key: {p: sum(t) / len(t) for p, t in val.items()}
            for key, val in ms.items()}
    for key in mean:
        print(f"{key}: " + ", ".join(f"{p} {t:.4f} ms"
                                     for p, t in mean[key].items())
              + f" (from the plain version {errors[key]:.3g} of its "
              "max-abs)")
    return json.dumps({"k3_variants": {
        "source": f"jolideco_torch/csrc/{lib_name}.cu",
        "batch": f"5 pairs of {size}^2, n = {n}", "ms": mean, "readings": ms,
        "error_share": errors, "ptxas": ptxas, "card": card_name()}})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", choices=sorted(SOURCES), default="wg")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--variants", nargs="*")
    parser.add_argument("--passes", nargs="*",
                        choices=("cols_fwd", "rows", "cols_inv"))
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args()

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from jolideco_torch.ops import pallas_fft as pf

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sweep:
        line = sweep(torch, cs, pf, device)
        name = "k3_sweep_f32.json"
    else:
        line = timed_variants(torch, cs, pf, device, args)
        name = f"k3_variants_{args.source}.json"
    print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / name).write_text(line + "\n")


if __name__ == "__main__":
    main()
