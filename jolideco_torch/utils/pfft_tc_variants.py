"""Block-size variants of the tensor-core matrix-DFT kernels, timed on a card.

``csrc/pfft_conv_tc.cu`` runs pass 2 with ``kRows`` rows and pass 3 with
``kCols`` columns per block, one block per SM. This script builds copies
of the source with other values (and, optionally, two blocks per SM for
pass 3 through ``__launch_bounds__``), loads each with the wrappers' own
``ctypes`` signatures, checks each against the ``"split"`` plain version
and times both kernels in turns (each variant twice, in forward then in
reverse order) at the main path's batch: 5 pairs of 1024² and of
1024 x 896, n = 1152, the 33² PSF pairs. Run on a machine with a CUDA
card and ``nvcc``:

    python -m jolideco_torch.utils.pfft_tc_variants

Builds go to ``build/kernels/variants/``; nothing of the package changes.
"""

import ctypes
import re
import subprocess

import numpy as np

# name -> (rows per block in pass 2, columns per block in pass 3, blocks
# per SM asked of pass 3)
VARIANTS = {"r32c32": (32, 32, 1), "r16c16": (16, 16, 1),
            "r16c16b2": (16, 16, 2)}
SHAPES = ((1024, 1024), (1024, 896))


def variant_source(text, rows, cols, blocks_inv):
    """``pfft_conv_tc.cu`` with other block sizes."""
    text = re.sub(r"constexpr int kRows = \d+;", f"constexpr int kRows = {rows};",
                  text)
    text = re.sub(r"constexpr int kCols = \d+;", f"constexpr int kCols = {cols};",
                  text)
    bounds = "__launch_bounds__(kThreads, 1)"
    i = text.rindex(bounds)  # the second kernel: pass 3
    return (text[:i] + f"__launch_bounds__(kThreads, {blocks_inv})"
            + text[i + len(bounds):])


def build(names):
    from . import cuda_build as cb

    out = cb.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    text = (cb.CSRC_DIR / "pfft_conv_tc.cu").read_text()
    procs = {}
    for name in names:
        src = out / f"{name}.cu"
        src.write_text(variant_source(text, *VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        print(name, VARIANTS[name], "; ".join(
            line.split(":", 1)[-1].strip() for line in err.splitlines()
            if "registers" in line or "spill" in line))
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def inputs(torch, device, shape, seed=4):
    """5 pairs of ``shape`` images and the spectra of widening 33²
    Gaussian PSF pairs at the main path's transform size."""
    from ..ops import pallas_fft as pf
    from .kernels import gaussian_kernel_2d

    psfs = torch.as_tensor(np.stack([
        gaussian_kernel_2d(2.0 + 0.3 * i, x_size=33, y_size=33)
        for i in range(10)]).astype(np.float32), device=device)
    n = pf.pfft_size(max(shape) + 32)
    planes = pf.pfft_pair_spectra_device(psfs[0::2], psfs[1::2], shape, n)
    rs = np.random.RandomState(seed)
    x0, x1 = (torch.as_tensor(rs.uniform(0.0, 2.0, (5,) + shape)
                              .astype(np.float32), device=device)
              for _ in range(2))
    return x0, x1, planes, n


def cuda_ms(torch, fn, reps=20):
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


def main():
    import torch

    from ..ops import pallas_fft as pf

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    from . import cuda_build as cb

    libs = build(VARIANTS)
    saved = cb.load_library
    try:
        for shape in SHAPES:
            x0, x1, planes, n = inputs(torch, device, shape)
            u = pf.pfft_cols_fwd_cuda(x0, x1, n)
            v = pf.pfft_rows_combine_cuda(u, *planes)
            ref_v = pf.rows_combine_plain(u, *planes, mode="split")
            ref_y = pf.cols_inv_plain(*v, shape[0], mode="split")
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    cb.load_library = (
                        lambda lib_name, lib=libs[name]:
                        lib if lib_name == "pfft_conv_tc" else saved(lib_name))
                    vt = pf.pfft_rows_combine_tc_cuda(u, *planes)
                    yt = pf.pfft_cols_inv_tc_cuda(*v, shape[0])
                    torch.cuda.synchronize()
                    ev = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(vt, ref_v))
                    ey = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(yt, ref_y))
                    ms_r = cuda_ms(torch, lambda: pf.pfft_rows_combine_tc_cuda(
                        u, *planes))
                    ms_c = cuda_ms(torch, lambda: pf.pfft_cols_inv_tc_cuda(
                        *v, shape[0]))
                    print(f"{shape} {name}: rows {ms_r:.4f} ms (from the "
                          f"split plain version {ev:.3g} of its max-abs), "
                          f"cols_inv {ms_c:.4f} ms ({ey:.3g})")
    finally:
        cb.load_library = saved


if __name__ == "__main__":
    main()
