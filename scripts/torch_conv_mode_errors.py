"""The matrix-DFT convolutions' error against float64 at the main path's
shape, in the port and in the JAX package, on the CPU.

Two 1024² images uniform in [0, 2) (seed 3, as ``chip_smoke.py`` phase
14 (a) draws them) and two Gaussian PSFs of 33² (sigma 2.0 and 2.3, as
the main path's first two observations), convolved by:

- ``"ct"``'s pair convolution (``ct_convolve_pair``, one complex
  transform of 1089 = 121 x 9 a side) in ``"split3"`` and ``"highest"``,
  the port's and the JAX package's;
- ``"ct"``'s single convolution (``ct_convolve_single``) and ``"mxu"``'s
  (``mxu_convolve``, 1056 = 32 x 33) of the first image, in
  ``"split3"``, the port's and the JAX package's.

Each result against ``convolve_fft_numpy`` (float64): the largest
difference as a share of the result's max-abs. The port computes the
same products as the JAX package, so the two errors agree to float32
summation order; what they share is the design's own error. Prints one
JSON line.

    JAX_PLATFORMS=cpu python scripts/torch_conv_mode_errors.py
"""

import json

import numpy as np


def share(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from jax import lax

    import jolideco_torch.ops.ct_conv as tc
    import jolideco_torch.ops.fft_mxu as tm
    import jolideco_tpu.ops.ct_conv as jc
    import jolideco_tpu.ops.fft_mxu as jm
    from jolideco_torch.ops.fft import convolve_fft_numpy
    from jolideco_torch.utils.kernels import gaussian_kernel_2d

    n = 1024
    x = np.random.RandomState(3).uniform(0.0, 2.0, (2, 1, n, n)).astype(
        np.float32)
    kernels = [gaussian_kernel_2d(s, x_size=33, y_size=33) for s in (2.0,
                                                                     2.3)]
    refs = [convolve_fft_numpy(x[i, 0], kernels[i]) for i in range(2)]
    out = {}

    fs = (tc.ct_conv_shape(n + 32),) * 2
    tables = {"port": tc.make_ct_tables(fs), "jax": jc.make_ct_tables(fs)}
    spectra = {"port": tc.ct_kernel_pair(*kernels, (n, n), fs),
               "jax": jc.ct_kernel_pair(*kernels, (n, n), fs)}
    for precision, jax_precision in (("split3", "split3"),
                                     ("highest", lax.Precision.HIGHEST)):
        y_t = tc.ct_convolve_pair(torch.as_tensor(x[:1]),
                                  torch.as_tensor(x[1:]), *spectra["port"],
                                  tables["port"], fs, precision)
        y_j = jc.ct_convolve_pair(jnp.asarray(x[:1]), jnp.asarray(x[1:]),
                                  *spectra["jax"], tables["jax"], fs,
                                  jax_precision)
        for tag, ys in (("port", [y.numpy() for y in y_t]),
                        ("jax", [np.asarray(y) for y in y_j])):
            out[f"ct_pair_{precision}_{tag}"] = [
                share(ys[i][0, 0], refs[i]) for i in range(2)]

    embedded = np.roll(np.pad(kernels[0], ((0, fs[0] - 33), (0, fs[1] - 33))),
                       (-16, -16), (0, 1)).astype(np.float32)[None, None]
    fr, fi = tc.ct_kernel_spectra(torch.as_tensor(embedded), tables["port"])
    out["ct_single_split3_port"] = share(tc.ct_convolve_single(
        torch.as_tensor(x[:1]), fr, fi, tables["port"], fs).numpy()[0, 0],
        refs[0])
    jr, ji = jc.ct_kernel_spectra(jnp.asarray(embedded), tables["jax"])
    out["ct_single_split3_jax"] = share(np.asarray(jc.ct_convolve_single(
        jnp.asarray(x[:1]), jr, ji, tables["jax"], fs))[0, 0], refs[0])

    ms = (tm.mxu_conv_shape(n + 32),) * 2
    kernel = kernels[0].astype(np.float32)
    tab_t, tab_j = tm.make_dft_tables(ms), jm.make_dft_tables(ms)
    spec_t = tm.mxu_kernel_spectrum(torch.as_tensor(kernel), ms, tab_t)
    spec_j = jm.mxu_kernel_spectrum(jnp.asarray(kernel), ms, tab_j)
    out["mxu_split3_port"] = share(tm.mxu_convolve(
        torch.as_tensor(x[:1]), spec_t, tab_t, ms).numpy()[0, 0], refs[0])
    out["mxu_split3_jax"] = share(np.asarray(jm.mxu_convolve(
        jnp.asarray(x[:1]), spec_j, tab_j, ms))[0, 0], refs[0])
    print(json.dumps({"device": "cpu", "ct_shape": fs, "mxu_shape": ms,
                      "error_share_of_max_abs": out}))


if __name__ == "__main__":
    main()
