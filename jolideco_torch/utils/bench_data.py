"""The JAX package's benchmark data, for the port's smoke run and profiler.

A copy of ``make_datasets`` from the repository's ``bench.py``, which
cannot be imported without JAX: a field of gamma-distributed point
sources on a Gaussian halo, seen by ``n_obs`` observations through
Gaussian PSFs of widening sigma, as Poisson counts. And
``make_shifted_datasets``: a smooth field seen at known sub-pixel
offsets, the data of the calibrations' checks. Numpy only.
"""

import numpy as np

from .kernels import gaussian_kernel_2d

__all__ = ["make_datasets", "make_shifted_datasets"]


def make_datasets(n_obs=10, size=1024, psf_size=33, seed=0):
    """Synthetic joint-observation datasets at benchmark scale.

    Point sources of gamma-distributed flux on a Gaussian halo, seen
    through per-observation Gaussian PSFs of widening sigma, with
    exposure ``1 + 0.1 i`` and a flat background of 2.
    """
    rng = np.random.RandomState(seed)
    datasets = {}
    yy, xx = np.mgrid[0:size, 0:size]
    flux = np.zeros((size, size), np.float32)
    for _ in range(200):
        x0, y0 = rng.randint(0, size, 2)
        flux[y0, x0] += rng.gamma(2.0) * 50
    flux += 10 * np.exp(
        -((xx - size / 2) ** 2 + (yy - size / 2) ** 2) / (2 * (size / 8) ** 2)
    ).astype(np.float32)

    for i in range(n_obs):
        sigma = 2.0 + 0.3 * i
        psf = gaussian_kernel_2d(
            sigma, x_size=psf_size, y_size=psf_size
        ).astype(np.float32)
        exposure = (1.0 + 0.1 * i) * np.ones((size, size), np.float32)
        background = 2.0 * np.ones((size, size), np.float32)
        lam = background + 0.05 * flux * exposure
        counts = rng.poisson(lam).astype(np.float32)
        datasets[f"obs-{i}"] = {
            "counts": counts,
            "psf": psf,
            "exposure": exposure,
            "background": background,
        }
    return datasets


# the sub-pixel offsets (x, y in data pixels) of make_shifted_datasets
OFFSETS = ((0.0, 0.0), (0.35, -0.2), (-0.25, 0.3), (0.15, 0.4))


def make_shifted_datasets(size=64, psf_size=9, seed=3, offsets=OFFSETS):
    """One dataset per offset: a halo and six Gaussian blobs on a flat sky
    of 8, evaluated at the pixel centres moved by the offset (x, y in
    data pixels), through Gaussian PSFs of widening sigma and exposure
    ``1 + 0.1 i``, as Poisson counts on a background 1.1 times the
    datasets' own (so that a background norm has something to fit)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    blobs = [(rs.uniform(8, size - 8), rs.uniform(8, size - 8),
              rs.uniform(20, 60), rs.uniform(0.8, 2.0)) for _ in range(6)]
    half = psf_size // 2
    datasets = {}
    for i, (sx, sy) in enumerate(offsets):
        y, x = yy + sy, xx + sx
        truth = 8 + 5 * np.exp(-((x - size / 2) ** 2
                                 + (y - size / 2 + 4) ** 2) / (2 * 8.0**2))
        for y0, x0, amp, width in blobs:
            truth += amp * np.exp(-((x - x0) ** 2 + (y - y0) ** 2)
                                  / (2 * width**2))
        psf = gaussian_kernel_2d(1.5 + 0.3 * i, x_size=psf_size,
                                 y_size=psf_size)
        exposure = 1 + 0.1 * i
        pad = 2 * half
        kernel = np.roll(np.pad(psf, ((0, size + pad - psf_size),
                                      (0, size + pad - psf_size))),
                         (-half, -half), (0, 1))
        lam = np.fft.irfft2(
            np.fft.rfft2(np.pad(truth * exposure, ((0, pad), (0, pad))))
            * np.fft.rfft2(kernel), s=(size + pad, size + pad))[:size, :size]
        background = np.ones((size, size), np.float32)
        counts = rs.poisson(np.clip(lam, 0, None) + 1.1 * background)
        datasets[f"obs-{i}"] = {
            "counts": counts.astype(np.float32),
            "psf": psf.astype(np.float32),
            "exposure": np.full((size, size), exposure, np.float32),
            "background": background,
        }
    return datasets
