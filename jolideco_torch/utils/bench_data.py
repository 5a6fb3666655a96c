"""The JAX package's benchmark data, for the port's smoke run and profiler.

A copy of ``make_datasets`` from the repository's ``bench.py``, which
cannot be imported without JAX: a field of gamma-distributed point
sources on a Gaussian halo, seen by ``n_obs`` observations through
Gaussian PSFs of widening sigma, as Poisson counts. Numpy only.
"""

import numpy as np

from .kernels import gaussian_kernel_2d

__all__ = ["make_datasets"]


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
