"""Synthetic Poisson test datasets (the JAX package's ``data/core.py``).

Three toy generators returning ``{"counts", "psf", "exposure",
"background", "flux"}`` numpy dicts, the data of the examples. A copy
of the JAX package's, which cannot be imported from here without
pulling in JAX: numpy and scipy only, the same arrays bit for bit from
the same ``random_state``. The kernels are the package's own
(``utils/kernels.py``); the expected counts come from scipy's FFT
convolution on the host. Non-square ``shape`` and ``shape_psf`` work.
"""

import numpy as np
from scipy.signal import fftconvolve

from ..utils.kernels import gaussian_kernel_2d, tophat_kernel_2d

__all__ = [
    "point_source_gauss_psf",
    "disk_source_gauss_psf",
    "gauss_and_point_sources_gauss_psf",
]

BACKGROUND_LEVEL_DEFAULT = 2


def point_source_gauss_psf(
    shape=(32, 32),
    shape_psf=(17, 17),
    sigma_psf=3,
    source_level=1000,
    background_level=BACKGROUND_LEVEL_DEFAULT,
    random_state=None,
    dtype=np.float32,
):
    """Point source in the center with a Gaussian PSF; flat exposure."""
    if random_state is None:
        random_state = np.random.RandomState(None)

    background = background_level * np.ones(shape)
    exposure = np.ones(shape)

    flux = np.zeros(shape)
    flux[shape[0] // 2, shape[1] // 2] = source_level

    psf = gaussian_kernel_2d(
        sigma_psf, x_size=shape_psf[1], y_size=shape_psf[0]
    )
    npred = background + fftconvolve(flux * exposure, psf, mode="same")

    counts = random_state.poisson(npred)
    return {
        "counts": counts.astype(dtype),
        "psf": psf.astype(dtype),
        "exposure": exposure.astype(dtype),
        "background": background.astype(dtype),
        "flux": flux.astype(dtype),
    }


def disk_source_gauss_psf(
    shape=(32, 32),
    shape_psf=(17, 17),
    sigma_psf=3,
    source_level=1000,
    source_radius=3,
    background_level=BACKGROUND_LEVEL_DEFAULT,
    random_state=None,
    dtype=np.float32,
):
    """Disk source with a Gaussian PSF; exposure gradient left-right."""
    if random_state is None:
        random_state = np.random.RandomState(None)

    background = background_level * np.ones(shape)
    exposure = np.ones(shape) + 0.5 * np.linspace(-1, 1, shape[1])

    flux = source_level * tophat_kernel_2d(
        radius=source_radius, x_size=shape[1], y_size=shape[0],
        mode="oversample",
    )

    psf = gaussian_kernel_2d(
        sigma_psf, x_size=shape_psf[1], y_size=shape_psf[0]
    )
    npred = background + fftconvolve(flux * exposure, psf, mode="same")

    counts = random_state.poisson(npred)
    return {
        "counts": counts.astype(dtype),
        "psf": psf.astype(dtype),
        "exposure": exposure.astype(dtype),
        "background": background.astype(dtype),
        "flux": flux.astype(dtype),
    }


def gauss_and_point_sources_gauss_psf(
    shape=(32, 32),
    shape_psf=(17, 17),
    sigma_psf=2,
    source_level=1000,
    source_radius=2,
    background_level=BACKGROUND_LEVEL_DEFAULT,
    random_state=None,
    dtype=np.float32,
):
    """Central Gaussian source plus four point sources of varying flux.

    Point sources at 100%, 30%, 10% and 3% of the main source level;
    exposure gradient top-bottom.
    """
    if random_state is None:
        random_state = np.random.RandomState(None)

    background = background_level * np.ones(shape)
    exposure = np.ones(shape) + 0.5 * np.linspace(-1, 1, shape[0]).reshape(
        (-1, 1)
    )

    flux = source_level * gaussian_kernel_2d(
        source_radius, x_size=shape[1], y_size=shape[0], mode="oversample"
    )

    for fraction, idx_x, idx_y in zip(
        [1, 0.3, 0.1, 0.03], [16, 16, 26, 6], [26, 6, 16, 16]
    ):
        flux[idx_y, idx_x] = fraction * source_level

    psf = gaussian_kernel_2d(
        sigma_psf, x_size=shape_psf[1], y_size=shape_psf[0]
    )
    npred = background + fftconvolve(flux * exposure, psf, mode="same")

    counts = random_state.poisson(npred)
    return {
        "counts": counts.astype(dtype),
        "psf": psf.astype(dtype),
        "exposure": exposure.astype(dtype),
        "background": background.astype(dtype),
        "flux": flux.astype(dtype),
    }
