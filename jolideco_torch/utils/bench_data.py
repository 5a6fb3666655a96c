"""The JAX package's benchmark data, for the port's smoke run and profiler.

A copy of ``make_datasets`` from the repository's ``bench.py``, which
cannot be imported without JAX: a field of gamma-distributed point
sources on a Gaussian halo, seen by ``n_obs`` observations through
Gaussian PSFs of widening sigma, as Poisson counts. And
``make_shifted_datasets``: a smooth field seen at known sub-pixel
offsets, the data of the calibrations' checks.

The forward model's breadth: ``make_multiband_datasets``, a shell seen
in four event classes of King PSFs, each a band stack folded by an
energy redistribution matrix (``examples/fermi_vela_junior_like.py``),
and ``inject_point_sources``, a list of point sources at sub-pixel
positions added to any datasets. Both simulate their counts through the
port's own forward model (``NPredModels``), on ``device``; the random
numbers are numpy's, from ``seed``.
"""

import numpy as np

from .kernels import gaussian_kernel_2d

__all__ = ["band_flux_estimate", "band_rmf", "inject_point_sources",
           "king_psf", "make_datasets", "make_multiband_datasets",
           "make_shifted_datasets"]


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


def king_psf(size, r_core, gamma):
    """A King profile, the Fermi-LAT PSF's form, on a ``size²`` grid
    (``size`` odd), normalised to one."""
    half = size // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    r2 = (xx**2 + yy**2) / r_core**2
    psf = (1 - 1 / gamma) * (1 + r2 / (2 * gamma)) ** (-gamma)
    return (psf / psf.sum()).astype(np.float32)


def band_rmf(n_bands):
    """Row-stochastic energy redistribution: each band keeps 0.8 of its
    counts and gives 0.2 to its neighbours in equal parts (the 3x3 matrix
    of ``examples/fermi_vela_junior_like.py`` at three bands)."""
    rmf = 0.8 * np.eye(n_bands)
    for c in range(n_bands):
        neighbours = [k for k in (c - 1, c + 1) if 0 <= k < n_bands]
        for k in neighbours:
            rmf[c, k] = 0.2 / len(neighbours)
    return rmf.astype(np.float32)


def _shell(size, rng):
    """A supernova-remnant shell with a brightened rim and four knots."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    r = np.hypot(xx - size / 2, yy - size / 2)
    phi = np.arctan2(yy - size / 2, xx - size / 2)
    shell = np.exp(-0.5 * ((r - 0.3 * size) / (0.02 * size)) ** 2)
    shell *= 1.0 + 0.8 * np.cos(phi - 2.3) ** 2
    flux = 3.0 * shell + 0.2 * np.exp(-r / (0.4 * size))
    for _ in range(4):
        x0, y0 = rng.uniform(0.25 * size, 0.75 * size, 2)
        flux += rng.uniform(10, 25) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / 2.0)
    return flux.astype(np.float32)


# the four event classes' King PSFs, (r_core, gamma, size), of
# examples/fermi_vela_junior_like.py
EVENT_CLASSES = ((12.0, 2.2, 129), (7.0, 2.5, 101), (3.5, 2.8, 65),
                 (1.8, 3.0, 49))


def _simulate(dataset, components, rng, device):
    """Poisson counts of the port's forward model of ``dataset``."""
    from ..models.npred import NPredModels

    models = NPredModels.from_dataset_numpy(dataset, components,
                                            device=device)
    npred = models.evaluate(components.fluxes_from())
    npred = npred[0].detach().cpu().numpy().astype(np.float64)
    counts = rng.poisson(np.clip(npred, 0, None)).astype(np.float32)
    return counts[0] if counts.shape[0] == 1 else counts


def make_multiband_datasets(n_classes=4, size=1024, n_bands=3,
                            psf_scale=1.0, seed=0, device="cpu"):
    """A shell seen in ``n_classes`` event classes, each a stack of
    ``n_bands`` bands.

    Each class's PSF is its King profile of :data:`EVENT_CLASSES` (129²,
    101², 65², 49²; sizes and cores times ``psf_scale``, sizes kept odd),
    its core widening by half its width a band. The exposure is 4 in the
    first band and halves a band, the background 0.3. Every dataset
    carries :func:`band_rmf`. The one 2-D flux, the shell,
    broadcasts over the bands; the counts are simulated through the
    port's forward model on ``device``.

    Returns
    -------
    datasets : dict of dataset dicts with ``(n_bands, size, size)``
        arrays and ``(n_bands, k, k)`` PSF stacks
    flux : ``(size, size)`` float32, the true flux
    """
    from ..models.core import FluxComponents, SpatialFluxComponent

    rng = np.random.RandomState(seed)
    flux = _shell(size, rng)
    truth = FluxComponents({"flux": SpatialFluxComponent(
        flux[None, None], use_log_flux=False, device=device)})
    shape = (n_bands, size, size)
    exposure = np.stack([np.full((size, size), 4.0 * 0.5**b, np.float32)
                         for b in range(n_bands)])
    datasets = {}
    for i, (r_core, gamma, k) in enumerate(EVENT_CLASSES[:n_classes]):
        k = max(3, int(round(k * psf_scale)) | 1)
        r_core = r_core * psf_scale
        psf = np.stack([king_psf(k, r_core * (1 + 0.5 * b), gamma)
                        for b in range(n_bands)])
        dataset = {"psf": psf, "exposure": exposure,
                   "background": np.full(shape, 0.3, np.float32),
                   "rmf": band_rmf(n_bands)}
        dataset["counts"] = _simulate(dataset, truth, rng, device)
        datasets[f"psf{i}"] = dataset
    return datasets, flux


def band_flux_estimate(datasets):
    """One 2-D flux from band-stacked data: the mean over the datasets
    of ``(counts - background) / exposure``, each summed over the bands
    (an RMF whose rows sum to one keeps the total), clipped below at its
    smallest positive value (so that its log is finite)."""
    fluxes = [(np.sum(d["counts"], axis=0) - np.sum(d["background"], axis=0))
              / np.sum(d["exposure"], axis=0) for d in datasets.values()]
    flux = np.mean(fluxes, axis=0)
    return np.clip(flux, flux[flux > 0].min(), None).astype(np.float32)


# the injected point sources' fluxes, and their least distance from the
# edges in pixels
SOURCE_FLUX_RANGE, SOURCE_MARGIN = (200.0, 1000.0), 16


def inject_point_sources(datasets, n_sources=256, seed=0, device="cpu"):
    """``datasets`` with the counts of ``n_sources`` point sources added.

    The sources lie at uniform sub-pixel positions at least
    ``SOURCE_MARGIN`` pixels from the edges, with fluxes uniform in
    ``SOURCE_FLUX_RANGE``; their
    counts go through each dataset's forward model (its PSF and
    exposure, no background) as a `SparseSpatialFluxComponent`, on
    ``device``, and are drawn from numpy's generator seeded with
    ``seed``.

    Returns
    -------
    datasets : dict
        Copies of the dataset dicts with the new counts.
    sources : dict
        ``x_pos``, ``y_pos`` and ``flux`` of the sources (float32).
    """
    from ..models.core import FluxComponents, SparseSpatialFluxComponent

    rng = np.random.RandomState(seed)
    shape = np.asarray(next(iter(datasets.values()))["counts"]).shape[-2:]
    margin = SOURCE_MARGIN
    sources = {
        "x_pos": rng.uniform(margin, shape[1] - 1 - margin,
                             n_sources).astype(np.float32),
        "y_pos": rng.uniform(margin, shape[0] - 1 - margin,
                             n_sources).astype(np.float32),
        "flux": rng.uniform(*SOURCE_FLUX_RANGE, n_sources).astype(
            np.float32),
    }
    points = FluxComponents({"points": SparseSpatialFluxComponent(
        shape=shape, use_log_flux=False, device=device, **sources)})
    out = {}
    for name, dataset in datasets.items():
        dataset = dict(dataset)
        psf = dataset["psf"]
        source_data = {"psf": psf["points"] if isinstance(psf, dict)
                       else psf, "exposure": dataset["exposure"],
                       "background": np.zeros_like(dataset["background"])}
        dataset["counts"] = (dataset["counts"]
                             + _simulate(source_data, points, rng, device))
        out[name] = dataset
    return out, sources
