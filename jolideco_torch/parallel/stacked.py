"""Stacked multi-observation Poisson loss, FFT convolution only.

Counterpart of the JAX package's ``parallel/stacked.py``. Observations of one
image shape stack on a leading ``obs`` axis; PSFs of different sizes are
center-padded to a common size and their spectra precomputed at one
common FFT shape, so the forward of every observation is one batched
computation:

    flux * exposure -> PSF convolution -> sum pool -> clip -> + background
    -> Poisson NLL with the precomputed Stirling term

Ported: ``conv_mode="fft"`` (and ``"auto"``, which resolves to it on the
card until the matmul-DFT kernel is ported), without calibrations and
without energy redistribution. The other convolution backends and the
mesh paths are not.
"""

import numpy as np
import torch

from ..loss import poisson_nll, stirling_term_mean
from ..ops.fft import (
    build_kernel_stack,
    convolve_fft_precomputed,
    upsample_center_pad_kernels,
)
from ..ops.image import sum_pool

__all__ = ["StackedPoissonLoss"]


class StackedPoissonLoss:
    """Per-dataset Poisson terms over a stacked observation axis.

    Attributes
    ----------
    counts, background : tensors ``(N, 1, 1, H, W)``
    exposures : dict of component name -> ``(N, 1, 1, H, W)``
    psf_ffts : dict of component name -> complex ``(N, 1, 1, fh, fw//2+1)``
    stirling : ``(N,)`` precomputed Stirling terms
    """

    def __init__(self, counts, background, exposures, psf_ffts, names_all,
                 component_factors, fft_shape, component_names=None):
        self.counts = counts
        self.background = background
        self.exposures = dict(exposures)
        self.psf_ffts = dict(psf_ffts)
        self.stirling = torch.stack([stirling_term_mean(c) for c in counts])
        self.names_all = tuple(names_all)
        self.component_factors = tuple(component_factors)
        self.component_names = (
            tuple(component_names) if component_names is not None
            else tuple(exposures)
        )
        self.fft_shape = tuple(fft_shape)

    @property
    def n_datasets(self):
        return len(self.names_all)

    @property
    def weights(self):
        """Per-dataset likelihood weights (1 without calibrations)."""
        return torch.ones(self.n_datasets, dtype=torch.float32,
                          device=self.counts.device)

    @classmethod
    def from_datasets(cls, datasets, components, calibrations=None,
                      fft_shape=None, conv_mode="fft",
                      correct_exposure_edges=True, device=None):
        """Stack homogeneous numpy datasets into batched tensors.

        ``datasets`` maps names to dicts of ``counts``, ``psf`` (array,
        or dict keyed by component), ``exposure`` and ``background``
        2-D arrays.
        """
        if conv_mode not in ("fft", "auto"):
            raise NotImplementedError(
                f"conv_mode={conv_mode!r} is not ported yet; use 'fft'"
            )
        if calibrations:
            raise NotImplementedError("calibrations are not ported yet")
        if any("rmf" in d for d in datasets.values()):
            raise NotImplementedError("rmf is not ported yet")
        shapes = {np.asarray(d["counts"]).shape for d in datasets.values()}
        if len(shapes) != 1:
            raise ValueError(
                f"Stacked observations need one common counts shape, got "
                f"{shapes}"
            )

        def stack(key):
            arr = np.stack([np.asarray(d[key], np.float32)
                            for d in datasets.values()])[:, None, None]
            return torch.as_tensor(arr, device=device)

        counts = stack("counts")
        background = stack("background")
        raw_exps = stack("exposure")

        exposures, psf_ffts, factors = {}, {}, []
        common_fft_shape = None if fft_shape is None else tuple(fft_shape)
        for name, component in components.items():
            factor = component.upsampling_factor or 1
            factors.append(factor)
            raw_psfs = []
            for dataset in datasets.values():
                psf = dataset["psf"]
                if isinstance(psf, dict):
                    psf = psf[name]
                raw_psfs.append(np.asarray(psf, np.float32))

            image_shape = tuple(factor * s for s in raw_exps.shape[-2:])
            kmax = (max(p.shape[-2] for p in raw_psfs),
                    max(p.shape[-1] for p in raw_psfs))
            min_shape = (image_shape[0] + kmax[0] - 1,
                         image_shape[1] + kmax[1] - 1)
            if common_fft_shape is None:
                common_fft_shape = min_shape
            if (common_fft_shape[0] < min_shape[0]
                    or common_fft_shape[1] < min_shape[1]):
                raise ValueError(
                    f"fft_shape {common_fft_shape} too small for component "
                    f"{name!r} (needs at least {min_shape})"
                )

            # ragged PSF sizes: center-pad per shape group, then restore
            # observation order
            kernels = [None] * len(raw_psfs)
            by_shape = {}
            for idx, psf in enumerate(raw_psfs):
                by_shape.setdefault(psf.shape, []).append(idx)
            for idxs in by_shape.values():
                group = torch.as_tensor(
                    np.stack([raw_psfs[i] for i in idxs])[:, None, None],
                    device=device,
                )
                padded = upsample_center_pad_kernels(
                    group, factor=factor, out_shape=kmax
                )
                for pos, idx in enumerate(idxs):
                    kernels[idx] = padded[pos]
            kft, exp_stack = build_kernel_stack(
                torch.stack(kernels), raw_exps, factor=factor,
                fft_shape=common_fft_shape,
                correct_edges=correct_exposure_edges,
            )
            exposures[name] = exp_stack
            psf_ffts[name] = kft

        return cls(
            counts=counts,
            background=background,
            exposures=exposures,
            psf_ffts=psf_ffts,
            names_all=list(datasets),
            component_factors=factors,
            fft_shape=common_fft_shape,
            component_names=list(components),
        )

    def _evaluate_batched(self, fluxes, conv_fn):
        """Batched forward: ``conv_fn(name, x)`` convolves the
        ``(N, 1, 1, H, W)`` stack ``x`` of component ``name``."""
        npred = torch.zeros_like(self.background)
        for idx, name in enumerate(self.component_names):
            x = fluxes[idx][None] * self.exposures[name]
            y = sum_pool(conv_fn(name, x), self.component_factors[idx])
            npred = npred + torch.clamp(y, min=0.0)
        npred = npred + self.background
        return torch.vmap(
            lambda n, c, s: poisson_nll(n, c, stirling=s)
        )(npred, self.counts, self.stirling)

    def evaluate(self, fluxes):
        """Per-observation mean Poisson NLL: ``(N,)`` tensor."""
        def conv_fn(name, x):
            return convolve_fft_precomputed(x, self.psf_ffts[name],
                                            self.fft_shape)

        return self._evaluate_batched(fluxes, conv_fn)

    def __call__(self, fluxes):
        """Weighted sum of per-observation losses."""
        return torch.sum(self.evaluate(fluxes) * self.weights)
