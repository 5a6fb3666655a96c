"""Predicted-counts forward models (the JAX package's ``models/npred.py``).

One `NPredModel` per (dataset, component) pair folds a flux image into
predicted counts,

    flux * exposure -> PSF convolution (precomputed rFFT) -> clip at 0,

and `NPredModels`, one per dataset, sums its components' counts and the
dataset background. These are the per-dataset models of the sequential
update strategy: each optimiser step evaluates one dataset. The joint
strategy stacks the same forward over observations instead
(``parallel/stacked.py``).

The PSF spectrum is computed once at build time, on the model's device,
at the minimal linear-convolution shape unless ``fft_shape`` is given.
``from_numpy`` divides the exposure by the PSF's response to a unit
image (the exposure edge correction). Upsampling > 1, an energy
redistribution matrix (``rmf``) and calibrations are not ported yet and
raise ``NotImplementedError``.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..ops.fft import convolve_fft_precomputed, fft_conv_shape, kernel_fft

__all__ = ["NPredModel", "NPredModels", "as_image"]


def _unported(upsampling_factor=None, rmf=None, calibration=None):
    if int(upsampling_factor or 1) != 1:
        raise NotImplementedError("upsampling_factor > 1 is not ported yet")
    if rmf is not None:
        raise NotImplementedError("rmf is not ported yet")
    if calibration is not None:
        raise NotImplementedError("calibrations are not ported yet")


def as_image(array, device):
    """A 2-D ``(H, W)`` numpy image as a float32 ``(1, 1, H, W)`` tensor.

    Band stacks (3-D, the multiband data of an ``rmf``) are not ported
    yet and raise ``NotImplementedError``.
    """
    array = np.asarray(array, np.float32)
    if array.ndim != 2:
        raise NotImplementedError(
            f"only 2-D images are ported yet, got shape {array.shape}"
        )
    return torch.as_tensor(array[np.newaxis, np.newaxis], device=device)


class NPredModel:
    """Forward model for one (dataset, component) pair.

    Parameters
    ----------
    exposure : tensor ``(1, 1, H, W)``
        Exposure on the flux grid.
    psf : tensor ``(1, 1, kh, kw)``, optional
        Point spread function, flux-normalised.
    rmf : optional
        Not ported: anything but ``None`` raises.
    upsampling_factor : int, optional
        1 (or ``None``) only.
    fft_shape : tuple of int, optional
        FFT shape of the precomputed PSF transform (default: image +
        kernel - 1 per axis).
    """

    def __init__(self, exposure, psf=None, rmf=None, upsampling_factor=None,
                 fft_shape=None):
        _unported(upsampling_factor=upsampling_factor, rmf=rmf)
        self.exposure = exposure
        self.psf = psf
        self.rmf = None
        self.upsampling_factor = upsampling_factor
        self.psf_fft = None
        if psf is not None:
            image_shape = tuple(exposure.shape[-2:])
            if fft_shape is None:
                fft_shape = fft_conv_shape(image_shape, psf.shape)
            self.psf_fft = kernel_fft(psf, image_shape, tuple(fft_shape))
        self.fft_shape = None if fft_shape is None else tuple(fft_shape)

    @classmethod
    def from_numpy(cls, exposure, psf, upsampling_factor,
                   correct_exposure_edges=True, fft_shape=None, rmf=None,
                   device=None):
        """Build from data-resolution numpy arrays on ``device`` (default
        the first CUDA card, as ``config.resolve_device``).

        With ``correct_exposure_edges`` the exposure is divided by the
        PSF's response to a unit image, which falls off at the edges.
        """
        _unported(upsampling_factor=upsampling_factor, rmf=rmf)
        device = resolve_device(device)
        exposure = as_image(exposure, device)
        psf = as_image(psf, device)
        if correct_exposure_edges:
            ones = torch.ones_like(exposure)
            shape = fft_conv_shape(ones.shape, psf.shape)
            weights = convolve_fft_precomputed(
                ones, kernel_fft(psf, ones.shape[-2:], shape), shape
            )
            exposure = exposure / weights
        return cls(exposure=exposure, psf=psf,
                   upsampling_factor=upsampling_factor, fft_shape=fft_shape)

    def __call__(self, flux):
        return self.forward(flux)

    def forward(self, flux):
        """Predicted counts of ``flux`` (differentiable)."""
        npred = flux * self.exposure
        if self.psf is not None:
            npred = convolve_fft_precomputed(npred, self.psf_fft,
                                             self.fft_shape)
        return torch.clamp(npred, min=0.0)


class NPredModels(dict):
    """One dataset's forward models, one per component, and its background.

    Parameters
    ----------
    background : tensor ``(1, 1, H, W)``
    calibration : optional
        Not ported: anything but ``None`` raises.
    values : iterable of ``(name, NPredModel)``
    """

    def __init__(self, background, calibration=None, values=()):
        super().__init__()
        _unported(calibration=calibration)
        self.background = background
        self.calibration = None
        for name, model in values:
            if name == "background":
                raise ValueError(
                    "'background' is a reserved component name (it keys "
                    "the dataset background term)"
                )
            self[name] = model

    def evaluate_per_component(self, fluxes):
        """Predicted counts per component name, and the background."""
        npreds = {name: model(flux)
                  for (name, model), flux in zip(self.items(), fluxes)}
        npreds["background"] = self.background
        return npreds

    def evaluate(self, fluxes):
        """Total predicted counts: the components' plus the background."""
        npred_total = torch.zeros_like(self.background)
        for npred in self.evaluate_per_component(fluxes).values():
            npred_total = npred_total + npred
        return npred_total

    @classmethod
    def from_dataset_numpy(cls, dataset, components, calibration=None,
                           fft_shape=None, device=None):
        """Build one dataset's models from its dict (``exposure``,
        ``psf``, ``background``; ``psf`` may be keyed by component)."""
        _unported(calibration=calibration, rmf=dataset.get("rmf"))
        device = resolve_device(device)
        values = []
        for name, component in components.items():
            psf = dataset["psf"]
            if isinstance(psf, dict):
                psf = psf[name]
            values.append((name, NPredModel.from_numpy(
                exposure=dataset["exposure"], psf=psf,
                upsampling_factor=component.upsampling_factor,
                fft_shape=fft_shape, device=device,
            )))
        background = as_image(dataset["background"], device)
        return cls(background, values=values)
