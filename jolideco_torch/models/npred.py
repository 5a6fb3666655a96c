"""Predicted-counts forward models and per-dataset calibrations (the JAX
package's ``models/npred.py``).

One `NPredModel` per (dataset, component) pair folds a flux image into
predicted counts,

    flux * exposure -> PSF convolution (precomputed rFFT) -> sum pool
    -> energy redistribution (RMF) -> clip at 0,

and `NPredModels`, one per dataset, sums its components' counts and the
dataset background. These are the per-dataset models of the sequential
update strategy: each optimiser step evaluates one dataset. The joint
strategy stacks the same forward over observations instead
(``parallel/stacked.py``).

A component with ``upsampling_factor > 1`` is folded on its own finer
grid: ``from_numpy`` upsamples the exposure bilinearly and the PSF too,
divided by ``factor²``, and the forward sums the counts back over each
``factor²`` block. The PSF spectrum is computed once at build time, on
the model's device, at the minimal linear-convolution shape unless
``fft_shape`` is given. ``from_numpy`` divides the exposure by the PSF's
response to a unit image (the exposure edge correction).

An `NPredCalibration` per dataset shifts the flux by ``shift_xy`` data
pixels (bilinear, ``ops.image.shift_image`` at ``scale=factor``) before
the exposure, scales the background by ``exp(log_background_norm)``,
zooms the PSF by its static ``psf_scale`` and weights the dataset's
likelihood by its static ``weight``. The shift and the log norm are
trainable leaves (``parameters()``) unless frozen. `NPredCalibrations`
read and write FITS (one table row a dataset) and YAML, as the JAX
package's.

Data may be band stacks: a 3-D ``(C, H, W)`` exposure, PSF, background
or counts array is taken as ``(1, C, H, W)`` (a 2-D one as ``(1, 1, H,
W)``), a single-channel PSF broadcasts over the bands, and an ``rmf``
``(C, K)`` folds the ``C`` bands of the pooled counts into ``K``
(``einsum("bchw,ck->bkhw")``) before the clip.
"""

import copy

import numpy as np
import torch

from ..config import resolve_device
from ..ops.fft import convolve_fft_precomputed, fft_conv_shape, kernel_fft
from ..ops.image import (
    maybe_rescale_image,
    shift_image,
    sum_pool,
    upsample_bilinear,
)
from ..utils.misc import format_class_str

__all__ = ["NPredCalibration", "NPredCalibrations", "NPredModel",
           "NPredModels", "as_bchw", "as_image"]


def as_bchw(array):
    """A 2-D ``(H, W)`` image as ``(1, 1, H, W)``, a 3-D ``(C, H, W)``
    band stack as ``(1, C, H, W)`` (float32 numpy)."""
    array = np.asarray(array, np.float32)
    if array.ndim not in (2, 3):
        raise ValueError(
            f"expected a 2-D image or 3-D band stack, got shape "
            f"{array.shape}"
        )
    return array.reshape((1, -1) + array.shape[-2:])


def as_image(array, device):
    """A 2-D image or 3-D band stack (:func:`as_bchw`) as a float32
    tensor on ``device``."""
    return torch.as_tensor(as_bchw(array), device=device)


def as_rmf(rmf, device):
    """An energy redistribution matrix ``(C, K)`` as a float32 tensor on
    ``device`` (``None`` stays ``None``)."""
    if rmf is None:
        return None
    if torch.is_tensor(rmf):
        return rmf.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(rmf, np.float32), device=device)


class NPredModel:
    """Forward model for one (dataset, component) pair.

    Parameters
    ----------
    exposure : tensor ``(1, C, H, W)``
        Exposure on the (possibly upsampled) flux grid, ``C`` bands.
    psf : tensor ``(1, C, kh, kw)`` or ``(1, 1, kh, kw)``, optional
        Point spread function on the flux grid, flux-normalised (one
        channel broadcasts over the bands).
    rmf : tensor or array ``(C, K)``, optional
        Energy redistribution matrix, folded after the sum pool.
    upsampling_factor : int, optional
        Flux grid oversampling: the forward sums the counts over each
        ``factor²`` block.
    fft_shape : tuple of int, optional
        FFT shape of the precomputed PSF transform (default: image +
        kernel - 1 per axis).
    """

    def __init__(self, exposure, psf=None, rmf=None, upsampling_factor=None,
                 fft_shape=None):
        self.exposure = exposure
        self.psf = psf
        self.rmf = as_rmf(rmf, exposure.device)
        self.upsampling_factor = upsampling_factor
        self.psf_fft = None
        if psf is not None:
            image_shape = tuple(exposure.shape[-2:])
            if fft_shape is None:
                fft_shape = fft_conv_shape(image_shape, psf.shape)
            self.psf_fft = kernel_fft(psf, image_shape, tuple(fft_shape))
        self.fft_shape = None if fft_shape is None else tuple(fft_shape)
        # spectra of the PSF zoomed by a static psf_scale, made at first use
        self._scaled_psf_ffts = {}

    @classmethod
    def from_numpy(cls, exposure, psf, upsampling_factor,
                   correct_exposure_edges=True, fft_shape=None, rmf=None,
                   device=None):
        """Build from data-resolution numpy arrays on ``device`` (default
        the first CUDA card, as ``config.resolve_device``).

        With ``upsampling_factor`` the exposure and the PSF are upsampled
        bilinearly, the PSF divided by ``factor²``. With
        ``correct_exposure_edges`` the exposure is then divided by the
        PSF's response to a unit image, which falls off at the edges.
        2-D arrays are images, 3-D ones band stacks (:func:`as_bchw`).
        """
        device = resolve_device(device)
        exposure = as_image(exposure, device)
        psf = as_image(psf, device)
        if upsampling_factor:
            factor = int(upsampling_factor)
            exposure = upsample_bilinear(exposure, factor)
            psf = upsample_bilinear(psf, factor) / factor**2
        if correct_exposure_edges:
            ones = torch.ones_like(exposure)
            shape = fft_conv_shape(ones.shape, psf.shape)
            weights = convolve_fft_precomputed(
                ones, kernel_fft(psf, ones.shape[-2:], shape), shape
            )
            exposure = exposure / weights
        return cls(exposure=exposure, psf=psf, rmf=rmf,
                   upsampling_factor=upsampling_factor, fft_shape=fft_shape)

    @property
    def shape_upsampled(self):
        """Flux-grid shape."""
        return tuple(self.exposure.shape)

    @property
    def shape(self):
        """Data-grid shape."""
        shape = list(self.shape_upsampled)
        if self.upsampling_factor:
            shape[-1] //= self.upsampling_factor
            shape[-2] //= self.upsampling_factor
        return tuple(shape)

    def _psf_fft(self, psf_scale):
        """The PSF spectrum, zoomed by a static ``psf_scale`` (None or 1:
        the unzoomed one). The zoomed spectrum is computed once."""
        if psf_scale is None or float(psf_scale) == 1.0:
            return self.psf_fft
        key = float(psf_scale)
        if key not in self._scaled_psf_ffts:
            psf = maybe_rescale_image(self.psf, key)
            self._scaled_psf_ffts[key] = kernel_fft(
                psf, self.exposure.shape[-2:], self.fft_shape)
        return self._scaled_psf_ffts[key]

    def __call__(self, flux, psf_scale=None):
        return self.forward(flux, psf_scale=psf_scale)

    def forward(self, flux, psf_scale=None):
        """Predicted counts of ``flux`` (differentiable), the PSF zoomed
        by the static ``psf_scale`` when it is not None or 1."""
        npred = flux * self.exposure
        if self.psf is not None:
            npred = convolve_fft_precomputed(
                npred, self._psf_fft(psf_scale), self.fft_shape)
        if self.upsampling_factor:
            npred = sum_pool(npred, self.upsampling_factor)
        if self.rmf is not None:
            npred = torch.einsum("bchw,ck->bkhw", npred, self.rmf)
        return torch.clamp(npred, min=0.0)


class NPredModels(dict):
    """One dataset's forward models, one per component, its background and
    its calibration.

    Parameters
    ----------
    background : tensor ``(1, K, H, W)``
    calibration : `NPredCalibration`, optional
        Its shift and log norm are taken from ``calibration_params`` at
        evaluation, else from the values it holds when the models are
        built (those of a frozen calibration never change).
    values : iterable of ``(name, NPredModel)``
    """

    def __init__(self, background, calibration=None, values=()):
        super().__init__()
        self.background = background
        self.calibration = calibration
        self._static_shift = self._static_log_norm = None
        if calibration is not None:
            self._static_shift = calibration.shift_xy.detach().to(
                background.device)
            self._static_log_norm = calibration._background_norm.detach().to(
                background.device)
        for name, model in values:
            if name == "background":
                raise ValueError(
                    "'background' is a reserved component name (it keys "
                    "the dataset background term)"
                )
            self[name] = model

    def evaluate_per_component(self, fluxes, calibration_params=None):
        """Predicted counts per component name, and the background.

        ``calibration_params`` holds the trainable calibration values
        (``shift_xy``, ``log_background_norm``); a missing one is the
        stored value.
        """
        calibration = self.calibration
        params = calibration_params or {}
        npreds = {}
        for (name, model), flux in zip(self.items(), fluxes):
            if calibration is None:
                npreds[name] = model(flux)
                continue
            shift = params.get("shift_xy", self._static_shift)
            flux = shift_image(flux, shift,
                               scale=model.upsampling_factor or 1)
            npreds[name] = model(flux,
                                 psf_scale=calibration.psf_scale_value)
        if calibration is None:
            npreds["background"] = self.background
        else:
            log_norm = params.get("log_background_norm",
                                  self._static_log_norm)
            npreds["background"] = self.background * torch.exp(log_norm)
        return npreds

    def evaluate(self, fluxes, calibration_params=None):
        """Total predicted counts: the components' plus the background."""
        npred_total = torch.zeros_like(self.background)
        for npred in self.evaluate_per_component(
                fluxes, calibration_params).values():
            npred_total = npred_total + npred
        return npred_total

    @classmethod
    def from_dataset_numpy(cls, dataset, components, calibration=None,
                           fft_shape=None, device=None):
        """Build one dataset's models from its dict (``exposure``,
        ``psf``, ``background``, optionally ``rmf``; ``psf`` and ``rmf``
        may be keyed by component, and a dict ``rmf`` without a
        component's key raises ``ValueError``)."""
        device = resolve_device(device)
        values = []
        for name, component in components.items():
            psf = dataset["psf"]
            if isinstance(psf, dict):
                psf = psf[name]
            rmf = dataset.get("rmf")
            if isinstance(rmf, dict):
                if name not in rmf:
                    raise ValueError(
                        f"dict-form 'rmf' is missing component {name!r}"
                    )
                rmf = rmf[name]
            values.append((name, NPredModel.from_numpy(
                exposure=dataset["exposure"], psf=psf,
                upsampling_factor=component.upsampling_factor,
                fft_shape=fft_shape, rmf=rmf, device=device,
            )))
        background = as_image(dataset["background"], device)
        return cls(background, calibration=calibration, values=values)


class NPredCalibration:
    """Per-dataset nuisance parameters.

    Trainable: the position shift ``shift_xy`` ``(1, 2)`` (x, y in data
    pixels) and the log background norm ``(1,)``. Static: ``psf_scale``
    (a zoom of the PSF) and the likelihood ``weight``.

    Parameters
    ----------
    shift_x, shift_y : float
    background_norm : float
        Linear background norm (stored as its log).
    psf_scale : float
    frozen : bool
        No trainable leaves.
    frozen_shift : bool
        The shift is no leaf; the background norm still trains.
    weight : float
        Multiplies the dataset's Poisson term.
    device : str or torch.device, optional
        Where the values live (default CPU; the deconvolver moves them
        to its own device).
    """

    def __init__(self, shift_x=0.0, shift_y=0.0, background_norm=1.0,
                 psf_scale=1.0, frozen=False, frozen_shift=False, weight=1.0,
                 device=None):
        self.shift_xy = torch.tensor([[shift_x, shift_y]],
                                     dtype=torch.float32, device=device)
        self._background_norm = torch.tensor(
            [np.log(background_norm)], dtype=torch.float32, device=device)
        self.psf_scale_value = float(psf_scale)
        self.frozen = bool(frozen)
        self.frozen_shift = bool(frozen_shift)
        self.weight = float(weight)

    def to(self, device):
        """Move the stored values to ``device`` (in place)."""
        self.shift_xy = self.shift_xy.to(device)
        self._background_norm = self._background_norm.to(device)
        return self

    def copy(self):
        """A copy with cloned values."""
        other = copy.copy(self)
        other.shift_xy = self.shift_xy.detach().clone()
        other._background_norm = self._background_norm.detach().clone()
        return other

    def parameters(self):
        """Trainable leaves; empty when frozen; no shift when the shift
        is frozen."""
        if self.frozen:
            return {}
        params = {"log_background_norm": self._background_norm}
        if not self.frozen_shift:
            params["shift_xy"] = self.shift_xy
        return params

    def set_parameters(self, params):
        """Write back trained values."""
        if not params:
            return
        if "shift_xy" in params:
            self.shift_xy = params["shift_xy"].detach().clone()
        if "log_background_norm" in params:
            self._background_norm = (
                params["log_background_norm"].detach().clone())

    @property
    def background_norm(self):
        """Linear background norm."""
        return torch.exp(self._background_norm)

    def background_norm_from(self, params=None):
        """Background norm evaluated from a params dict."""
        value = (
            params["log_background_norm"]
            if params is not None and "log_background_norm" in params
            else self._background_norm
        )
        return torch.exp(value)

    @property
    def psf_scale(self):
        """PSF scale factor (static)."""
        return self.psf_scale_value

    def __call__(self, flux, scale, params=None):
        """``flux`` shifted by the calibration's ``shift_xy`` (from
        ``params`` when there) at ``scale`` image pixels a data pixel."""
        shift_xy = (
            params["shift_xy"]
            if params is not None and "shift_xy" in params
            else self.shift_xy
        )
        return shift_image(flux, shift_xy, scale=scale)

    def to_dict(self):
        """Calibration values with simple data types."""
        shift_xy = self.shift_xy.detach().cpu().numpy()
        return {
            "shift_x": float(shift_xy[0, 0]),
            "shift_y": float(shift_xy[0, 1]),
            "background_norm": float(np.exp(
                self._background_norm.detach().cpu().numpy())[0]),
            "psf_scale": float(self.psf_scale_value),
            "frozen": bool(self.frozen),
            "frozen_shift": bool(self.frozen_shift),
            "weight": float(self.weight),
        }

    @classmethod
    def from_dict(cls, data, device=None):
        """Build from :meth:`to_dict`'s output (on ``device``, default
        CPU)."""
        return cls(**data, device=device)

    def __str__(self):
        return format_class_str(instance=self)


class NPredCalibrations(dict):
    """Named collection of calibrations, keyed by dataset name."""

    def __init__(self, calibrations=None):
        super().__init__()
        if calibrations:
            for name, calibration in dict(calibrations).items():
                self[name] = calibration

    def parameters(self):
        """Trainable params: ``{name: calibration params}``."""
        params = {}
        for name, model in self.items():
            model_params = model.parameters()
            if model_params:
                params[name] = model_params
        return params

    def set_parameters(self, params):
        """Write back trained values per calibration."""
        for name, model_params in (params or {}).items():
            self[name].set_parameters(model_params)

    def to(self, device):
        """Move every calibration's values to ``device`` (in place)."""
        for calibration in self.values():
            calibration.to(device)
        return self

    def copy(self):
        """The calibrations' copies."""
        return NPredCalibrations({name: calibration.copy()
                                  for name, calibration in self.items()})

    def to_dict(self):
        """Every calibration's :meth:`NPredCalibration.to_dict`."""
        return {name: model.to_dict() for name, model in self.items()}

    @classmethod
    def from_dict(cls, data, device=None):
        """Build from :meth:`to_dict`'s output (on ``device``, default
        CPU)."""
        return cls({name: NPredCalibration.from_dict(data=value,
                                                     device=device)
                    for name, value in data.items()})

    @classmethod
    def read(cls, filename, format=None, device=None):
        """Read calibrations from a file (FITS or YAML; the format from
        the suffix unless given) onto ``device``, by default the first
        CUDA card."""
        from ..utils.io import IO_FORMATS_NPRED_CALIBRATIONS_READ, get_reader

        reader = get_reader(filename=filename, format=format,
                            registry=IO_FORMATS_NPRED_CALIBRATIONS_READ)
        return reader(filename, device=resolve_device(device))

    def write(self, filename, format=None, overwrite=False, **kwargs):
        """Write the calibrations to a file (FITS or YAML)."""
        from ..utils.io import IO_FORMATS_NPRED_CALIBRATIONS_WRITE, get_writer

        writer = get_writer(filename=filename, format=format,
                            registry=IO_FORMATS_NPRED_CALIBRATIONS_WRITE)
        return writer(npred_calibrations=self, filename=filename,
                      overwrite=overwrite, **kwargs)

    def __str__(self):
        return format_class_str(instance=self)
