"""Prior base class and the parametric priors (the JAX package's
``priors/core.py``).

A prior's ``__call__(flux, params=None, generator=None, shifts=None)``
returns the scalar log-prior of one flux component. Its random draws
(cycle spins, subpixel offsets, jitters, patch subsets) are made ahead
of an evaluation by ``draw_shifts(generator, shape)`` and passed back
as ``shifts=``: the training loop draws them from its own CPU
generator, tests pass the draws of the JAX package's keys. A call
without ``shifts`` draws them first, from ``generator`` or else from
the prior's own, seeded at construction; nothing random is drawn
while a prior evaluates. A prior's tensors (kernels, images, tables,
level weights) move with ``to(device)``, which ``SpatialFluxComponent.to``
calls; what it derives from them (a kernel's spectrum at a flux shape)
is made once per device and kept.
"""

import numpy as np
import torch

from ..ops.fft import convolve_fft, fft_conv_shape, kernel_fft
from ..ops.image import cycle_spin_subpixel, draw_subpixel
from ..utils.kernels import gaussian_kernel_2d
from ..utils.misc import format_class_str

__all__ = [
    "Prior",
    "Priors",
    "UniformPrior",
    "ImagePrior",
    "SmoothnessPrior",
    "InverseGammaPrior",
    "ExponentialPrior",
]


class Prior:
    """Prior base class."""

    def __init__(self, seed=0):
        self.generator = torch.Generator().manual_seed(int(seed))
        self._device_constants = {}

    def _constant(self, key, device, build):
        """``build()`` made once per ``(key, device)`` and kept."""
        full_key = (key, str(device))
        if full_key not in self._device_constants:
            self._device_constants[full_key] = build()
        return self._device_constants[full_key]

    def parameters(self):
        """Trainable hyper-parameters (dict of tensors); default none."""
        return {}

    def set_parameters(self, params):
        """Write back trained hyper-parameters."""

    def to(self, device):
        """Move the prior's tensors to ``device`` (in place)."""
        return self

    def draw_shifts(self, generator=None, shape=None):
        """The random draws of one evaluation at a flux of ``shape``,
        made ahead of it, to pass back as ``shifts=``; ``None`` for a
        prior that draws none."""
        return None

    def second_order_ok(self, flux_shape):
        """Whether the log-prior has a second derivative at this shape
        under the current dispatch (default: yes)."""
        return True

    def to_dict(self):
        """Serialise; the registry name goes in ``type``."""
        from . import PRIOR_REGISTRY

        data = {}
        for name, cls in PRIOR_REGISTRY.items():
            if isinstance(self, cls):
                data["type"] = name
                break
        return data

    @classmethod
    def from_dict(cls, data):
        """Registry-dispatched deserialisation."""
        from . import PRIOR_REGISTRY

        kwargs = data.copy()
        if "type" in data:
            cls = PRIOR_REGISTRY[kwargs.pop("type")]
            return cls.from_dict(data=kwargs)
        return cls(**kwargs)

    def __str__(self):
        return format_class_str(instance=self)


class Priors(dict):
    """Named collection of priors (component name -> prior)."""

    def __call__(self, fluxes, params=None, generator=None, shifts=None):
        """Sum of the priors on the matching flux tuple; ``params`` and
        ``shifts`` keyed by name."""
        value = 0
        for flux, (name, prior) in zip(fluxes, self.items()):
            value = value + prior(
                flux, params=None if params is None else params.get(name),
                generator=generator,
                shifts=None if shifts is None else shifts.get(name))
        return value


class UniformPrior(Prior):
    """Flat prior: log-prior identically zero."""

    def __init__(self):
        super().__init__()

    def __call__(self, flux, params=None, generator=None, shifts=None):
        return torch.zeros((), dtype=flux.dtype, device=flux.device)


class _SubpixelPrior(Prior):
    """A prior whose only draw is an optional subpixel spin."""

    def draw_shifts(self, generator=None, shape=None):
        """The subpixel offsets ``(x0, y0)`` (``None`` without
        ``cycle_spin_subpix``)."""
        if not self.cycle_spin_subpix:
            return None
        return draw_subpixel(self.generator if generator is None
                             else generator)

    def _spin(self, flux, generator, shifts):
        if not self.cycle_spin_subpix:
            return flux
        if shifts is None:
            shifts = self.draw_shifts(generator, tuple(flux.shape))
        return cycle_spin_subpixel(flux, *shifts)


class InverseGammaPrior(_SubpixelPrior):
    """Sparsity prior: a product of inverse-Gamma distributions,
    ``mean(-beta/x - (alpha+1) log x) + alpha log beta - lgamma(alpha)``.
    ``alpha`` and ``beta`` are numbers read on the host; their properties
    give them as ``(1,)`` float32 tensors, as in the JAX package.
    """

    def __init__(self, alpha=10, beta=3 / 2, cycle_spin_subpix=False, seed=0):
        super().__init__(seed=seed)
        self._alpha = float(np.float32(alpha))
        self._beta = float(np.float32(beta))
        self.cycle_spin_subpix = bool(cycle_spin_subpix)

    @property
    def alpha(self):
        return torch.tensor([self._alpha], dtype=torch.float32)

    @property
    def beta(self):
        return torch.tensor([self._beta], dtype=torch.float32)

    @property
    def mean(self):
        """Distribution mean."""
        return self.beta / (self.alpha - 1)

    @property
    def mode(self):
        """Distribution mode."""
        return self.beta / (self.alpha + 1)

    @property
    def log_constant_term(self):
        """alpha log beta - lgamma(alpha) (float32)."""
        value = self.alpha * torch.log(self.beta) - torch.lgamma(self.alpha)
        return value.reshape(())

    def __call__(self, flux, params=None, generator=None, shifts=None):
        flux = self._spin(flux, generator, shifts)
        value = -self._beta / flux + (-self._alpha - 1) * torch.log(flux)
        return torch.sum(value) / flux.numel() + float(self.log_constant_term)

    def to_dict(self):
        data = super().to_dict()
        data["alpha"] = self._alpha
        data["beta"] = self._beta
        data["cycle_spin_subpix"] = bool(self.cycle_spin_subpix)
        return data


class ExponentialPrior(_SubpixelPrior):
    """Sparsity prior: a product of exponential distributions,
    ``mean(-alpha x) + log alpha`` (``alpha`` as in
    `InverseGammaPrior`)."""

    def __init__(self, alpha=10, cycle_spin_subpix=False, seed=0):
        super().__init__(seed=seed)
        self._alpha = float(np.float32(alpha))
        self.cycle_spin_subpix = bool(cycle_spin_subpix)

    @property
    def alpha(self):
        return torch.tensor([self._alpha], dtype=torch.float32)

    @property
    def mean(self):
        """Distribution mean."""
        return 1 / self.alpha

    @property
    def mode(self):
        """Distribution mode."""
        return 0

    @property
    def log_constant_term(self):
        """log alpha (float32)."""
        return torch.log(self.alpha).reshape(())

    def __call__(self, flux, params=None, generator=None, shifts=None):
        flux = self._spin(flux, generator, shifts)
        value = -self._alpha * flux
        return torch.sum(value) / flux.numel() + float(self.log_constant_term)

    def to_dict(self):
        data = super().to_dict()
        data["alpha"] = self._alpha
        data["cycle_spin_subpix"] = bool(self.cycle_spin_subpix)
        return data


class ImagePrior(Prior):
    """Gaussian prior towards a given flux image:
    ``-0.5 mean(((flux - flux_prior) / flux_prior_error)**2)``."""

    def __init__(self, flux_prior, flux_prior_error=None):
        super().__init__()
        self.flux_prior = torch.as_tensor(np.array(flux_prior, np.float32))
        if flux_prior_error is None:
            flux_prior_error = np.ones(self.flux_prior.shape, np.float32)
        self.flux_prior_error = torch.as_tensor(
            np.array(flux_prior_error, np.float32))

    def to(self, device):
        self.flux_prior = self.flux_prior.to(device)
        self.flux_prior_error = self.flux_prior_error.to(device)
        return self

    def __call__(self, flux, params=None, generator=None, shifts=None):
        chi2 = ((flux - self.flux_prior.to(flux.device))
                / self.flux_prior_error.to(flux.device)) ** 2
        return -0.5 * torch.sum(chi2) / flux.numel()

    def to_dict(self):
        raise NotImplementedError


class SmoothnessPrior(Prior):
    """Smoothness prior ``-sum(flux * (K * flux))`` with a Gaussian
    kernel ``K`` of the given width; the kernel's spectrum is made once
    per device and flux shape."""

    def __init__(self, width=2):
        super().__init__()
        self.width = float(width)
        self.kernel = torch.as_tensor(
            gaussian_kernel_2d(width)[None, None].astype(np.float32))

    def to(self, device):
        self.kernel = self.kernel.to(device)
        return self

    def __call__(self, flux, params=None, generator=None, shifts=None):
        kft = self._constant(
            ("kft", tuple(flux.shape)), flux.device,
            lambda: kernel_fft(self.kernel.to(flux.device), flux.shape[-2:],
                               fft_conv_shape(flux.shape, self.kernel.shape)))
        smooth = convolve_fft(flux, self.kernel, kft=kft)
        return -torch.sum(flux * smooth)

    def to_dict(self):
        data = super().to_dict()
        data["width"] = float(self.width)
        return data

    @classmethod
    def from_dict(cls, data):
        return cls(**{k: v for k, v in data.items() if k != "type"})
