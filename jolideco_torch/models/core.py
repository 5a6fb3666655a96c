"""Flux components: the learnable latent images.

Counterpart of the JAX package's ``models/core.py``. A component stores its
flux (as a log when ``use_log_flux``) as a tensor; the trainable values
are exported with :meth:`parameters` (a plain dict the optimiser owns)
and evaluated with :meth:`flux_upsampled_from`. Frozen components export
nothing and their stored tensor is used. Only upsampling factor 1 is
ported.
"""

import numpy as np
import torch

from ..priors.core import UniformPrior

__all__ = ["FluxComponents", "SpatialFluxComponent"]


class SpatialFluxComponent:
    """Dense learnable flux image.

    Parameters
    ----------
    flux_upsampled : array or tensor ``(1, 1, H, W)``
        Initial flux in linear units.
    mask : bool array ``(1, 1, H, W)``, optional
        Pixels outside the mask carry zero flux.
    use_log_flux : bool
        Optimise the log of the flux (positivity by construction).
    upsampling_factor : int
        1 only for now.
    prior : `Prior`, optional
    frozen : bool
        Exclude from optimisation.
    device : str or torch.device, optional
        Where the flux lives (default CPU; the deconvolver moves it to
        its own device).
    """

    def __init__(self, flux_upsampled, mask=None, use_log_flux=True,
                 upsampling_factor=1, prior=None, frozen=False, device=None):
        flux = torch.as_tensor(np.asarray(flux_upsampled, np.float32),
                               device=device)
        if flux.ndim != 4:
            raise ValueError(
                f"Flux tensor must be four dimensional. Got {flux.ndim}"
            )
        if int(upsampling_factor or 1) != 1:
            raise NotImplementedError(
                "upsampling_factor > 1 is not ported yet"
            )
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask), device=flux.device)
            if tuple(mask.shape) != tuple(flux.shape):
                raise ValueError(
                    "Flux and mask need to have the same shape, got "
                    f"{tuple(flux.shape)} and {tuple(mask.shape)}"
                )
        self._flux_upsampled = torch.log(flux) if use_log_flux else flux
        self.mask = mask
        self._use_log_flux = bool(use_log_flux)
        self.upsampling_factor = 1
        self.prior = prior if prior is not None else UniformPrior()
        self.frozen = bool(frozen)

    def to(self, device):
        """Move the stored flux and mask to ``device`` (in place)."""
        self._flux_upsampled = self._flux_upsampled.to(device)
        if self.mask is not None:
            self.mask = self.mask.to(device)
        return self

    def parameters(self):
        """Trainable leaves; empty when frozen."""
        if self.frozen:
            return {}
        params = {"flux": self._flux_upsampled}
        prior_params = self.prior.parameters()
        if prior_params:
            params["prior"] = prior_params
        return params

    def set_parameters(self, params):
        """Write back trained values."""
        if params and "flux" in params:
            self._flux_upsampled = params["flux"].detach().clone()

    def flux_upsampled_from(self, params=None):
        """Upsampled flux evaluated from a params dict (differentiable)."""
        flux = (
            params["flux"]
            if params is not None and "flux" in params
            else self._flux_upsampled
        )
        if self._use_log_flux:
            flux = torch.exp(flux)
        if self.mask is not None:
            flux = flux * self.mask
        return flux

    @property
    def flux_upsampled(self):
        """Current upsampled flux."""
        return self.flux_upsampled_from()

    @property
    def flux_upsampled_numpy(self):
        """Upsampled flux as a 2-D numpy array."""
        return self.flux_upsampled.detach().cpu().numpy()[0, 0]

    @classmethod
    def from_numpy(cls, flux, mask=None, **kwargs):
        """Build from a data-resolution 2-D numpy flux image."""
        flux = np.asarray(flux, np.float32)[np.newaxis, np.newaxis]
        if mask is not None:
            mask = np.asarray(mask, bool)[np.newaxis, np.newaxis]
        return cls(flux_upsampled=flux, mask=mask, **kwargs)


class FluxComponents(dict):
    """Ordered named collection of flux components."""

    def parameters(self):
        """Trainable params: ``{name: component params}``."""
        params = {}
        for name, component in self.items():
            component_params = component.parameters()
            if component_params:
                params[name] = component_params
        return params

    def set_parameters(self, params):
        for name, component_params in (params or {}).items():
            self[name].set_parameters(component_params)

    def fluxes_from(self, params=None):
        """Tuple of upsampled fluxes evaluated from params."""
        return tuple(
            component.flux_upsampled_from(
                None if params is None else params.get(name)
            )
            for name, component in self.items()
        )

    @property
    def priors(self):
        """Priors keyed like the components."""
        return {name: component.prior for name, component in self.items()}

    def to_numpy(self):
        """Upsampled fluxes as squeezed numpy arrays."""
        return {
            name: np.squeeze(component.flux_upsampled.detach().cpu().numpy())
            for name, component in self.items()
        }
