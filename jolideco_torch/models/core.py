"""Flux components: the learnable latent images.

Counterpart of the JAX package's ``models/core.py``. A component stores its
flux (as a log when ``use_log_flux``) as a tensor; the trainable values
are exported with :meth:`parameters` (a plain dict the optimiser owns)
and evaluated with :meth:`flux_upsampled_from`. Frozen components export
nothing and their stored tensor is used. A component with
``upsampling_factor > 1`` lives on a grid that many times finer than the
data's; its flux at data resolution is the sum over each block
(:attr:`SpatialFluxComponent.flux`). A `SparseSpatialFluxComponent` is a
list of point sources whose fluxes and sub-pixel positions train, splatted
onto its grid.
"""

import copy

import numpy as np
import torch

from ..ops.image import sum_pool, upsample_bilinear
from ..priors.core import Priors, UniformPrior

__all__ = ["FluxComponents", "SparseSpatialFluxComponent",
           "SpatialFluxComponent"]


class SpatialFluxComponent:
    """Dense learnable flux image.

    Parameters
    ----------
    flux_upsampled : array or tensor ``(1, 1, H, W)``
        Initial flux in linear units.
    flux_upsampled_error : array ``(1, 1, H, W)``, optional
        A known flux error (float32, on the flux's device).
    mask : bool array ``(1, 1, H, W)``, optional
        Pixels outside the mask carry zero flux.
    use_log_flux : bool
        Optimise the log of the flux (positivity by construction).
    upsampling_factor : int
        Flux grid oversampling relative to the data grid.
    prior : `Prior`, optional
    frozen : bool
        Exclude from optimisation.
    wcs : optional
        World-coordinate object, stored and passed through as is.
    device : str or torch.device, optional
        Where the flux lives (default CPU; the deconvolver moves it to
        its own device).
    """

    is_sparse = False

    def __init__(self, flux_upsampled, flux_upsampled_error=None, mask=None,
                 use_log_flux=True, upsampling_factor=1, prior=None,
                 frozen=False, wcs=None, device=None):
        flux = torch.as_tensor(np.asarray(flux_upsampled, np.float32),
                               device=device)
        if flux.ndim != 4:
            raise ValueError(
                f"Flux tensor must be four dimensional. Got {flux.ndim}"
            )
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask), device=flux.device)
            if tuple(mask.shape) != tuple(flux.shape):
                raise ValueError(
                    "Flux and mask need to have the same shape, got "
                    f"{tuple(flux.shape)} and {tuple(mask.shape)}"
                )
        self._flux_upsampled = torch.log(flux) if use_log_flux else flux
        self._flux_upsampled_error = (
            None if flux_upsampled_error is None
            else torch.as_tensor(np.asarray(flux_upsampled_error, np.float32),
                                 device=flux.device)
        )
        self.mask = mask
        self._use_log_flux = bool(use_log_flux)
        self.upsampling_factor = int(upsampling_factor or 1)
        self.prior = prior if prior is not None else UniformPrior()
        self.frozen = bool(frozen)
        self._wcs = wcs

    @property
    def wcs(self):
        """World-coordinate object given at construction (or ``None``)."""
        return self._wcs

    @property
    def shape(self):
        """Full 4-D shape of the upsampled flux."""
        return tuple(self._flux_upsampled.shape)

    @property
    def shape_image(self):
        """Spatial shape of the upsampled flux."""
        return self.shape[-2:]

    @property
    def use_log_flux(self):
        """Whether the flux is optimised in log units."""
        return self._use_log_flux

    def to(self, device):
        """Move the stored flux, error and mask, and the prior's tensors
        (``Prior.to``), to ``device`` (in place)."""
        self._flux_upsampled = self._flux_upsampled.to(device)
        if self._flux_upsampled_error is not None:
            self._flux_upsampled_error = self._flux_upsampled_error.to(device)
        if self.mask is not None:
            self.mask = self.mask.to(device)
        self.prior.to(device)
        return self

    def copy(self):
        """A copy whose flux and error are cloned; prior and mask shared."""
        other = copy.copy(self)
        other._flux_upsampled = self._flux_upsampled.detach().clone()
        if self._flux_upsampled_error is not None:
            other._flux_upsampled_error = (
                self._flux_upsampled_error.detach().clone()
            )
        return other

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
        """Write back trained values, the prior's included."""
        if not params:
            return
        if "flux" in params:
            self._flux_upsampled = params["flux"].detach().clone()
        if "prior" in params:
            self.prior.set_parameters(params["prior"])

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
    def flux(self):
        """Flux at data resolution (flux-conserving sum pool)."""
        return sum_pool(self.flux_upsampled, self.upsampling_factor)

    @property
    def flux_numpy(self):
        """Flux at data resolution as a 2-D numpy array."""
        return self.flux.detach().cpu().numpy()[0, 0]

    @property
    def flux_upsampled_numpy(self):
        """Upsampled flux as a 2-D numpy array."""
        return self.flux_upsampled.detach().cpu().numpy()[0, 0]

    @property
    def flux_upsampled_error(self):
        """Flux error on the upsampled grid (``None`` until computed)."""
        return self._flux_upsampled_error

    @property
    def flux_upsampled_error_numpy(self):
        """Flux error as a 2-D numpy array (``None`` until computed)."""
        if self._flux_upsampled_error is None:
            return None
        return self._flux_upsampled_error.detach().cpu().numpy()[0, 0]

    @classmethod
    def from_numpy(cls, flux, mask=None, **kwargs):
        """Build from a data-resolution 2-D numpy flux image.

        The flux (and the mask, kept where its upsampled value exceeds
        0.5) are upsampled bilinearly by ``upsampling_factor``.
        """
        factor = int(kwargs.get("upsampling_factor") or 1)
        flux = torch.as_tensor(
            np.asarray(flux, np.float32)[np.newaxis, np.newaxis])
        flux = upsample_bilinear(flux, factor).numpy()
        if mask is not None:
            mask = torch.as_tensor(
                np.asarray(mask, np.float32)[np.newaxis, np.newaxis])
            mask = (upsample_bilinear(mask, factor) > 0.5).numpy()
        return cls(flux_upsampled=flux, mask=mask, **kwargs)

    @classmethod
    def from_flux_init_datasets(cls, datasets, **kwargs):
        """Initial flux from the mean of ``counts / exposure -
        background`` over ``datasets`` (a sequence of dataset dicts),
        clipped below to its smallest positive value when the flux is a
        log (so that the log is finite)."""
        fluxes = [dataset["counts"] / dataset["exposure"]
                  - dataset["background"] for dataset in datasets]
        flux_init = np.nanmean(fluxes, axis=0)
        if kwargs.get("use_log_flux", True):
            positive = flux_init[flux_init > 0]
            floor = positive.min() if positive.size else 1.0
            flux_init = np.clip(flux_init, floor, None)
        return cls.from_numpy(flux=flux_init, **kwargs)


class SparseSpatialFluxComponent:
    """Point sources at trainable sub-pixel positions, splatted onto an
    image grid.

    Each source's flux goes to the pixels around ``(x_pos, y_pos)`` with
    the separable triangular weights ``max(0, 1 - |x - x_pos|) max(0, 1 -
    |y - y_pos|)`` (bilinear, centroid preserving):
    ``einsum("n,nh,nw->hw")``, a torch product, as the JAX package
    computes it outside any kernel. The source fluxes (as logs when
    ``use_log_flux``) and both positions are trainable leaves.

    Parameters
    ----------
    flux : array or tensor ``(n,)``
        Source fluxes in linear units.
    x_pos, y_pos : array or tensor ``(n,)``
        Source positions in image pixels (x the column, y the row).
    shape : tuple of int
        The image grid ``(H, W)``.
    use_log_flux : bool
    prior : `Prior`, optional
        Prior on the splatted image (default `UniformPrior`).
    frozen : bool
    wcs : optional
        World-coordinate object, stored and passed through as is.
    device : str or torch.device, optional
        Where the values live (default CPU; the deconvolver moves them
        to its own device).

    ``to_dict``, ``from_dict``, ``read``, ``write``, ``plot``,
    ``from_sky_coord`` and ``sky_coord`` wait for the port's I/O and
    world coordinates (``utils/io``, ``utils/wcs``) and raise
    ``NotImplementedError``.
    """

    is_sparse = True
    upsampling_factor = 1

    def __init__(self, flux, x_pos, y_pos, shape, use_log_flux=True,
                 prior=None, frozen=False, wcs=None, device=None):
        def vector(values):
            if torch.is_tensor(values):
                return values.detach().to(device=device,
                                          dtype=torch.float32).clone()
            return torch.as_tensor(np.array(values, np.float32),
                                   device=device)

        flux = vector(flux)
        self._flux = torch.log(flux) if use_log_flux else flux
        self.x_pos = vector(x_pos)
        self.y_pos = vector(y_pos)
        self._shape = tuple(int(s) for s in shape)
        self._use_log_flux = bool(use_log_flux)
        self.prior = prior if prior is not None else UniformPrior()
        self.frozen = bool(frozen)
        self._wcs = wcs
        self._flux_upsampled_error = None

    @property
    def wcs(self):
        """World-coordinate object given at construction (or ``None``)."""
        return self._wcs

    @property
    def shape(self):
        """Full 4-D shape of the splatted image."""
        return (1, 1) + self._shape

    @property
    def shape_image(self):
        """Spatial shape of the splatted image."""
        return self._shape

    @property
    def use_log_flux(self):
        """Whether the source fluxes are optimised in log units."""
        return self._use_log_flux

    def to(self, device):
        """Move the leaves, the error and the prior's tensors to
        ``device`` (in place)."""
        self._flux = self._flux.to(device)
        self.x_pos = self.x_pos.to(device)
        self.y_pos = self.y_pos.to(device)
        if self._flux_upsampled_error is not None:
            self._flux_upsampled_error = self._flux_upsampled_error.to(device)
        self.prior.to(device)
        return self

    def copy(self):
        """A copy whose leaves are cloned; the prior shared."""
        other = copy.copy(self)
        other._flux = self._flux.detach().clone()
        other.x_pos = self.x_pos.detach().clone()
        other.y_pos = self.y_pos.detach().clone()
        if self._flux_upsampled_error is not None:
            other._flux_upsampled_error = (
                self._flux_upsampled_error.detach().clone())
        return other

    def parameters(self):
        """Trainable leaves (``flux``, ``x_pos``, ``y_pos`` and the
        prior's); empty when frozen."""
        if self.frozen:
            return {}
        params = {"flux": self._flux, "x_pos": self.x_pos,
                  "y_pos": self.y_pos}
        prior_params = self.prior.parameters()
        if prior_params:
            params["prior"] = prior_params
        return params

    def set_parameters(self, params):
        """Write back trained values, the prior's included."""
        if not params:
            return
        for key, attr in (("flux", "_flux"), ("x_pos", "x_pos"),
                          ("y_pos", "y_pos")):
            if key in params:
                setattr(self, attr, params[key].detach().clone())
        if "prior" in params:
            self.prior.set_parameters(params["prior"])

    def flux_upsampled_from(self, params=None):
        """The sources splatted onto the grid, ``(1, 1, H, W)``, from a
        params dict (differentiable in the fluxes and positions)."""
        if params is not None and "flux" in params:
            flux, x_pos, y_pos = (params["flux"], params["x_pos"],
                                  params["y_pos"])
        else:
            flux, x_pos, y_pos = self._flux, self.x_pos, self.y_pos
        if self._use_log_flux:
            flux = torch.exp(flux)
        h, w = self._shape
        xs = torch.arange(w, dtype=flux.dtype, device=flux.device)
        ys = torch.arange(h, dtype=flux.dtype, device=flux.device)
        zero = torch.zeros((), dtype=flux.dtype, device=flux.device)

        def triangle(grid, pos):
            # the JAX package's derivatives at the kinks: |d| takes slope
            # 1 at d = 0, and the maximum splits the gradient of a tie
            d = grid[None, :] - pos[:, None]
            return torch.maximum(zero, 1.0 - torch.where(d >= 0, d, -d))

        return torch.einsum("n,nh,nw->hw", flux, triangle(ys, y_pos),
                            triangle(xs, x_pos))[None, None]

    @property
    def flux(self):
        """The splatted image (no oversampling for sparse components)."""
        return self.flux_upsampled_from()

    @property
    def flux_upsampled(self):
        """Alias of :attr:`flux`."""
        return self.flux

    @property
    def flux_numpy(self):
        """The splatted image as a 2-D numpy array."""
        return self.flux.detach().cpu().numpy()[0, 0]

    @property
    def flux_upsampled_numpy(self):
        """Alias of :attr:`flux_numpy`."""
        return self.flux_numpy

    @property
    def flux_upsampled_error(self):
        """Flux error of the splatted image (``None`` until computed)."""
        return self._flux_upsampled_error

    @property
    def flux_upsampled_error_numpy(self):
        """Flux error as a 2-D numpy array (``None`` until computed)."""
        if self._flux_upsampled_error is None:
            return None
        return self._flux_upsampled_error.detach().cpu().numpy()[0, 0]

    @property
    def x_pos_numpy(self):
        """x positions as numpy."""
        return self.x_pos.detach().cpu().numpy()

    @property
    def y_pos_numpy(self):
        """y positions as numpy."""
        return self.y_pos.detach().cpu().numpy()

    @property
    def flux_values_numpy(self):
        """Per-source linear fluxes as numpy."""
        flux = self._flux.detach()
        if self._use_log_flux:
            flux = torch.exp(flux)
        return flux.cpu().numpy()

    @classmethod
    def from_numpy(cls, flux, x_pos, y_pos, **kwargs):
        """Build from numpy source lists (scalars become length-1 lists)."""
        return cls(flux=np.atleast_1d(np.asarray(flux, np.float32)),
                   x_pos=np.atleast_1d(np.asarray(x_pos, np.float32)),
                   y_pos=np.atleast_1d(np.asarray(y_pos, np.float32)),
                   **kwargs)

    @classmethod
    def from_sky_coord(cls, skycoord, wcs, **kwargs):
        """Not ported (M16, ``utils/wcs``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("from_sky_coord"))

    @property
    def sky_coord(self):
        """Not ported (M16, ``utils/wcs``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("sky_coord"))

    def to_dict(self, **kwargs):
        """Not ported (M16, ``utils/io``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("to_dict"))

    @classmethod
    def from_dict(cls, data):
        """Not ported (M16, ``utils/io``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("from_dict"))

    @classmethod
    def read(cls, filename, format=None):
        """Not ported (M16, ``utils/io``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("read"))

    def write(self, filename, format=None, overwrite=False, **kwargs):
        """Not ported (M16, ``utils/io``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("write"))

    def plot(self, ax=None, kwargs_norm=None, **kwargs):
        """Not ported (M16, ``utils/plot``): raises ``NotImplementedError``."""
        raise NotImplementedError(_SPARSE_M16.format("plot"))


_SPARSE_M16 = ("SparseSpatialFluxComponent.{} waits for M16: the port's "
               "I/O, world coordinates and plotting are not ported yet")


class FluxComponents(dict):
    """Ordered named collection of flux components.

    Parameters
    ----------
    components : dict, optional
        Components keyed by name.
    """

    def __init__(self, components=None):
        super().__init__()
        for name, component in dict(components or {}).items():
            self[name] = component

    def parameters(self):
        """Trainable params: ``{name: component params}``."""
        params = {}
        for name, component in self.items():
            component_params = component.parameters()
            if component_params:
                params[name] = component_params
        return params

    def copy(self):
        """The components' copies (see `SpatialFluxComponent.copy`)."""
        return FluxComponents({name: component.copy()
                               for name, component in self.items()})

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

    def to_flux_tuple(self):
        """Current fluxes as a tuple."""
        return self.fluxes_from()

    def set_flux_errors(self, flux_errors):
        """Attach flux errors ``{name: tensor}`` to their components."""
        for name, flux_error in flux_errors.items():
            self[name]._flux_upsampled_error = flux_error.detach()

    @property
    def priors(self):
        """Priors keyed like the components."""
        return Priors((name, component.prior)
                      for name, component in self.items())

    @property
    def wcs(self):
        """The first component's world-coordinate object that is not
        ``None`` (``None`` without one)."""
        for component in self.values():
            if component.wcs is not None:
                return component.wcs
        return None

    @property
    def flux_upsampled_total(self):
        """Sum of the upsampled fluxes (a tensor)."""
        values = list(self.values())
        flux = torch.zeros_like(values[0].flux_upsampled)
        for component in values:
            flux = flux + component.flux_upsampled
        return flux

    @property
    def fluxes_numpy(self):
        """Data-resolution fluxes as a dict of 2-D numpy arrays."""
        return {name: comp.flux_numpy for name, comp in self.items()}

    @property
    def fluxes_upsampled_numpy(self):
        """Upsampled fluxes as a dict of 2-D numpy arrays."""
        return self.to_numpy()

    @property
    def flux_upsampled_total_numpy(self):
        """Summed upsampled flux as a 2-D numpy array."""
        return np.sum(list(self.fluxes_upsampled_numpy.values()), axis=0)

    @property
    def flux_total_numpy(self):
        """Summed data-resolution flux as a 2-D numpy array."""
        return np.sum(list(self.fluxes_numpy.values()), axis=0)

    def to_numpy(self):
        """Upsampled fluxes as squeezed numpy arrays."""
        return {
            name: np.squeeze(component.flux_upsampled.detach().cpu().numpy())
            for name, component in self.items()
        }
