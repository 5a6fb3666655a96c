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

Components serialise as the JAX package's do (``to_dict``, ``from_dict``,
``read``, ``write``; ``utils/io``): a file one package writes reads in the
other. Reading takes ``device=``, by default the first CUDA card (and an
error without one, as ``config.resolve_device(None)``).
"""

import copy
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device
from ..ops.image import sum_pool, upsample_bilinear
from ..priors.core import Prior, Priors, UniformPrior
from ..utils.misc import format_class_str

__all__ = ["FluxComponents", "SparseSpatialFluxComponent",
           "SpatialFluxComponent"]


def parse_flux_array(value, cls, device):
    """A flux given as a file name (read on ``device``), an array or a
    nested list, as a ``(1, 1, H, W)`` numpy array (a 2-D image, the
    ``to_dict`` payload or a YAML list, gains the two leading axes)."""
    if isinstance(value, (str, Path)):
        flux = cls.read(Path(value), device=device).flux_upsampled
        return flux.detach().cpu().numpy()
    flux = np.asarray(value, np.float32)
    if flux.ndim == 2:
        flux = flux[np.newaxis, np.newaxis]
    return flux


def _wcs_from(data):
    """A serialised WCS (a dict of FITS cards) as a `SimpleWCS`; any
    other object as it is."""
    if isinstance(data, dict):
        from ..utils.wcs import wcs_from_header

        return wcs_from_header(data)
    return data


def _plot_image(ax, flux, kwargs_norm, **kwargs):
    """``imshow`` of a 2-D flux under an asinh stretch, with a colour
    bar (matplotlib imported here)."""
    import matplotlib.pyplot as plt

    from ..utils.plot import add_cbar, simple_norm

    if ax is None:
        ax = plt.gca()
    kwargs_norm = kwargs_norm or {"vmin": 0, "stretch": "asinh",
                                  "asinh_a": 0.01}
    kwargs.setdefault("norm", simple_norm(flux, **kwargs_norm))
    kwargs.setdefault("interpolation", "None")
    im = ax.imshow(flux, origin="lower", **kwargs)
    add_cbar(im=im, ax=ax, fig=ax.figure)
    return ax


def _reader(registry, filename, format, device):
    from ..utils.io import get_reader

    reader = get_reader(filename=filename, format=format, registry=registry)
    return reader(filename, device=resolve_device(device))


def _writer(registry, filename, format):
    from ..utils.io import get_writer

    return get_writer(filename=filename, format=format, registry=registry)


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

    def to_dict(self, include_data=None):
        """Configuration with simple data types; with ``include_data=
        "numpy"`` also the flux, its error and the mask as 2-D numpy
        arrays."""
        from ..utils.wcs import wcs_to_header

        data = {}
        data["use_log_flux"] = bool(self.use_log_flux)
        data["upsampling_factor"] = int(self.upsampling_factor)
        data["frozen"] = bool(self.frozen)
        data["prior"] = self.prior.to_dict()
        if self._wcs is not None:
            data["wcs"] = wcs_to_header(self._wcs)

        if include_data == "numpy":
            data["flux_upsampled"] = self.flux_upsampled_numpy
            if self._flux_upsampled_error is not None:
                data["flux_upsampled_error"] = self.flux_upsampled_error_numpy
            if self.mask is not None:
                data["mask"] = self.mask.detach().cpu().numpy()[0, 0]
        return data

    @classmethod
    def from_dict(cls, data, device=None):
        """Build from :meth:`to_dict`'s output (``flux_upsampled`` an
        array, a nested list or the name of a file to read) on
        ``device``."""
        device = resolve_device(device)
        kwargs = data.copy()
        prior_data = kwargs.pop("prior", None)
        if prior_data:
            kwargs["prior"] = Prior.from_dict(data=prior_data)
        kwargs["wcs"] = _wcs_from(kwargs.get("wcs"))
        kwargs["flux_upsampled"] = parse_flux_array(
            kwargs["flux_upsampled"], cls, device)
        if kwargs.get("flux_upsampled_error") is not None:
            kwargs["flux_upsampled_error"] = parse_flux_array(
                kwargs["flux_upsampled_error"], cls, device)
        if kwargs.get("mask") is not None:
            kwargs["mask"] = np.asarray(kwargs["mask"]).astype(bool)[
                np.newaxis, np.newaxis]
        return cls(device=device, **kwargs).to(device)

    def __str__(self):
        return format_class_str(instance=self)

    @classmethod
    def read(cls, filename, format=None, device=None):
        """Read a flux component from a file (FITS, YAML or ASDF; the
        format from the suffix unless given) onto ``device``."""
        from ..utils.io import IO_FORMATS_FLUX_COMPONENT_READ

        return _reader(IO_FORMATS_FLUX_COMPONENT_READ, filename, format,
                       device)

    def write(self, filename, format=None, overwrite=False, **kwargs):
        """Write the flux component to a file (FITS, YAML or ASDF)."""
        from ..utils.io import IO_FORMATS_FLUX_COMPONENT_WRITE

        writer = _writer(IO_FORMATS_FLUX_COMPONENT_WRITE, filename, format)
        return writer(flux_component=self, filename=filename,
                      overwrite=overwrite, **kwargs)

    def plot(self, ax=None, kwargs_norm=None, **kwargs):
        """Plot the upsampled flux (matplotlib)."""
        return _plot_image(ax, self.flux_upsampled_numpy, kwargs_norm,
                           **kwargs)


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
        """Build from sky coordinates: ``skycoord.to_pixel(wcs=wcs)``
        gives ``(x, y)`` (an astropy ``SkyCoord``, or any object with
        that method)."""
        x_pos, y_pos = skycoord.to_pixel(wcs=wcs)
        return cls.from_numpy(x_pos=x_pos, y_pos=y_pos, wcs=wcs, **kwargs)

    @property
    def sky_coord(self):
        """The positions as an astropy ``SkyCoord`` (needs astropy)."""
        from astropy.coordinates import SkyCoord

        return SkyCoord.from_pixel(xp=self.x_pos_numpy, yp=self.y_pos_numpy,
                                   wcs=self.wcs)

    def to_dict(self, **kwargs):
        """Configuration and source lists (numpy arrays)."""
        data = {}
        data["use_log_flux"] = bool(self.use_log_flux)
        data["frozen"] = bool(self.frozen)
        data["shape"] = self.shape
        data["flux"] = self.flux_values_numpy
        data["x_pos"] = self.x_pos_numpy
        data["y_pos"] = self.y_pos_numpy
        data["prior"] = self.prior.to_dict()
        if self._wcs is not None:
            from ..utils.wcs import wcs_to_header

            data["wcs"] = wcs_to_header(self._wcs)
        return data

    @classmethod
    def from_dict(cls, data, device=None):
        """Build from :meth:`to_dict`'s output on ``device``."""
        device = resolve_device(device)
        kwargs = data.copy()
        prior_data = kwargs.pop("prior", None)
        if prior_data:
            kwargs["prior"] = Prior.from_dict(data=prior_data)
        kwargs["wcs"] = _wcs_from(kwargs.get("wcs"))
        kwargs["shape"] = tuple(kwargs.pop("shape"))[-2:]
        return cls(
            flux=np.atleast_1d(np.asarray(kwargs.pop("flux"), np.float32)),
            x_pos=np.atleast_1d(np.asarray(kwargs.pop("x_pos"), np.float32)),
            y_pos=np.atleast_1d(np.asarray(kwargs.pop("y_pos"), np.float32)),
            device=device, **kwargs,
        ).to(device)

    def __str__(self):
        return format_class_str(instance=self)

    @classmethod
    def read(cls, filename, format=None, device=None):
        """Read a sparse component from a FITS file onto ``device``."""
        from ..utils.io import IO_FORMATS_SPARSE_FLUX_COMPONENT_READ

        return _reader(IO_FORMATS_SPARSE_FLUX_COMPONENT_READ, filename,
                       format, device)

    def write(self, filename, format=None, overwrite=False, **kwargs):
        """Write the sparse component to a FITS file (a binary table)."""
        from ..utils.io import IO_FORMATS_SPARSE_FLUX_COMPONENT_WRITE

        writer = _writer(IO_FORMATS_SPARSE_FLUX_COMPONENT_WRITE, filename,
                         format)
        return writer(flux_component=self, filename=filename,
                      overwrite=overwrite, **kwargs)

    def plot(self, ax=None, kwargs_norm=None, **kwargs):
        """Plot the splatted flux (matplotlib)."""
        return _plot_image(ax, self.flux_numpy, kwargs_norm, **kwargs)


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

    def to_dict(self, include_data=None):
        """Every component's ``to_dict``, keyed by name."""
        return {name: component.to_dict(include_data=include_data)
                for name, component in self.items()}

    @classmethod
    def from_dict(cls, data, device=None):
        """Build from :meth:`to_dict`'s output on ``device`` (an entry with
        ``x_pos`` is a sparse component)."""
        device = resolve_device(device)
        components = cls()
        for name, component_data in data.items():
            kind = (SparseSpatialFluxComponent if "x_pos" in component_data
                    else SpatialFluxComponent)
            components[name] = kind.from_dict(component_data, device=device)
        return components

    @classmethod
    def read(cls, filename, format=None, device=None):
        """Read flux components from a file (FITS, ASDF or YAML) onto
        ``device``."""
        from ..utils.io import IO_FORMATS_FLUX_COMPONENTS_READ

        return _reader(IO_FORMATS_FLUX_COMPONENTS_READ, filename, format,
                       device)

    def write(self, filename, overwrite=False, format=None, **kwargs):
        """Write the flux components to a file (FITS, ASDF or YAML)."""
        from ..utils.io import IO_FORMATS_FLUX_COMPONENTS_WRITE

        writer = _writer(IO_FORMATS_FLUX_COMPONENTS_WRITE, filename, format)
        return writer(flux_components=self, filename=filename,
                      overwrite=overwrite, **kwargs)

    def plot(self, figsize=None, kwargs_norm=None, **kwargs):
        """Plot the total flux and each component (matplotlib)."""
        import matplotlib.pyplot as plt

        from ..utils.plot import add_cbar, simple_norm

        ncols = len(self) + 1
        if figsize is None:
            figsize = (ncols * 5, 5)
        fig, axes = plt.subplots(nrows=1, ncols=ncols, figsize=figsize)
        axes = np.atleast_1d(axes)

        kwargs_norm = kwargs_norm or {"vmin": 0, "stretch": "asinh",
                                      "asinh_a": 0.01}
        flux = self.flux_total_numpy
        norm = simple_norm(flux, **kwargs_norm)
        im = axes[0].imshow(flux, origin="lower", norm=norm, **kwargs)
        axes[0].set_title("Total")

        for ax, name in zip(axes[1:], self.fluxes_numpy):
            self[name].plot(ax=ax, kwargs_norm=kwargs_norm, **kwargs)
            ax.set_title(name.title())

        add_cbar(im=im, ax=axes[-1], fig=fig)
        return axes

    def __str__(self):
        return format_class_str(instance=self)
