"""Stacked multi-observation Poisson loss.

Counterpart of the JAX package's ``parallel/stacked.py``. Observations of one
image shape stack on a leading ``obs`` axis; PSFs of different sizes are
center-padded to a common size and their spectra precomputed at one
common FFT shape, so the forward of every observation is one batched
computation:

    flux -> calibration shift -> * exposure -> PSF convolution -> sum pool
    -> energy redistribution (RMF) -> clip -> + background * norm
    -> Poisson NLL with the precomputed Stirling term

A component with ``upsampling_factor > 1`` is folded on its finer grid:
its exposures are upsampled bilinearly and its PSFs too (divided by
``factor²``) at build time, and the counts summed back over each
``factor²`` block. Calibrations (``models/npred.py``) shift each
observation's flux by its ``shift_xy`` at ``scale=factor`` and scale its
background by ``exp(log_background_norm)``; their static ``psf_scale``
zooms are baked into the precomputed spectra, and their static weights
multiply the per-observation terms.

Observations may be band stacks: their arrays stack to ``(N, 1, C, H,
W)`` (``C = 1`` for 2-D images), a PSF is 2-D or a ``(C, kh, kw)`` stack
(one channel broadcasts over the bands), and datasets that carry an
``rmf`` ``(C, K)`` (an array, or a dict keyed by component) stack it to
``(N, C, K)`` per component, folded after the sum pool and before the
clip on every evaluate path. Data that cannot stack (image shapes or
band counts that differ, an ``rmf`` on some datasets only, components
without a common FFT shape) raises ``ValueError``, on which the joint
strategy falls back to per-dataset models; data that neither path can
take (an RMF whose channels do not match the data) raises
`DataValidationError`.

The convolution backends (``conv_mode``), all of the JAX package's:

- ``"fft"``: a batched per-observation ``rfft2`` (cuFFT on the card);
- ``"pfft"``: the pair-packed matrix DFT (``ops/pallas_fft.py``): even
  and odd observations go pairwise through one complex transform, at a
  size that is a multiple of 128, with the images padded to multiples of
  128, the bands of each pair flattened into the kernels' batch;
- ``"ct"``: the pair-packed Cooley-Tukey matrix DFT (``ops/ct_conv.py``)
  at ``ct_conv_shape`` of the linear convolution's size, its pair
  spectra and each observation's own spectra built at build time;
- ``"mxu"``: the per-observation 4-step matrix DFT (``ops/fft_mxu.py``)
  at ``mxu_conv_shape``;
- ``"direct"``: one grouped ``conv2d`` over the PSFs, padded to a common
  odd size with their centre pixel ``(k - 1) // 2`` in the middle and
  flipped (``conv2d``, like ``lax.conv``, correlates).

Under ``"pfft"`` and ``"ct"`` an odd last observation takes the ``rfft2``
path, and ``"ct"`` convolves each observation alone where there are no
pairs (one observation, or a rank's block that splits them).

On a mesh (``parallel.mesh``) a rank keeps a copy of the loss with its
contiguous block of the observations (:meth:`StackedPoissonLoss.shard`):
``evaluate`` then gives this rank's per-observation losses and
:meth:`StackedPoissonLoss.gather` all of them, on every rank. Under
``"pfft"`` and ``"ct"`` the pairs stay on their rank, and are convolved
pairwise, when every rank holds the same even count; otherwise the rank
convolves its observations one by one (``"pfft"`` through the ``rfft2``,
``"ct"`` through its single-image transform), as in the JAX package. On
a 2-D ``(obs, row)`` mesh (``parallel.spatial.shard_stacked_spatial``)
the rank also keeps its block of the image rows; under ``"fft"`` its
block of the spectra's columns too, and it convolves through the pencil
FFT (``ops.dist_fft``); under ``"ct"`` and ``"mxu"`` it gathers the
row group's rows of its observations, convolves them one by one, and
keeps its own rows of the result (``parallel.mesh.all_gather``). Its
losses are then its rows' parts of each observation's: their share of
the pixel mean and ``1 / R`` of the Stirling term.
"""

import copy

import numpy as np
import torch

from ..config import resolve_device
from ..loss import poisson_nll, stirling_term_mean
from ..models.npred import as_bchw
from ..ops.ct_conv import (
    ct_build_pair_spectra,
    ct_conv_shape,
    ct_convolve_pair,
    ct_convolve_single,
    ct_kernel_spectra,
    make_ct_tables,
)
from ..ops.fft import (
    _origin_centered,
    build_kernel_stack,
    convolve_fft_precomputed,
    upsample_center_pad_kernels,
)
from ..ops.fft_mxu import (
    make_dft_tables,
    mxu_conv_shape,
    mxu_convolve,
    mxu_kernel_spectrum,
)
from ..ops.image import shift_images, sum_pool
from ..ops.pallas_fft import (
    conv_packed_pfft,
    default_pfft_mode,
    pfft_pair_spectra_device,
    pfft_size,
)
from .mesh import (
    all_gather,
    all_reduce_sum,
    mesh_size,
    obs_block,
    shard_stacked,
)

__all__ = ["CONV_MODES", "DataValidationError", "StackedPoissonLoss"]

CONV_MODES = ("fft", "pfft", "ct", "mxu", "direct")


class DataValidationError(ValueError):
    """The data is invalid, not merely unstackable.

    The joint strategy takes a plain ``ValueError`` from the stacked
    build as "cannot stack" and falls back to per-dataset models. This
    type means the data is invalid for either path (an RMF whose channel
    counts do not match the data, a dict RMF without a component), so
    the build re-raises it rather than fall back.
    """


class StackedPoissonLoss:
    """Per-dataset Poisson terms over a stacked observation axis.

    Attributes
    ----------
    counts, background : tensors ``(N, 1, K, H, W)``
    exposures : dict of component name -> ``(N, 1, C, H, W)``
    psf_ffts : dict of component name -> complex ``(N, 1, C, fh, fw//2+1)``
        (or one channel, broadcast over the bands)
    rmfs : dict of component name -> ``(N, C, K)``, or None
    stirling : ``(N,)`` precomputed Stirling terms
    conv_mode : one of :data:`CONV_MODES`
    pfft_pairs : dict of component name -> the four float32 spectrum
        planes ``(N // 2, 1, C, n, n)`` of the observation pairs, or None
        (another mode, or fewer than two observations)
    pfft_ns : dict of component name -> transform size ``n``
    ct_tables, ct_fft_shape : ``"ct"``'s tables (``ops.ct_conv
        .make_ct_tables``) and transform shape, or None
    ct_pairs : dict of component name -> the four float32 pair spectra
        ``(N // 2, 1, C, fh, fw)`` in the CT layout, or None
    ct_singles : dict of component name -> each observation's CT
        spectrum ``(re, im)``, each ``(N, 1, C, fh, fw)``, or None
    dft_tables, mxu_fft_shape : ``"mxu"``'s tables (``ops.fft_mxu
        .make_dft_tables``) and transform shape, or None
    psfs : dict of component name -> ``"mxu"``'s permuted complex spectra
        or ``"direct"``'s flipped kernels ``(N, 1, C, k, k')``, or None
    static_shifts, static_log_norms : ``(N, 1, 2)`` and ``(N, 1)``, or None
        The calibrations' values at build time, used for the leaves a
        (partly) frozen calibration does not train.
    mesh : DeviceMesh or None
        Set on a rank's copy by :meth:`shard` (and
        ``parallel.spatial.shard_stacked_spatial``); the per-observation
        arrays above then hold the observations ``obs_slice`` of
        ``names_all`` (``local_names``) and, with ``row_slice``, the image
        rows of ``row_slice`` at data resolution.
    """

    def __init__(self, counts, background, exposures, psf_ffts, names_all,
                 component_factors, fft_shape, component_names=None,
                 conv_mode="fft", pfft_pairs=None, pfft_ns=None,
                 weights=None, psf_scales=None, static_shifts=None,
                 static_log_norms=None, rmfs=None, ct_tables=None,
                 ct_fft_shape=None, ct_pairs=None, ct_singles=None,
                 dft_tables=None, mxu_fft_shape=None, psfs=None):
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
        self.conv_mode = conv_mode
        self.pfft_pairs = pfft_pairs
        self.pfft_ns = pfft_ns
        self.ct_tables = ct_tables
        self.ct_fft_shape = (None if ct_fft_shape is None
                             else tuple(ct_fft_shape))
        self.ct_pairs = ct_pairs
        self.ct_singles = ct_singles
        self.dft_tables = dft_tables
        self.mxu_fft_shape = (None if mxu_fft_shape is None
                              else tuple(mxu_fft_shape))
        self.psfs = psfs
        self.has_calibration = static_shifts is not None
        # per-dataset likelihood weights (1 without calibrations)
        self.weights = torch.tensor(
            [1.0] * len(self.names_all) if weights is None else weights,
            dtype=torch.float32, device=counts.device)
        self.psf_scales = None if psf_scales is None else tuple(psf_scales)
        self.static_shifts = static_shifts
        self.static_log_norms = static_log_norms
        self.rmfs = dict(rmfs) if rmfs else None
        # the whole loss until shard() takes a rank's block of it
        self.mesh = None
        self.obs_slice = slice(0, len(self.names_all))
        self.local_names = self.names_all
        self.row_slice = None
        self.row_shards = 1
        self.n_pixels = counts[0].numel()

    @property
    def n_datasets(self):
        return len(self.names_all)

    @classmethod
    def from_datasets(cls, datasets, components, calibrations=None,
                      fft_shape=None, conv_mode="fft",
                      correct_exposure_edges=True, row_shards=None,
                      device=None):
        """Stack homogeneous numpy datasets into batched tensors.

        ``datasets`` maps names to dicts of ``counts``, ``psf`` (array,
        or dict keyed by component), ``exposure`` and ``background``
        arrays (2-D images or 3-D band stacks) and optionally ``rmf``
        (array or dict keyed by component); ``calibrations``
        (`NPredCalibrations`, optional) is keyed like them. Components
        may have different upsampling factors when the first needs the
        largest FFT shape; otherwise, and for data that does not stack,
        the build raises ``ValueError`` (on which the joint strategy
        falls back to per-dataset models), and for invalid RMFs
        `DataValidationError`.
        ``device`` as in ``config.resolve_device``: the first CUDA card
        by default, the CPU only when asked. ``row_shards``, the row
        dimension of a mesh the loss will be sharded over
        (``parallel.spatial.shard_stacked_spatial``), grows the default
        FFT width until ``Fw // 2 + 1`` divides over it
        (``ops.dist_fft.spatial_fft_shape``) under ``"fft"``.
        ``conv_mode`` is one of :data:`CONV_MODES` (anything else raises
        ``ValueError``); ``"ct"`` and ``"mxu"`` need one transform shape
        for every component (``ValueError`` otherwise).
        """
        device = resolve_device(device)
        if conv_mode not in CONV_MODES:
            raise ValueError(
                f"conv_mode must be one of {CONV_MODES}, got {conv_mode!r}"
            )
        shapes = {np.asarray(d["counts"]).shape for d in datasets.values()}
        if len(shapes) != 1:
            raise ValueError(
                f"Stacked observations need one common counts shape, got "
                f"{shapes}"
            )
        names = list(datasets)
        rmfs = _stack_rmfs(datasets, components, next(iter(shapes)))

        # the calibrations' static values: the psf_scale zoom is baked
        # into the spectra below, the shifts and log norms stand in for
        # the leaves a frozen calibration does not train
        weights = psf_scales = scale_values = None
        static_shifts = static_log_norms = None
        if calibrations:
            weights = [calibrations[n].weight for n in names]
            psf_scales = [calibrations[n].psf_scale_value for n in names]
            if any(float(v) != 1.0 for v in psf_scales):
                scale_values = psf_scales
            static_shifts = torch.stack([
                calibrations[n].shift_xy.detach().to(device) for n in names])
            static_log_norms = torch.stack([
                calibrations[n]._background_norm.detach().to(device)
                for n in names])

        def stack(key):
            arr = np.stack([as_bchw(d[key]) for d in datasets.values()])
            return torch.as_tensor(arr, device=device)

        counts = stack("counts")
        background = stack("background")
        raw_exps = stack("exposure")

        exposures, psf_ffts, factors = {}, {}, []
        pfft_pairs, pfft_ns = {}, {}
        ct_pairs, ct_singles, psfs = {}, {}, {}
        ct_shape = ct_tables = mxu_shape = dft_tables = None
        n_obs = len(datasets)
        common_fft_shape = None if fft_shape is None else tuple(fft_shape)
        for name, component in components.items():
            factor = component.upsampling_factor or 1
            factors.append(factor)
            raw_psfs = []
            for dataset in datasets.values():
                psf = dataset["psf"]
                if isinstance(psf, dict):
                    psf = psf[name]
                raw_psfs.append(as_bchw(psf))

            image_shape = tuple(factor * s for s in raw_exps.shape[-2:])
            kmax = (max(factor * p.shape[-2] for p in raw_psfs),
                    max(factor * p.shape[-1] for p in raw_psfs))
            min_shape = (image_shape[0] + kmax[0] - 1,
                         image_shape[1] + kmax[1] - 1)
            if common_fft_shape is None:
                fw = min_shape[1]
                while row_shards and conv_mode == "fft" and (
                        (fw // 2 + 1) % row_shards):
                    fw += 1
                common_fft_shape = (min_shape[0], fw)
            if (common_fft_shape[0] < min_shape[0]
                    or common_fft_shape[1] < min_shape[1]):
                raise ValueError(
                    f"fft_shape {common_fft_shape} too small for component "
                    f"{name!r} (needs at least {min_shape})"
                )

            # ragged PSF sizes: upsample and center-pad per shape group,
            # then restore observation order
            by_shape = {}
            for idx, psf in enumerate(raw_psfs):
                by_shape.setdefault(psf.shape, []).append(idx)

            def padded_stack(scales):
                kernels = [None] * len(raw_psfs)
                for idxs in by_shape.values():
                    group = torch.as_tensor(
                        np.stack([raw_psfs[i] for i in idxs]), device=device)
                    padded = upsample_center_pad_kernels(
                        group, factor=factor, out_shape=kmax,
                        scales=None if scales is None
                        else [scales[i] for i in idxs],
                    )
                    for pos, idx in enumerate(idxs):
                        kernels[idx] = padded[pos]
                return torch.stack(kernels)

            # the edge correction takes the unscaled kernels, the
            # convolution the zoomed ones
            kernels = padded_stack(None)
            conv_kernels = (None if scale_values is None
                            else padded_stack(scale_values))
            kft, exp_stack = build_kernel_stack(
                kernels, raw_exps, factor=factor,
                fft_shape=common_fft_shape,
                correct_edges=correct_exposure_edges,
                conv_kernels=conv_kernels,
            )
            exposures[name] = exp_stack
            psf_ffts[name] = kft

            kstack = kernels if conv_kernels is None else conv_kernels
            if conv_mode == "pfft" and n_obs >= 2:
                # spectra of the observation pairs at the 128-aligned
                # transform size of the image padded to 128 multiples
                padded = tuple(pfft_size(s) for s in image_shape)
                n = pfft_size(max(padded[0] + kmax[0] - 1,
                                  padded[1] + kmax[1] - 1))
                n_even = 2 * (n_obs // 2)
                pfft_pairs[name] = pfft_pair_spectra_device(
                    kstack[0:n_even:2], kstack[1:n_even:2], padded, n
                )
                pfft_ns[name] = n
            elif conv_mode == "ct":
                # spectra in the permuted CT layout at "highest": the
                # pairs' for the joint path, each observation's for the
                # per-observation paths
                shape = tuple(ct_conv_shape(s) for s in min_shape)
                if ct_shape is None:
                    ct_shape = shape
                    ct_tables = make_ct_tables(shape, device=device)
                elif shape != ct_shape:
                    raise ValueError(
                        "conv_mode='ct' needs one common transform shape "
                        f"across components, got {shape} vs {ct_shape}"
                    )
                embedded = _origin_centered(kstack, ct_shape)
                if n_obs >= 2:
                    ct_pairs[name] = ct_build_pair_spectra(embedded,
                                                           ct_tables)
                ct_singles[name] = ct_kernel_spectra(embedded, ct_tables)
            elif conv_mode == "mxu":
                # permuted spectra at a size of balanced factors
                shape = tuple(mxu_conv_shape(s) for s in min_shape)
                if mxu_shape is None:
                    mxu_shape = shape
                    dft_tables = make_dft_tables(shape, device=device)
                elif shape != mxu_shape:
                    raise ValueError(
                        "conv_mode='mxu' needs one common transform shape "
                        f"across components, got {shape} vs {mxu_shape}"
                    )
                psfs[name] = mxu_kernel_spectrum(kstack, mxu_shape,
                                                 dft_tables)
            elif conv_mode == "direct":
                psfs[name] = _direct_kernels(kstack)

        if rmfs is not None:
            # the input channels must match the exposure stack's bands
            for name, rmf in rmfs.items():
                c_in, c_exp = rmf.shape[-2], exposures[name].shape[-3]
                if c_in != c_exp:
                    raise DataValidationError(
                        f"rmf for component {name!r} has {c_in} input "
                        f"channels but the exposure/counts stack has "
                        f"{c_exp} channels"
                    )
            rmfs = {name: torch.as_tensor(rmf, device=device)
                    for name, rmf in rmfs.items()}

        return cls(
            counts=counts,
            background=background,
            exposures=exposures,
            psf_ffts=psf_ffts,
            names_all=names,
            component_factors=factors,
            fft_shape=common_fft_shape,
            component_names=list(components),
            conv_mode=conv_mode,
            pfft_pairs=pfft_pairs or None,
            pfft_ns=pfft_ns or None,
            ct_tables=ct_tables,
            ct_fft_shape=ct_shape,
            ct_pairs=ct_pairs or None,
            ct_singles=ct_singles or None,
            dft_tables=dft_tables,
            mxu_fft_shape=mxu_shape,
            psfs=psfs or None,
            weights=weights,
            psf_scales=psf_scales,
            static_shifts=static_shifts,
            static_log_norms=static_log_norms,
            rmfs=rmfs,
        )

    def _stack_calibration_params(self, calibration_params):
        """Calibration params keyed by dataset name -> ``(N, 1, 2)``
        shifts and ``(N, 1)`` log norms. A leaf that a (partly) frozen
        calibration does not train contributes its static value, not
        zero."""
        shifts, log_norms = [], []
        for idx, name in enumerate(self.local_names):
            cal = (calibration_params or {}).get(name) or {}
            shifts.append(cal.get("shift_xy", self.static_shifts[idx]))
            log_norms.append(cal.get("log_background_norm",
                                     self.static_log_norms[idx]))
        return torch.stack(shifts), torch.stack(log_norms)

    def _evaluate_batched(self, fluxes, calibration_params, conv_fn,
                          index=None):
        """Batched forward: ``conv_fn(name, x)`` convolves the
        ``(N, 1, C, H, W)`` stack ``x`` of component ``name``. With
        ``index`` (a slice) only those observations are evaluated."""
        sel = slice(None) if index is None else index
        shifts = log_norms = None
        if self.has_calibration:
            shifts, log_norms = self._stack_calibration_params(
                calibration_params)
            shifts, log_norms = shifts[sel], log_norms[sel]
        background = self.background[sel]
        npred = torch.zeros_like(background)
        for idx, name in enumerate(self.component_names):
            factor = self.component_factors[idx]
            if shifts is None:
                x = fluxes[idx][None]
            else:
                x = shift_images(fluxes[idx], shifts, scale=factor)
            if self.row_slice is not None:
                x = x[..., factor * self.row_slice.start:
                      factor * self.row_slice.stop, :]
            x = x * self.exposures[name][sel]
            y = sum_pool(conv_fn(name, x), factor)
            if self.rmfs is not None:
                y = torch.einsum("n...chw,nck->n...khw", y,
                                 self.rmfs[name][sel])
            npred = npred + torch.clamp(y, min=0.0)
        if log_norms is None:
            npred = npred + background
        else:
            npred = npred + background * torch.exp(log_norms).reshape(
                (-1,) + (1,) * (background.ndim - 1))
        counts, stirling = self.counts[sel], self.stirling[sel]
        if self.row_slice is None:
            return torch.vmap(
                lambda n, c, s: poisson_nll(n, c, stirling=s)
            )(npred, counts, stirling)
        # this rank's rows: their share of each image's pixel mean, and
        # 1/R of its Stirling term (computed on the whole image)
        terms = npred - counts * torch.log(npred + 1e-25)
        return (terms.flatten(1).sum(1) / self.n_pixels
                + stirling / self.row_shards)

    def evaluate(self, fluxes, calibration_params=None):
        """Per-observation mean Poisson NLL: ``(N,)`` tensor (on a rank of
        a mesh, of its observations and, on a 2-D mesh, its rows' parts
        of them)."""
        return self._evaluate_batched(fluxes, calibration_params,
                                      self.convolve)

    def convolve(self, name, x):
        """The stack ``x`` ``(N, 1, C, H, W)`` of this loss's observations
        (on a 2-D mesh, this rank's rows of them) convolved with component
        ``name``'s PSFs by the loss's backend: pairs where it has them,
        each observation alone otherwise. Differentiable twice."""
        if self.row_slice is not None:
            if self.conv_mode == "fft":
                return self._conv_dist(name, x)
            return self._conv_gathered_rows(name, x)
        if self.conv_mode == "pfft" and self.pfft_pairs is not None:
            return self._conv_packed(name, x, self._conv_pfft_pair)
        if self.conv_mode == "ct" and self.ct_pairs is not None:
            return self._conv_packed(name, x, self._conv_ct_pair)
        return self._conv_single(name, x)

    def gather(self, losses):
        """Every observation's loss ``(N,)`` from each rank's
        :meth:`evaluate` (its parts summed over the row ranks), the same
        on every rank; ``losses`` itself without a mesh. Not
        differentiable."""
        if self.mesh is None:
            return losses
        full = torch.zeros(self.n_datasets, dtype=losses.dtype,
                           device=losses.device)
        full[self.obs_slice] = losses.detach()
        return all_reduce_sum(full)

    def shard(self, mesh):
        """This rank's copy of the loss on ``mesh``: its contiguous block
        of the observations (``parallel.mesh.obs_block``) and their
        per-observation arrays (counts, background, exposures, spectra,
        Stirling terms, weights, static calibration values, RMFs).

        The observation pairs of ``"pfft"`` and ``"ct"`` stay on their
        rank when every rank holds the same even count of observations;
        otherwise the pair spectra are dropped and ``evaluate`` convolves
        the rank's observations one by one (the JAX package's rule). The
        transform tables are shared.
        """
        n_obs, n_ranks = self.n_datasets, mesh_size(mesh, "obs")
        new = copy.copy(self)
        new.mesh, new.obs_slice = mesh, obs_block(n_obs, mesh)
        new.local_names = self.names_all[new.obs_slice]
        for attr in ("counts", "background", "exposures", "psf_ffts",
                     "stirling", "weights", "static_shifts",
                     "static_log_norms", "rmfs", "ct_singles", "psfs"):
            setattr(new, attr, shard_stacked(getattr(self, attr), mesh))
        # with the same even count on every rank, the rank's block of the
        # pairs is the pairs of its block of observations
        per_rank = n_obs // n_ranks if n_obs % n_ranks == 0 else 0
        pairs_local = per_rank and per_rank % 2 == 0
        new.pfft_pairs = (shard_stacked(self.pfft_pairs, mesh) if pairs_local
                          else None)
        new.ct_pairs = (shard_stacked(self.ct_pairs, mesh) if pairs_local
                        else None)
        return new

    def evaluate_dataset(self, idx, fluxes, calibration_params=None):
        """Mean Poisson NLL of observation ``idx`` alone (its convolution
        of the mode, one observation's: ``"pfft"``'s is the ``rfft2``,
        ``"ct"``'s its single-image transform): the work of one
        observation."""
        index = slice(idx, idx + 1)
        return self._evaluate_batched(
            fluxes, calibration_params,
            lambda name, x: self._conv_single(name, x, index),
            index=index)[0]

    def _conv_single(self, name, x, index=slice(None)):
        """Each observation of ``x`` alone, with the spectra (kernels) of
        the observations ``index``."""
        if self.conv_mode == "ct":
            fr, fi = self.ct_singles[name]
            return ct_convolve_single(x, fr[index], fi[index],
                                      self.ct_tables, self.ct_fft_shape)
        if self.conv_mode == "mxu":
            return mxu_convolve(x, self.psfs[name][index], self.dft_tables,
                                self.mxu_fft_shape)
        if self.conv_mode == "direct":
            return _conv_direct(x, self.psfs[name][index])
        return convolve_fft_precomputed(x, self.psf_ffts[name][index],
                                        self.fft_shape)

    def _conv_gathered_rows(self, name, x):
        """On a 2-D mesh: this rank's rows of its observations gathered
        over the row group, convolved one by one, and its rows kept."""
        group = self.mesh.get_group("row")
        n_local = x.shape[-2]
        index = int(self.mesh.get_local_rank("row"))
        y = self._conv_single(name, all_gather(x, x.ndim - 2, group))
        return y[..., index * n_local:(index + 1) * n_local, :]

    def _conv_dist(self, name, x):
        from ..ops.dist_fft import dist_convolve_fft

        return dist_convolve_fft(x, self.psf_ffts[name], self.fft_shape,
                                 self.mesh)

    def _conv_packed(self, name, x, pair_fn):
        """Observation pairs through ``pair_fn(name, even, odd)``, an odd
        last one through the ``rfft2``."""
        n = x.shape[0]
        n_pairs = n // 2
        y0, y1 = pair_fn(name, x[0:2 * n_pairs:2], x[1:2 * n_pairs:2])
        y = torch.stack([y0, y1], dim=1).reshape((2 * n_pairs,)
                                                 + y0.shape[1:])
        if n % 2:
            tail = convolve_fft_precomputed(x[-1], self.psf_ffts[name][-1],
                                            self.fft_shape)
            y = torch.cat([y, tail[None]])
        return y

    def _conv_ct_pair(self, name, xe, xo):
        return ct_convolve_pair(xe, xo, *self.ct_pairs[name],
                                self.ct_tables, self.ct_fft_shape)

    def _conv_pfft_pair(self, name, xe, xo):
        """``xe``, ``xo`` ``(P, ..., H, W)`` padded to 128 multiples, the
        leading dimensions (the bands) flattened into the pair batch of
        one pipeline call, convolved, and cropped back."""
        n = self.pfft_ns[name]
        lead = xe.shape[:-2]
        h, w = xe.shape[-2], xe.shape[-1]
        hp, wp = pfft_size(h), pfft_size(w)
        pad = (0, wp - w, 0, hp - h)
        xe = torch.nn.functional.pad(xe, pad).reshape(-1, hp, wp)
        xo = torch.nn.functional.pad(xo, pad).reshape(-1, hp, wp)
        planes = [p.expand(lead + p.shape[-2:]).reshape(-1, n, n)
                  for p in self.pfft_pairs[name]]
        y0, y1 = conv_packed_pfft(xe, xo, *planes, n, default_pfft_mode())
        return (y0[:, :h, :w].reshape(lead + (h, w)),
                y1[:, :h, :w].reshape(lead + (h, w)))

    def __call__(self, fluxes, calibration_params=None):
        """Weighted sum of per-observation losses (on a rank of a mesh,
        of its own losses)."""
        return torch.sum(self.evaluate(fluxes, calibration_params)
                         * self.weights)


def _direct_kernels(kernels):
    """``"direct"``'s kernels: the center-aligned stack ``(N, 1, C, k,
    k')`` grown to odd sizes (a row or column before the kernel keeps its
    centre pixel ``(k - 1) // 2`` in the middle) and flipped, so that
    ``conv2d``'s correlation is the convolution."""
    kh, kw = kernels.shape[-2], kernels.shape[-1]
    kernels = torch.nn.functional.pad(kernels, (1 - kw % 2, 0, 1 - kh % 2, 0))
    return torch.flip(kernels, dims=(-2, -1))


def _conv_direct(x, kernels):
    """``x (N, 1, C, H, W)`` convolved with flipped odd kernels ``(N, 1,
    C or 1, k, k')`` (one channel broadcasts over the bands) by one grouped
    ``conv2d``, a group for each (observation, band), zero-padded to the
    same size (``lax.conv``'s ``"SAME"``)."""
    kernels = kernels.expand(x.shape[:-2] + kernels.shape[-2:])
    out = torch.nn.functional.conv2d(
        x.reshape((1, -1) + x.shape[-2:]),
        kernels.reshape((-1, 1) + kernels.shape[-2:]),
        padding="same", groups=x.shape[:-2].numel())
    return out.reshape(x.shape)


def _stack_rmfs(datasets, components, counts_shape):
    """The datasets' RMFs as one float32 ``(N, C, K)`` numpy stack per
    component, or None when no dataset has one.

    An RMF on some datasets only, or RMFs of different shapes, cannot
    stack (``ValueError``); a dict RMF without a component's key and an
    output channel count other than the counts' are invalid for either
    path (`DataValidationError`).
    """
    present = ["rmf" in d for d in datasets.values()]
    if not any(present):
        return None
    if not all(present):
        raise ValueError(
            "some datasets carry an 'rmf' and others do not; the stacked "
            "path needs a homogeneous stack"
        )
    rmfs = {}
    for name in components:
        mats = []
        for ds_name, dataset in datasets.items():
            rmf = dataset["rmf"]
            if isinstance(rmf, dict):
                if name not in rmf:
                    raise DataValidationError(
                        f"dataset {ds_name!r}: dict-form 'rmf' is missing "
                        f"component {name!r}"
                    )
                rmf = rmf[name]
            mats.append(np.asarray(rmf, np.float32))
        rmf_shapes = {m.shape for m in mats}
        if len(rmf_shapes) != 1 or mats[0].ndim != 2:
            raise ValueError(
                f"stacked observations need one common 2-D rmf shape per "
                f"component, got {rmf_shapes} for component {name!r}"
            )
        rmfs[name] = np.stack(mats)
    n_out = counts_shape[-3] if len(counts_shape) >= 3 else 1
    k_out = {m.shape[-1] for m in rmfs.values()}
    if k_out != {n_out}:
        raise DataValidationError(
            f"rmf output channels {k_out} do not match the counts channel "
            f"axis ({n_out})"
        )
    return rmfs
