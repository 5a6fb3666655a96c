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

Two convolution backends are ported: ``conv_mode="fft"``, a batched
per-observation ``rfft2`` (cuFFT on the card), and ``conv_mode="pfft"``,
the pair-packed matrix DFT (``ops/pallas_fft.py``): even and odd
observations go pairwise through one complex transform, at a size that
is a multiple of 128, with the images padded to multiples of 128, the
bands of each pair flattened into the kernels' batch; an odd last
observation takes the ``rfft2`` path. Not ported: the other convolution
backends and the mesh paths.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..loss import poisson_nll, stirling_term_mean
from ..models.npred import as_bchw
from ..ops.fft import (
    build_kernel_stack,
    convolve_fft_precomputed,
    upsample_center_pad_kernels,
)
from ..ops.image import shift_images, sum_pool
from ..ops.pallas_fft import (
    conv_packed_pfft,
    default_pfft_mode,
    pfft_pair_spectra_device,
    pfft_size,
)

__all__ = ["DataValidationError", "StackedPoissonLoss"]


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
    conv_mode : ``"fft"`` or ``"pfft"``
    pfft_pairs : dict of component name -> the four float32 spectrum
        planes ``(N // 2, 1, C, n, n)`` of the observation pairs, or None
        (``"fft"``, or fewer than two observations)
    pfft_ns : dict of component name -> transform size ``n``
    static_shifts, static_log_norms : ``(N, 1, 2)`` and ``(N, 1)``, or None
        The calibrations' values at build time, used for the leaves a
        (partly) frozen calibration does not train.
    """

    def __init__(self, counts, background, exposures, psf_ffts, names_all,
                 component_factors, fft_shape, component_names=None,
                 conv_mode="fft", pfft_pairs=None, pfft_ns=None,
                 weights=None, psf_scales=None, static_shifts=None,
                 static_log_norms=None, rmfs=None):
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
        self.has_calibration = static_shifts is not None
        # per-dataset likelihood weights (1 without calibrations)
        self.weights = torch.tensor(
            [1.0] * len(self.names_all) if weights is None else weights,
            dtype=torch.float32, device=counts.device)
        self.psf_scales = None if psf_scales is None else tuple(psf_scales)
        self.static_shifts = static_shifts
        self.static_log_norms = static_log_norms
        self.rmfs = dict(rmfs) if rmfs else None

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
        by default, the CPU only when asked. ``row_shards`` (the JAX
        package's pencil-FFT mesh) is accepted for signature parity;
        anything but ``None`` raises.
        """
        if row_shards is not None:
            raise NotImplementedError("row_shards is not ported yet")
        device = resolve_device(device)
        if conv_mode not in ("fft", "pfft"):
            raise NotImplementedError(
                f"conv_mode={conv_mode!r} is not ported yet; use 'fft' or "
                "'pfft'"
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
                common_fft_shape = min_shape
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

            if conv_mode == "pfft" and n_obs >= 2:
                # spectra of the observation pairs at the 128-aligned
                # transform size of the image padded to 128 multiples
                padded = tuple(pfft_size(s) for s in image_shape)
                n = pfft_size(max(padded[0] + kmax[0] - 1,
                                  padded[1] + kmax[1] - 1))
                n_even = 2 * (n_obs // 2)
                kstack = kernels if conv_kernels is None else conv_kernels
                pfft_pairs[name] = pfft_pair_spectra_device(
                    kstack[0:n_even:2], kstack[1:n_even:2], padded, n
                )
                pfft_ns[name] = n

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
        for idx, name in enumerate(self.names_all):
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
        return torch.vmap(
            lambda n, c, s: poisson_nll(n, c, stirling=s)
        )(npred, self.counts[sel], self.stirling[sel])

    def evaluate(self, fluxes, calibration_params=None):
        """Per-observation mean Poisson NLL: ``(N,)`` tensor."""
        if self.conv_mode == "pfft" and self.pfft_pairs is not None:
            conv_fn = self._conv_packed_pfft
        else:
            conv_fn = self._conv_fft
        return self._evaluate_batched(fluxes, calibration_params, conv_fn)

    def evaluate_dataset(self, idx, fluxes, calibration_params=None):
        """Mean Poisson NLL of observation ``idx`` alone (its ``rfft2``
        convolution): the work of one observation."""
        index = slice(idx, idx + 1)

        def conv_fn(name, x):
            return convolve_fft_precomputed(x, self.psf_ffts[name][index],
                                            self.fft_shape)

        return self._evaluate_batched(fluxes, calibration_params, conv_fn,
                                      index=index)[0]

    def _conv_fft(self, name, x):
        return convolve_fft_precomputed(x, self.psf_ffts[name],
                                        self.fft_shape)

    def _conv_packed_pfft(self, name, x):
        """Observation pairs through the matrix DFT, an odd last one
        through the ``rfft2``."""
        n = x.shape[0]
        n_pairs = n // 2
        y0, y1 = self._conv_pfft_pair(name, x[0:2 * n_pairs:2],
                                      x[1:2 * n_pairs:2])
        y = torch.stack([y0, y1], dim=1).reshape((2 * n_pairs,)
                                                 + y0.shape[1:])
        if n % 2:
            tail = convolve_fft_precomputed(x[-1], self.psf_ffts[name][-1],
                                            self.fft_shape)
            y = torch.cat([y, tail[None]])
        return y

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
        """Weighted sum of per-observation losses."""
        return torch.sum(self.evaluate(fluxes, calibration_params)
                         * self.weights)


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
