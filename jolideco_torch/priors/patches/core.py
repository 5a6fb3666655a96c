"""GMM patch prior and its multiscale wrapper (the JAX package's
``priors/patches/core.py``).

The log-prior of a flux image is the overlap-weighted mean of its patch
scores under a GMM: image norm, integer cycle spin, optional subpixel
spin, overlapping (or jittered) patches, zero-flux patch masking, the
patch norm, then the best component's log-probability per patch (MAP)
or the logsumexp over the components (``marginalize=True``). Two
branches compute it, as in the JAX package:

- the fused branch (``ops.gmm_fused``): extraction, masking, mean
  subtraction and scoring in one pass, a CUDA kernel on the card and
  its plain version on the CPU. It takes the shipped 8x8 GMMs under the
  mean subtraction, with a stride that divides the patch edge, and
  neither jitter nor patch subsampling;
- the patch-level branch for everything else, and for everything when
  the fused switch is off (``config.force_fused("off")``): extraction
  (grouped for a dividing stride, row-major for any other, a gather at
  jittered corners, one offset class or a random subset under
  ``patch_fraction < 1``), masking and the patch norm in PyTorch, then
  the patch-level scorer (``ops.gmm_pallas``), CUDA kernels for 8x8
  patches on the card and the plain versions on the CPU. It is twice
  differentiable, which the fused branch is not: the Hessian probe of
  the flux errors takes it.

An evaluation's random draws are made ahead of it (:meth:`draw_shifts`)
from a CPU generator, in this order: the cycle spin (x, then y), the
subpixel offsets (x0, then y0), the jitters (one per grid column, then
one per grid row), then the patch subsample (an offset class, or a
permutation of the patches). ``MultiScalePrior`` draws its own cycle
spin, then each level's draws in level order.
"""

from math import sqrt

import numpy as np
import torch

from ...config import gmm_mode, use_fused
from ...ops.fft import convolve_fft, fft_conv_shape, kernel_fft
from ...ops.gmm_fused import fused_supported, gmm_score_fused_image
from ...ops.image import (
    avg_pool,
    cycle_spin,
    cycle_spin_subpixel,
    draw_cycle_spin,
    draw_subpixel,
)
from ...ops.patches import (
    count_overlapping_patches,
    count_random_patches,
    draw_patch_jitter,
    get_pixel_weights,
    grouped_patch_corners,
    reconstruct_from_overlapping_patches_at,
    view_as_overlapping_patches,
    view_as_overlapping_patches_grouped,
    view_as_random_overlapping_patches,
    view_as_single_group_patches,
)
from ...utils.kernels import gaussian_kernel_2d
from ...utils.norms import (
    IdentityImageNorm,
    ImageNorm,
    PatchNorm,
    SubtractMeanPatchNorm,
)
from ..core import Prior
from .gmm import GaussianMixtureModel

__all__ = ["GMMPatchPrior", "MultiScalePrior", "ZERO_FLUX_SENTINEL"]

ZERO_FLUX_SENTINEL = -1e5


class GMMPatchPrior(Prior):
    """Patch prior scoring overlapping patches under a GMM.

    Parameters
    ----------
    gmm : `GaussianMixtureModel`, optional
        Defaults to the registry's ``zoran-weiss``, which resolves to the
        shipped ``astro-snr-v1`` with a warning, as in the JAX package.
    stride : int, optional
        Patch stride (any); defaults to the GMM's meta stride.
    cycle_spin : bool
        Random integer roll each evaluation.
    cycle_spin_subpix : bool
        Additional random subpixel shift.
    norm : `ImageNorm`, optional
        Defaults to the identity.
    patch_norm : `PatchNorm`, optional
        Defaults to the GMM's.
    jitter : bool
        Randomly jittered patch positions.
    marginalize : bool
        Score each patch by the logsumexp over the components instead of
        the best component.
    patch_fraction : float
        Fraction of the patches scored per evaluation, scaled back up.
        A fraction that rounds to at most one offset class
        (``round(fraction * n_groups) <= 1``, ``n_groups = (patch /
        stride)**2``) scores one whole class drawn uniformly, padded to
        the largest with rows the zero-flux filter drops, times
        ``n_groups``; a larger one a uniformly drawn subset of
        ``round(fraction * n_patches)`` patches.
    seed : int
        Seed of the prior's own generator (used when a call passes
        neither draws nor a generator).
    """

    def __init__(self, gmm=None, stride=None, cycle_spin=True,
                 cycle_spin_subpix=False, norm=None, patch_norm=None,
                 jitter=False, marginalize=False, patch_fraction=1.0,
                 seed=0):
        super().__init__(seed=seed)
        if gmm is None:
            gmm = GaussianMixtureModel.from_registry("zoran-weiss")
        self.gmm = gmm
        self.stride = int(gmm.meta.stride if stride is None else stride)
        self.cycle_spin = bool(cycle_spin)
        self.cycle_spin_subpix = bool(cycle_spin_subpix)
        self.norm = norm if norm is not None else IdentityImageNorm()
        self.patch_norm = (gmm.meta.patch_norm if patch_norm is None
                           else patch_norm)
        self.jitter = bool(jitter)
        self.marginalize = bool(marginalize)
        if not 0.0 < patch_fraction <= 1.0:
            raise ValueError("patch_fraction must be in (0, 1]")
        self.patch_fraction = float(patch_fraction)

    @property
    def patch_shape(self):
        npix = int(sqrt(self.gmm.means.shape[-1]))
        return npix, npix

    @property
    def overlap(self):
        """Patch overlap in pixels."""
        return max(self.patch_shape) - self.stride

    @property
    def _grouped_ok(self):
        """Whether the grouped extraction applies (stride | patch)."""
        ph, pw = self.patch_shape
        return ph == pw and ph % self.stride == 0

    @property
    def _n_groups(self):
        return (self.patch_shape[0] // self.stride) ** 2

    @property
    def _group_sampling(self):
        """Whether ``patch_fraction`` samples one offset class."""
        return (
            self.patch_fraction < 1.0
            and not self.jitter
            and self._grouped_ok
            and int(round(self.patch_fraction * self._n_groups)) <= 1
        )

    @property
    def log_like_weight(self):
        """Per-patch weight correcting for patch overlap."""
        return self.stride**2 / float(np.prod(self.patch_shape))

    def parameters(self):
        """Trainable hyper-parameters: the image norm's."""
        norm_params = self.norm.parameters()
        return {"norm": norm_params} if norm_params else {}

    def set_parameters(self, params):
        if params and "norm" in params:
            self.norm.set_parameters(params["norm"])

    def to(self, device):
        self.norm.to(device)
        return self

    def _n_patches(self, shape):
        """Patches one evaluation extracts at a flux of ``shape`` (before
        subsampling)."""
        h, w = shape[-2:]
        ph, pw = self.patch_shape
        if self.jitter:
            return count_random_patches(shape, self.patch_shape, self.stride)
        if self._grouped_ok:
            return count_overlapping_patches(shape, self.patch_shape,
                                             self.stride)
        return ((h - ph) // self.stride + 1) * ((w - pw) // self.stride + 1)

    def draw_shifts(self, generator=None, shape=None):
        """The random draws of one evaluation at a flux of ``shape``, in
        the module's order: the cycle spin ``(sy, sx)`` alone (``None``
        without one) where that is all it draws, else a dict with
        ``"spin"`` and, as the options ask, ``"subpix"`` ``(x0, y0)``,
        ``"jitter"`` ``(jitter_y, jitter_x)``, ``"group"`` (an offset
        class) or ``"subset"`` (patch indices, a CPU tensor)."""
        gen = self.generator if generator is None else generator
        spin = (draw_cycle_spin(self.patch_shape, gen) if self.cycle_spin
                else None)
        if not (self.cycle_spin_subpix or self.jitter
                or self.patch_fraction < 1.0):
            return spin
        draws = {"spin": spin}
        if self.cycle_spin_subpix:
            draws["subpix"] = draw_subpixel(gen)
        if (self.jitter or not self._group_sampling) and shape is None:
            raise ValueError(
                "jitter and patch subsets draw at the flux's shape: pass "
                "shape=")
        if self.jitter:
            draws["jitter"] = draw_patch_jitter(shape, self.patch_shape,
                                                self.stride, gen)
        if self._group_sampling:
            draws["group"] = int(torch.randint(0, self._n_groups, (),
                                               generator=gen))
        elif self.patch_fraction < 1.0:
            n_total = self._n_patches(shape)
            n_keep = max(1, int(round(self.patch_fraction * n_total)))
            draws["subset"] = torch.randperm(n_total, generator=gen)[:n_keep]
        return draws

    def _draws(self, shape, generator, shifts):
        """``shifts`` (or fresh draws) as a dict."""
        if shifts is None:
            shifts = self.draw_shifts(generator, tuple(shape))
        if not isinstance(shifts, dict):
            shifts = {"spin": shifts}
        return shifts

    def _fused_ok(self, shape):
        return (
            use_fused() != "off"
            and not self.jitter
            and self.patch_fraction >= 1.0
            and self._grouped_ok
            and type(self.patch_norm) is SubtractMeanPatchNorm
            and fused_supported(shape, self.patch_shape, self.stride,
                                self.gmm.n_features)
        )

    def second_order_ok(self, flux_shape):
        """Whether the log-prior is twice differentiable at this shape.

        Not when the fused scorer would run: its backward kernel has no
        derivative, so the Hessian probe turns the fused switch off
        first. The image norm and the spins keep the shape.
        """
        return not self._fused_ok(tuple(flux_shape))

    def _evaluate_log_like(self, flux, params=None, generator=None,
                           shifts=None, fused=None):
        """Per-patch ``(values, argmax, valid, patch_means, shifts,
        subsample_scale)``: ``shifts`` the cycle spin applied,
        ``patch_means`` the masked patches' means (``None`` on the fused
        branch); ``fused=None`` takes the fused branch where it
        applies."""
        draws = self._draws(flux.shape, generator, shifts)
        norm_params = None if params is None else params.get("norm")
        normed = self.norm(flux, params=norm_params)

        applied = (0, 0)
        if self.cycle_spin:
            normed, applied = cycle_spin(normed, self.patch_shape,
                                         shifts=draws["spin"])
        if self.cycle_spin_subpix:
            normed = cycle_spin_subpixel(normed, *draws["subpix"])

        if fused is None:
            fused = self._fused_ok(normed.shape)
        if fused:
            values, argmax, valid = gmm_score_fused_image(
                normed, self.patch_shape, self.stride,
                self.gmm.kernel_buffers(normed.device), ZERO_FLUX_SENTINEL,
                marginalize=self.marginalize, mode=gmm_mode(),
            )
            return values, argmax, valid, None, applied, 1.0

        subsample_scale = 1.0
        if self._group_sampling:
            patches, _ = view_as_single_group_patches(
                normed, self.patch_shape, self.stride, draws["group"],
                pad_value=2.0 * ZERO_FLUX_SENTINEL)
            # each patch is in exactly one class, so the drawn class's
            # sum times n_groups is unbiased
            subsample_scale = float(self._n_groups)
        elif self.jitter:
            patches = view_as_random_overlapping_patches(
                normed, self.patch_shape, self.stride, *draws["jitter"])
        elif self._grouped_ok:
            patches = view_as_overlapping_patches_grouped(
                normed, shape=self.patch_shape, stride=self.stride)
        else:
            patches = view_as_overlapping_patches(
                normed, shape=self.patch_shape, stride=self.stride)

        if "subset" in draws:
            n_total = patches.shape[0]
            idx = draws["subset"].to(patches.device)
            patches = patches[idx]
            subsample_scale = n_total / idx.shape[0]

        valid = torch.all(patches > ZERO_FLUX_SENTINEL, dim=1)
        patches = torch.where(valid[:, None], patches,
                              torch.zeros_like(patches))
        patch_means = torch.nanmean(patches, dim=1, keepdim=True)
        values, argmax = self.gmm.score(self.patch_norm(patches),
                                        marginalize=self.marginalize)
        return values, argmax, valid, patch_means, applied, subsample_scale

    def __call__(self, flux, params=None, generator=None, shifts=None):
        """Scalar log-prior: overlap-weighted mean of the patch scores.

        ``shifts`` takes the draws of :meth:`draw_shifts` (a bare ``(sy,
        sx)`` fixes the cycle spin alone) instead of drawing them.
        """
        values, _, valid, _, _, scale = self._evaluate_log_like(
            flux, params=params, generator=generator, shifts=shifts
        )
        values = torch.where(valid, values, torch.zeros_like(values))
        return values.sum() * scale * self.log_like_weight / flux.numel()

    def prior_image(self, flux, generator=None, shifts=None):
        """Patch image from the eigen-images of the best-fit components,
        overlap-added with the pixel weights, the cycle spin undone and
        the image norm inverted (numpy; a diagnostic)."""
        if self.jitter:
            raise ValueError(
                "Computing prior images with jittering is not supported."
            )
        if self.patch_fraction < 1.0:
            raise ValueError(
                "Computing prior images with patch subsampling is not "
                "supported."
            )
        if not torch.is_tensor(flux):
            flux = torch.as_tensor(np.asarray(flux, np.float32))
        with torch.no_grad():
            _, argmax, _, patch_means, applied, _ = self._evaluate_log_like(
                flux, generator=generator, shifts=shifts, fused=False)

        patches = (self.gmm.eigen_images[argmax.cpu().numpy()]
                   + patch_means.cpu().numpy().reshape((-1, 1, 1)))
        weights = get_pixel_weights(self.patch_shape, self.stride)
        image_shape = tuple(flux.shape[-2:])
        if self._grouped_ok:
            corners = grouped_patch_corners(image_shape, self.patch_shape,
                                            self.stride)
        else:
            (h, w), (ph, pw) = image_shape, self.patch_shape
            yy, xx = np.meshgrid(np.arange(0, h - ph + 1, self.stride),
                                 np.arange(0, w - pw + 1, self.stride),
                                 indexing="ij")
            corners = np.stack([yy.ravel(), xx.ravel()], axis=-1)
        reco = reconstruct_from_overlapping_patches_at(
            weights * patches, corners, image_shape)
        image = np.roll(reco, shift=-1 * np.asarray(applied), axis=(0, 1))
        return self.norm.inverse(
            torch.as_tensor(image.astype(np.float32))).numpy()

    def prior_image_average(self, flux, n_average=100, generator=None,
                            shifts=None):
        """Mean of :meth:`prior_image` over ``n_average`` draws (or over
        the given sequence of draws ``shifts``)."""
        flux = np.asarray(flux)[None, None]
        images = [
            self.prior_image(flux, generator=generator,
                             shifts=None if shifts is None else shifts[idx])
            for idx in range(n_average)
        ]
        return np.mean(images, axis=0)

    def to_dict(self):
        data = super().to_dict()
        data["stride"] = int(self.stride)
        data["cycle_spin"] = bool(self.cycle_spin)
        data["cycle_spin_subpix"] = bool(self.cycle_spin_subpix)
        data["jitter"] = bool(self.jitter)
        data["marginalize"] = bool(self.marginalize)
        data["patch_fraction"] = float(self.patch_fraction)
        data["gmm"] = self.gmm.to_dict()
        data["norm"] = self.norm.to_dict()
        data["patch_norm"] = self.patch_norm.to_dict()
        return data

    @classmethod
    def from_dict(cls, data):
        kwargs = {k: v for k, v in data.items() if k != "type"}
        if kwargs.get("gmm") is not None:
            kwargs["gmm"] = GaussianMixtureModel.from_dict(kwargs["gmm"])
        if kwargs.get("norm") is not None:
            kwargs["norm"] = ImageNorm.from_dict(kwargs["norm"])
        if kwargs.get("patch_norm") is not None:
            kwargs["patch_norm"] = PatchNorm.from_dict(kwargs["patch_norm"])
        kwargs.pop("device", None)  # the upstream format's key
        return cls(**kwargs)


class MultiScalePrior(Prior):
    """A prior applied across resolution levels, summed with trainable
    softmax weights.

    Level ``i`` (factor ``f = 2**i``) smooths the cycle-spun flux with a
    Gaussian of sigma ``2 f / 6`` on top of the previous levels'
    smoothing (cumulative, level 0 included, as the JAX package and the
    upstream loop do), truncates it to a multiple of ``f``, averages
    ``f x f`` blocks, and adds ``f² w_i`` times the wrapped prior there.
    Every level is evaluated, whatever its weight.
    """

    def __init__(self, prior, n_levels=2, weights=None, cycle_spin=True,
                 anti_alias=True, seed=0):
        super().__init__(seed=seed)
        self.n_levels = int(n_levels)
        self.cycle_spin = bool(cycle_spin)
        self.prior = prior
        if weights is None:
            weights = np.full(self.n_levels, 1.0 / self.n_levels)
        self._log_weights = torch.as_tensor(
            np.log(np.asarray(weights)).astype(np.float32))
        self.anti_alias = bool(anti_alias)
        self._kernels = tuple(
            torch.as_tensor(gaussian_kernel_2d(2 * 2**idx / 6.0)[None, None]
                            .astype(np.float32))
            for idx in range(self.n_levels)
        )

    @property
    def weights(self):
        """Softmax-normalised level weights."""
        w = torch.exp(self._log_weights)
        return w / torch.sum(w)

    def parameters(self):
        params = {"log_weights": self._log_weights}
        sub = self.prior.parameters()
        if sub:
            params["prior"] = sub
        return params

    def set_parameters(self, params):
        if not params:
            return
        if "log_weights" in params:
            self._log_weights = params["log_weights"].detach().clone()
        self.prior.set_parameters(params.get("prior"))

    def to(self, device):
        self._log_weights = self._log_weights.to(device)
        self._kernels = tuple(k.to(device) for k in self._kernels)
        self.prior.to(device)
        return self

    def _level_shape(self, shape, idx):
        factor = 2**idx
        return tuple(shape[:-2]) + (shape[-2] // factor, shape[-1] // factor)

    def second_order_ok(self, flux_shape):
        """Whether the wrapped prior is twice differentiable at every
        level's shape (``flux_shape`` is the component's full shape)."""
        return all(
            self.prior.second_order_ok(self._level_shape(tuple(flux_shape),
                                                         idx))
            for idx in range(self.n_levels)
        )

    def draw_shifts(self, generator=None, shape=None):
        """``{"spin": (sy, sx) or None, "levels": [...]}``: the own cycle
        spin, then each level's draws at its shape, in level order."""
        gen = self.generator if generator is None else generator
        spin = (draw_cycle_spin(self.prior.patch_shape, gen)
                if self.cycle_spin else None)
        if shape is None:
            raise ValueError("MultiScalePrior draws at the flux's shape: "
                             "pass shape=")
        levels = [self.prior.draw_shifts(gen, self._level_shape(shape, idx))
                  for idx in range(self.n_levels)]
        return {"spin": spin, "levels": levels}

    def _kernel_fft(self, idx, flux):
        kernel = self._kernels[idx]
        return self._constant(
            ("kft", idx, tuple(flux.shape)), flux.device,
            lambda: kernel_fft(kernel.to(flux.device), flux.shape[-2:],
                               fft_conv_shape(flux.shape, kernel.shape)))

    def __call__(self, flux, params=None, generator=None, shifts=None):
        if shifts is None:
            shifts = self.draw_shifts(generator, tuple(flux.shape))
        if params is not None and "log_weights" in params:
            log_weights = params["log_weights"]
        else:
            log_weights = self._log_weights.to(flux.device)
        w = torch.exp(log_weights)
        weights = w / torch.sum(w)
        prior_params = None if params is None else params.get("prior")

        if self.cycle_spin:
            flux, _ = cycle_spin(flux, self.prior.patch_shape,
                                 shifts=shifts["spin"])
        log_like = 0.0
        for idx in range(self.n_levels):
            factor = 2**idx
            if self.anti_alias:
                flux = convolve_fft(flux, self._kernels[idx],
                                    kft=self._kernel_fft(idx, flux))
            h, w = flux.shape[-2:]
            level = flux[..., :(h // factor) * factor,
                         :(w // factor) * factor]
            value = self.prior(avg_pool(level, factor), params=prior_params,
                               shifts=shifts["levels"][idx])
            log_like = log_like + factor**2 * weights[idx] * value
        return log_like

    def to_dict(self):
        return dict(
            type="multiscale-prior",
            n_levels=self.n_levels,
            weights=self.weights.detach().cpu().numpy().tolist(),
            cycle_spin=self.cycle_spin,
            anti_alias=self.anti_alias,
            prior=self.prior.to_dict(),
        )

    @classmethod
    def from_dict(cls, data):
        kwargs = {k: v for k, v in data.items() if k != "type"}
        if kwargs.get("prior") is not None:
            kwargs["prior"] = Prior.from_dict(kwargs["prior"])
        return cls(**kwargs)
