"""GMM patch prior (the JAX package's ``priors/patches/core.py``).

The log-prior of a flux image is the overlap-weighted mean of its patch
scores under a GMM: image norm, integer cycle spin, overlapping patches
(8x8 for the shipped GMMs), zero-flux patch masking, per-patch mean
subtraction, then the best component's log-probability per patch (MAP)
or the logsumexp over the components (``marginalize=True``). Two
branches compute it, as in the JAX package:

- the fused branch (``ops.gmm_fused``): extraction, masking, mean
  subtraction and scoring in one pass, a CUDA kernel on the card and
  its plain version on the CPU;
- the grouped branch for GMMs the fused scorer does not take (patches
  other than 8x8), and for everything when the fused switch is off
  (``config.force_fused("off")``): grouped extraction, masking and mean
  subtraction in PyTorch, then the patch-level scorer
  (``ops.gmm_pallas``), CUDA kernels for 8x8 patches on the card and
  the plain versions on the CPU. It is twice differentiable, which the
  fused branch is not: the Hessian probe of the flux errors takes it.

Not ported yet, and raising ``NotImplementedError`` on every device:
``jitter``, ``patch_fraction < 1`` and ``cycle_spin_subpix``.
"""

from math import sqrt

import numpy as np
import torch

from ...config import gmm_mode, use_fused
from ...ops.gmm_fused import fused_supported, gmm_score_fused_image
from ...ops.image import cycle_spin, draw_cycle_spin
from ...ops.patches import view_as_overlapping_patches_grouped
from ...utils.norms import IdentityImageNorm, SubtractMeanPatchNorm
from ..core import Prior
from .gmm import GaussianMixtureModel

__all__ = ["GMMPatchPrior", "ZERO_FLUX_SENTINEL"]

ZERO_FLUX_SENTINEL = -1e5


class GMMPatchPrior(Prior):
    """Patch prior scoring overlapping patches under a GMM.

    Parameters
    ----------
    gmm : `GaussianMixtureModel`, optional
        Defaults to the registry's ``zoran-weiss``, which resolves to the
        shipped ``astro-snr-v1`` with a warning, as in the JAX package.
    stride : int, optional
        Patch stride; defaults to the GMM's meta stride.
    cycle_spin : bool
        Random integer roll each evaluation.
    norm : image norm, optional
        Defaults to the identity.
    marginalize : bool
        Score each patch by the logsumexp over the components instead of
        the best component.
    seed : int
        Seed of the prior's own generator (used when a call passes
        none).
    patch_norm : `SubtractMeanPatchNorm`, optional
        Defaults to the GMM's; only the mean subtraction is ported.
    cycle_spin_subpix, jitter, patch_fraction :
        Accepted for signature parity; anything but the defaults raises
        ``NotImplementedError`` until ported.
    """

    def __init__(self, gmm=None, stride=None, cycle_spin=True,
                 cycle_spin_subpix=False, norm=None, patch_norm=None,
                 jitter=False, marginalize=False, patch_fraction=1.0,
                 seed=0):
        super().__init__(seed=seed)
        unported = {
            "cycle_spin_subpix": cycle_spin_subpix,
            f"patch_norm={patch_norm!r}": patch_norm is not None
            and type(patch_norm) is not SubtractMeanPatchNorm,
            "jitter": jitter,
            "patch_fraction < 1": patch_fraction < 1.0,
        }
        for name, requested in unported.items():
            if requested:
                raise NotImplementedError(
                    f"GMMPatchPrior({name}) is not ported yet"
                )
        if gmm is None:
            gmm = GaussianMixtureModel.from_registry("zoran-weiss")
        self.gmm = gmm
        self.stride = int(gmm.meta.stride if stride is None else stride)
        self.cycle_spin = bool(cycle_spin)
        self.marginalize = bool(marginalize)
        self.norm = norm if norm is not None else IdentityImageNorm()
        self.patch_norm = (gmm.meta.patch_norm if patch_norm is None
                           else patch_norm)

    @property
    def patch_shape(self):
        npix = int(sqrt(self.gmm.means.shape[-1]))
        return npix, npix

    @property
    def log_like_weight(self):
        """Per-patch weight correcting for patch overlap."""
        return self.stride**2 / float(np.prod(self.patch_shape))

    def parameters(self):
        norm_params = self.norm.parameters()
        return {"norm": norm_params} if norm_params else {}

    def draw_shifts(self, generator=None):
        """The cycle spin ``(sy, sx)`` of one evaluation (``None`` without
        cycle spin), drawn as :meth:`__call__` would draw it."""
        if not self.cycle_spin:
            return None
        return draw_cycle_spin(
            self.patch_shape,
            self.generator if generator is None else generator,
        )

    def _fused_ok(self, shape):
        return (
            use_fused() != "off"
            and type(self.patch_norm) is SubtractMeanPatchNorm
            and fused_supported(shape, self.patch_shape, self.stride,
                                self.gmm.n_features)
        )

    def second_order_ok(self, flux_shape):
        """Whether the log-prior is twice differentiable at this shape.

        Not when the fused scorer would run: its backward kernel has no
        derivative, so the Hessian probe turns the fused switch off
        first. The image norm and the cycle spin keep the shape.
        """
        return not self._fused_ok(tuple(flux_shape))

    def _evaluate_log_like(self, flux, params=None, generator=None,
                           shifts=None):
        """Per-patch ``(values, argmax, valid, shifts)``."""
        norm_params = None if params is None else params.get("norm")
        normed = self.norm(flux, params=norm_params)

        applied = (0, 0)
        if self.cycle_spin:
            normed, applied = cycle_spin(
                normed, self.patch_shape,
                generator=self.generator if generator is None else generator,
                shifts=shifts,
            )

        if self._fused_ok(normed.shape):
            values, argmax, valid = gmm_score_fused_image(
                normed, self.patch_shape, self.stride,
                self.gmm.kernel_buffers(normed.device), ZERO_FLUX_SENTINEL,
                marginalize=self.marginalize, mode=gmm_mode(),
            )
            return values, argmax, valid, applied

        if self.patch_shape[0] % self.stride:
            raise NotImplementedError(
                "strides that do not divide the patch edge are not "
                "ported yet"
            )
        patches = view_as_overlapping_patches_grouped(
            normed, shape=self.patch_shape, stride=self.stride
        )
        valid = torch.all(patches > ZERO_FLUX_SENTINEL, dim=1)
        patches = torch.where(valid[:, None], patches,
                              torch.zeros_like(patches))
        values, argmax = self.gmm.score(self.patch_norm(patches),
                                        marginalize=self.marginalize)
        return values, argmax, valid, applied

    def __call__(self, flux, params=None, generator=None, shifts=None):
        """Scalar log-prior: overlap-weighted mean of the patch scores.

        ``shifts=(sy, sx)`` fixes the cycle spin instead of drawing it.
        """
        values, _, valid, _ = self._evaluate_log_like(
            flux, params=params, generator=generator, shifts=shifts
        )
        values = torch.where(valid, values, torch.zeros_like(values))
        return values.sum() * self.log_like_weight / flux.numel()
