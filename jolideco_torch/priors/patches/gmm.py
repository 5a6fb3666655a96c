"""Gaussian mixture model over image patches.

Counterpart of the JAX package's ``priors/patches/gmm.py``. The derived
scoring arrays are computed once on the host in float64 with the same
float32 roundings as the JAX package, so both packages pack identical
quadratic-form buffers. The registry holds the two GMMs shipped in the
JAX package's assets, read by path with ``np.load`` (importing the
JAX package would import JAX).
"""

from pathlib import Path

import numpy as np
import torch

from ...ops.gmm_fused import kernel_buffers, score_plain
from ...ops.gmm_pack import pack_gmm_buffers
from ...ops.linalg import compute_precision_cholesky
from ...ops.patches import get_pixel_weights
from ...utils.norms import SubtractMeanPatchNorm

__all__ = ["GMM_REGISTRY", "GaussianMixtureModel", "GaussianMixtureModelMeta"]

ASSETS_DIR = Path(__file__).resolve().parents[3] / "jolideco_tpu" / "assets"
GMM_REGISTRY = {
    "builtin-8x8-v1": ASSETS_DIR / "gmm-builtin-8x8.npz",
    "astro-snr-v1": ASSETS_DIR / "gmm-astro-snr-8x8.npz",
}


class GaussianMixtureModelMeta:
    """GMM meta data: patch stride and patch normalisation."""

    def __init__(self, stride=None, patch_norm=None):
        self.stride = stride
        self.patch_norm = patch_norm or SubtractMeanPatchNorm()


class GaussianMixtureModel:
    """Gaussian mixture model with weighted patch log-probabilities.

    Parameters
    ----------
    means : array ``(K, d)``
    covariances : array ``(K, d, d)``
    weights : array ``(K,)``
    precisions_cholesky : array ``(K, d, d)``
    meta : `GaussianMixtureModelMeta`, optional
    """

    def __init__(self, means, covariances, weights, precisions_cholesky,
                 meta=None):
        self.means = np.asarray(means, np.float32)
        self.covariances = np.asarray(covariances, np.float32)
        self.weights = np.asarray(weights, np.float32)
        self.meta = meta or GaussianMixtureModelMeta()

        # the JAX package rounds these to float32 before packing; do
        # the same so that both pack the same buffers
        means64 = np.asarray(means, np.float64)
        prec64 = np.asarray(precisions_cholesky, np.float64)
        means_prec = np.einsum("kd,kde->ke", means64, prec64).astype(np.float32)
        log_det = np.sum(
            np.log(np.einsum("kii->ki", prec64)), axis=1
        ).astype(np.float32)
        log_weights = np.log(np.asarray(weights, np.float64)).astype(np.float32)
        if self.meta.stride is None:
            pixel_weights = np.ones(self.patch_shape)
        else:
            pixel_weights = get_pixel_weights(self.patch_shape,
                                              self.meta.stride)
        pixel_weights = np.asarray(pixel_weights, np.float32).reshape(-1)
        self.packed = pack_gmm_buffers(means_prec, prec64, log_det,
                                       log_weights, pixel_weights)
        self._buffers = {}

    @property
    def patch_shape(self):
        npix = int(round(self.means.shape[-1] ** 0.5))
        return npix, npix

    @property
    def n_features(self):
        return self.covariances.shape[1]

    @property
    def n_components(self):
        return self.covariances.shape[0]

    def kernel_buffers(self, device):
        """Scoring buffers on ``device`` (built once per device)."""
        key = str(torch.device(device))
        if key not in self._buffers:
            self._buffers[key] = kernel_buffers(self.packed, device)
        return self._buffers[key]

    def score(self, x):
        """MAP score of normalised patches ``(N, d)``: ``(values, argmax)``.

        The plain quadratic-form scorer, differentiable through torch
        autograd. Its kernel (``ops/gmm_pallas.py::_score_kernel`` in the
        JAX package) is not ported yet, so a CUDA tensor raises.
        """
        if x.device.type != "cpu":
            raise NotImplementedError(
                "the patch-level GMM scoring kernel is not ported yet; "
                "on a CUDA card only the fused image-level scorer runs"
            )
        bufs = self.kernel_buffers(x.device)
        return score_plain(x, bufs["aq"], bufs["bq"], bufs["const2"])

    @classmethod
    def from_numpy(cls, means, covariances, weights, meta=None):
        """Build from raw numpy means/covariances/weights."""
        return cls(
            means=means,
            covariances=covariances,
            weights=weights,
            precisions_cholesky=compute_precision_cholesky(covariances),
            meta=meta,
        )

    @classmethod
    def from_registry(cls, name):
        """Build ``builtin-8x8-v1`` or ``astro-snr-v1`` from its asset."""
        if name not in GMM_REGISTRY:
            raise ValueError(
                f"GMM {name!r} is not available in the port; choose from "
                f"{list(GMM_REGISTRY)} (entries that need the external "
                "GMM library are not ported)"
            )
        with np.load(GMM_REGISTRY[name], allow_pickle=False) as data:
            means = data["means"]
            covariances = data["covariances"]
            weights = data["weights"]
            stride = int(data["stride"]) if "stride" in data else None
            norm = str(data["patch_norm"]) if "patch_norm" in data else (
                "subtract-mean"
            )
        if norm != "subtract-mean":
            raise NotImplementedError(f"patch norm {norm!r} is not ported yet")
        meta = GaussianMixtureModelMeta(stride=stride)
        return cls.from_numpy(means, covariances, weights, meta=meta)
