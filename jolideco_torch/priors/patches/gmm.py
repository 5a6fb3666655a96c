"""Gaussian mixture model over image patches.

Counterpart of the JAX package's ``priors/patches/gmm.py``. The derived
scoring arrays are computed once on the host in float64 with the same
float32 roundings as the JAX package, so both packages pack identical
quadratic-form buffers. The registry holds the two GMMs the port ships
in ``jolideco_torch/assets/`` (byte-for-byte copies of the JAX
package's), read with ``np.load``. The names of the reference's external
GMM library (``zoran-weiss`` and three more) resolve to the shipped
``astro-snr-v1`` with a warning, as in the JAX package when that library
is not installed.
"""

import logging
from pathlib import Path

import numpy as np
import torch

from ...config import gmm_mode
from ...ops.gmm_fused import kernel_buffers
from ...ops.gmm_pallas import gmm_score_patches
from ...ops.gmm_pack import pack_gmm_buffers
from ...ops.linalg import compute_precision_cholesky
from ...ops.patches import get_pixel_weights
from ...utils.norms import PatchNorm, SubtractMeanPatchNorm

__all__ = ["GMM_REGISTRY", "GaussianMixtureModel", "GaussianMixtureModelMeta",
           "REFERENCE_LIBRARY_ALIASES"]

log = logging.getLogger(__name__)

ASSETS_DIR = Path(__file__).resolve().parents[2] / "assets"
GMM_REGISTRY = {
    "builtin-8x8-v1": ASSETS_DIR / "gmm-builtin-8x8.npz",
    "astro-snr-v1": ASSETS_DIR / "gmm-astro-snr-8x8.npz",
}
# names of the reference's external GMM library; without it they
# resolve to the shipped model closest to them, with a warning
REFERENCE_LIBRARY_ALIASES = (
    "zoran-weiss",
    "gleam-v0.1",
    "jwst-cas-a-v0.1",
    "chandra-snrs-v0.1",
)
ALIAS_SUBSTITUTE = "astro-snr-v1"


class GaussianMixtureModelMeta:
    """GMM meta data: patch stride and patch normalisation (compared by
    value)."""

    def __init__(self, stride=None, patch_norm=None):
        self.stride = stride
        self.patch_norm = patch_norm or SubtractMeanPatchNorm()

    def __eq__(self, other):
        return (type(other) is type(self) and other.stride == self.stride
                and other.patch_norm == self.patch_norm)

    def __hash__(self):
        return hash((self.stride, self.patch_norm))


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

    # the registry name of a model built by from_registry (to_dict)
    _registry_name = None

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

    def score(self, x, marginalize=False):
        """Scores of normalised patches ``(N, d)``: ``(values, argmax)``.

        ``values`` is the best component's log-probability (MAP) or the
        logsumexp over the components (``marginalize``). The patch-level
        scorer (``ops.gmm_pallas.gmm_score_patches``): CUDA kernels for
        8x8 patches on a card, the plain versions on the CPU; twice
        differentiable. The logits, MAP and marginalised, and those the
        marginalised derivatives recompute, follow the precision dial
        (``config.gmm_mode()``), as the JAX package's scorer follows
        its ``gmm_precision()``.
        """
        return gmm_score_patches(x, self.kernel_buffers(x.device),
                                 marginalize=marginalize, mode=gmm_mode())

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
        """Build ``builtin-8x8-v1`` or ``astro-snr-v1`` from its asset;
        a name of :data:`REFERENCE_LIBRARY_ALIASES` builds
        ``astro-snr-v1`` and logs a warning."""
        if name in REFERENCE_LIBRARY_ALIASES:
            log.warning(
                f"GMM {name!r} refers to a model from the external "
                "jolideco-gmm-prior-library, which is not installed "
                "($JOLIDECO_GMM_LIBRARY unset or missing the entry); "
                f"substituting the shipped {ALIAS_SUBSTITUTE!r} model. "
                "Results will differ numerically from the reference "
                "library model."
            )
            path = GMM_REGISTRY[ALIAS_SUBSTITUTE]
        elif name in GMM_REGISTRY:
            path = GMM_REGISTRY[name]
        else:
            raise ValueError(
                f"GMM {name!r} is not available in the port; choose from "
                f"{list(GMM_REGISTRY) + list(REFERENCE_LIBRARY_ALIASES)}"
            )
        with np.load(path, allow_pickle=False) as data:
            means = data["means"]
            covariances = data["covariances"]
            weights = data["weights"]
            stride = int(data["stride"]) if "stride" in data else None
            norm = str(data["patch_norm"]) if "patch_norm" in data else (
                "subtract-mean"
            )
        meta = GaussianMixtureModelMeta(
            stride=stride, patch_norm=PatchNorm.from_dict({"type": norm}))
        gmm = cls.from_numpy(means, covariances, weights, meta=meta)
        gmm._registry_name = name
        return gmm

    @property
    def eigen_images(self):
        """Per-component eigen images ``(K, p, p)``: each covariance's
        eigenvectors times its eigenvalues (``scipy.linalg.eigh``)."""
        from scipy import linalg

        images = []
        for covariance in self.covariances:
            w, v = linalg.eigh(covariance)
            images.append((v @ w).reshape(self.patch_shape))
        return np.stack(images)

    def to_dict(self):
        """A registry model as its name, any other inline (its arrays,
        stride and patch norm), in the JAX package's format."""
        if self._registry_name is not None:
            return {"type": self._registry_name}
        data = {"type": "inline", "means": self.means,
                "covariances": self.covariances, "weights": self.weights}
        if self.meta.stride is not None:
            data["stride"] = int(self.meta.stride)
        data["patch_norm"] = self.meta.patch_norm.to_dict()
        return data

    @classmethod
    def from_dict(cls, data):
        """Build from a registry-name or inline dict."""
        if data["type"] != "inline":
            return cls.from_registry(data["type"])
        meta = GaussianMixtureModelMeta(
            stride=data.get("stride"),
            patch_norm=PatchNorm.from_dict(
                dict(data.get("patch_norm", {"type": "subtract-mean"}))),
        )
        return cls.from_numpy(np.asarray(data["means"]),
                              np.asarray(data["covariances"]),
                              np.asarray(data["weights"]), meta=meta)
