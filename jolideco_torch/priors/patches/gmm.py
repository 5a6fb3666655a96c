"""Gaussian mixture model over image patches.

Counterpart of the JAX package's ``priors/patches/gmm.py``. The derived
scoring arrays are computed once on the host in float64 with the same
float32 roundings as the JAX package, so both packages pack identical
quadratic-form buffers. The registry holds the two GMMs the port ships
in ``jolideco_torch/assets/`` (byte-for-byte copies of the JAX
package's), read with ``np.load``. The names of the reference's external
GMM library (``zoran-weiss`` and three more) resolve to the shipped
``astro-snr-v1`` with a warning, as in the JAX package when that library
is not installed. A GMM reads the JAX package's formats (``npz``, the
EPLL matlab files, astropy tables) and writes ``npz``; its diagnostics
(log-probabilities, KL divergences, eigen and mean images) are the JAX
package's, on the host in numpy or, for ``estimate_log_prob``, in torch.
"""

import logging
import os
from pathlib import Path

import numpy as np
import torch

from ...config import gmm_mode
from ...ops.gmm_fused import kernel_buffers
from ...ops.gmm_pallas import gmm_score_patches
from ...ops.gmm_pack import pack_gmm_buffers
from ...ops.linalg import compute_precision_cholesky
from ...ops.patches import get_pixel_weights
from ...utils.misc import format_class_str
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
        self.precisions_cholesky = np.asarray(precisions_cholesky,
                                              np.float32)
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
        # the JAX package's scoring arrays, for estimate_log_prob
        self._score_arrays = (means_prec, log_det, log_weights,
                              pixel_weights)
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

    def estimate_log_prob(self, x):
        """The full ``(N, K)`` weighted log-probability matrix of the
        normalised patches ``x`` ``(N, d)`` (a tensor; float32 torch on
        its device, the JAX package's ``estimate_log_prob``). The
        training loop uses :meth:`score`, which never forms it."""
        means_prec, log_det, log_weights, pixel_weights = (
            torch.as_tensor(a, device=x.device) for a in self._score_arrays)
        prec = torch.as_tensor(self.precisions_cholesky, device=x.device)
        y = torch.einsum("nd,kdj->knj", x, prec) - means_prec[:, None, :]
        q = torch.einsum("knj,j->kn", torch.square(y), pixel_weights)
        const = -0.5 * self.n_features * np.log(2 * np.pi) + log_det
        return -0.5 * q.T + (const + log_weights)

    def estimate_log_prob_numpy(self, x):
        """:meth:`estimate_log_prob` in float64 numpy."""
        x = np.asarray(x, np.float64)
        means = np.asarray(self.means, np.float64)
        prec = np.asarray(self.precisions_cholesky, np.float64)
        pw = np.asarray(self._score_arrays[3], np.float64)

        log_prob = np.empty((x.shape[0], self.n_components))
        for k, (mu, prec_chol) in enumerate(zip(means, prec)):
            y = np.dot(x, prec_chol) - np.dot(mu, prec_chol)
            log_prob[:, k] = np.sum(np.square(y) * pw, axis=1)

        log_det = np.sum(np.log(np.einsum("kii->ki", prec)), axis=1)
        return (
            -0.5 * (x.shape[1] * np.log(2 * np.pi) + log_prob)
            + log_det
            + np.log(np.asarray(self.weights, np.float64))
        )

    @classmethod
    def from_sklearn_gmm(cls, gmm):
        """Build from a fitted ``sklearn.mixture.GaussianMixture``."""
        return cls.from_numpy(means=gmm.means_,
                              covariances=gmm.covariances_,
                              weights=gmm.weights_)

    @classmethod
    def from_registry(cls, name, **kwargs):
        """Build ``builtin-8x8-v1`` or ``astro-snr-v1`` from its asset
        (``kwargs`` go to :meth:`read` over the entry's ``filename`` and
        ``format``); a name of :data:`REFERENCE_LIBRARY_ALIASES` builds
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
        gmm = cls.read(**{"filename": path, "format": "npz", **kwargs})
        gmm._registry_name = name
        return gmm

    @classmethod
    def read(cls, filename, format="npz", **kwargs):
        """Read a GMM from a file.

        ``format`` is ``"npz"`` (the native format: ``means``,
        ``covariances``, ``weights`` and optionally ``stride`` and
        ``patch_norm``), ``"epll-matlab"`` or ``"epll-matlab-16x16"``
        (the EPLL matlab files, through ``scipy.io``) or ``"table"`` (an
        astropy table; needs astropy). ``$VARIABLES`` in ``filename``
        expand.
        """
        filename = Path(os.path.expandvars(str(filename)))

        if format == "npz":
            with np.load(filename, allow_pickle=False) as data:
                means = data["means"]
                covariances = data["covariances"]
                weights = data["weights"]
                stride = int(data["stride"]) if "stride" in data else None
                patch_norm_type = (str(data["patch_norm"])
                                   if "patch_norm" in data
                                   else "subtract-mean")
            meta = GaussianMixtureModelMeta(
                stride=stride,
                patch_norm=PatchNorm.from_dict({"type": patch_norm_type}))
        elif format == "epll-matlab":
            import scipy.io as sio

            gmm_data = sio.loadmat(str(filename))["GS"]
            means = gmm_data["means"][0][0].T
            covariances = gmm_data["covs"][0][0].T
            weights = gmm_data["mixweights"][0][0][:, 0]
            meta = GaussianMixtureModelMeta(
                stride=4, patch_norm=SubtractMeanPatchNorm())
        elif format == "epll-matlab-16x16":
            import scipy.io as sio

            gmm_data = sio.loadmat(str(filename))["GMM"]
            covariances = gmm_data["covs"][0][0].T
            weights = gmm_data["mixweights"][0][0][:, 0]
            # zero means sized from the data
            means = np.zeros(covariances.shape[:2])
            meta = GaussianMixtureModelMeta(
                stride=8, patch_norm=SubtractMeanPatchNorm())
        elif format == "table":
            try:
                from astropy.table import Table
            except ImportError as exc:
                raise ImportError(
                    "Reading 'table'-format GMMs requires astropy, which "
                    "is not installed. Convert to 'npz' instead."
                ) from exc
            table = Table.read(str(filename))
            means = table["means"].data
            weights = table["weights"].data
            covariances = table["covariances"].data
            patch_norm_type = table.meta.get("PNPTYPE", "subtract-mean")
            npix = int((table["means"].shape[-1]) ** 0.5)
            meta = GaussianMixtureModelMeta(
                stride=npix // 2,
                patch_norm=PatchNorm.from_dict({"type": patch_norm_type}))
        else:
            raise ValueError(f"Not a supported format {format}")

        return cls.from_numpy(means=means, covariances=covariances,
                              weights=weights, meta=meta, **kwargs)

    def write(self, filename):
        """Write in the native ``npz`` format."""
        data = {"means": self.means, "covariances": self.covariances,
                "weights": self.weights}
        if self.meta.stride is not None:
            data["stride"] = np.int64(self.meta.stride)
        data["patch_norm"] = np.str_(
            self.meta.patch_norm.to_dict().get("type", "subtract-mean"))
        np.savez_compressed(filename, **data)

    def reduce_to_topk(self, k):
        """The GMM of the ``k`` components of highest weight."""
        idx = np.argsort(self.weights)[::-1][:k]
        return self.__class__.from_numpy(
            means=self.means[idx], covariances=self.covariances[idx],
            weights=self.weights[idx], meta=self.meta)

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

    def _plot_images(self, images, ncols, figsize):
        import matplotlib.pyplot as plt

        nrows = -(-self.n_components // ncols)
        if figsize is None:
            width = 12
            figsize = (width, width * nrows / ncols)
        _, axes = plt.subplots(ncols=ncols, nrows=nrows, figsize=figsize)
        for idx, ax in enumerate(np.atleast_1d(axes).flat):
            if idx >= self.n_components:
                ax.set_visible(False)
                continue
            ax.imshow(images[idx])
            ax.set_axis_off()
            ax.set_title(f"{idx}")

    def plot_eigen_images(self, ncols=20, figsize=None):
        """Plot the eigen images (matplotlib)."""
        self._plot_images(self.eigen_images, ncols, figsize)

    def plot_mean_images(self, ncols=20, figsize=None):
        """Plot the mean images (matplotlib)."""
        self._plot_images(self.means.reshape((-1,) + self.patch_shape),
                          ncols, figsize)

    @property
    def covariance_det(self):
        """Determinant of the first covariance matrix."""
        return np.linalg.det(self.covariances[0])

    def kl_divergence(self, other):
        """KL divergence from another single-component GMM."""
        if not (self.n_components == 1 and other.n_components == 1):
            raise ValueError(
                "KL divergence can only be computed for single component GMM"
            )
        k = self.means.shape[1]
        precision_other = np.linalg.inv(other.covariances[0])
        diff = self.means[0] - other.means[0]
        term_mean = diff.T @ precision_other @ diff
        term_trace = np.trace(precision_other @ self.covariances[0])
        term_log = np.log(other.covariance_det / self.covariance_det)
        return 0.5 * (term_log - k + term_mean + term_trace)

    def symmetric_kl_divergence(self, other):
        """The KL divergence both ways, summed."""
        return other.kl_divergence(other=self) + self.kl_divergence(
            other=other)

    def is_equal(self, other):
        """Covariances of the same shape and ``np.allclose``."""
        if not self.covariances.shape == other.covariances.shape:
            return False
        return np.allclose(self.covariances, other.covariances)

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

    def __str__(self):
        return format_class_str(instance=self)
