"""GMM log-probabilities of normalised patches (the JAX package's
``ops/gmm_score.py``).

For patches ``x_n`` (``d`` pixels) and components ``k`` with
precision-Cholesky factors ``P_k``, whitened means ``mu_k P_k`` and
trapezoidal pixel weights ``w``::

    q[n, k]      = sum_j w_j ((x_n P_k)_j - (mu_k P_k)_j)^2
    logits[n, k] = -(d log(2 pi) + q[n, k]) / 2 + log|P_k| + log pi_k

:func:`gmm_log_prob_matrix` forms the whole ``(N, K)`` matrix;
:func:`gmm_score` reduces it over the components (max and argmax, or the
logsumexp) on the port's patch-level scorer (``ops.gmm_pallas
.gmm_score_patches`` in its float32 mode: the plain version on the CPU),
twice differentiable with respect to the patches.
"""

import numpy as np
import torch

from .gmm_fused import kernel_buffers
from .gmm_pack import LOG_2PI, pack_gmm_buffers
from .gmm_pallas import gmm_score_patches

__all__ = ["GMMArrays", "gmm_log_prob_matrix", "gmm_score"]


class GMMArrays:
    """A GMM's scoring arrays as tensors.

    Attributes
    ----------
    means_prec : ``(K, d)``, ``mu_k P_k``
    prec_chol : ``(K, d, d)``
    log_det : ``(K,)``, ``log |P_k|``
    log_weights : ``(K,)``
    pixel_weights : ``(d,)``, the trapezoidal overlap weights, flattened
    """

    def __init__(self, means_prec, prec_chol, log_det, log_weights,
                 pixel_weights):
        self.means_prec = torch.as_tensor(means_prec)
        self.prec_chol = torch.as_tensor(prec_chol)
        self.log_det = torch.as_tensor(log_det)
        self.log_weights = torch.as_tensor(log_weights)
        self.pixel_weights = torch.as_tensor(pixel_weights).reshape(-1)

    def astuple(self):
        return (self.means_prec, self.prec_chol, self.log_det,
                self.log_weights, self.pixel_weights)

    @property
    def n_components(self):
        return self.prec_chol.shape[0]

    @property
    def n_features(self):
        return self.prec_chol.shape[1]


def gmm_log_prob_matrix(patches, means_prec, prec_chol, log_det, log_weights,
                        pixel_weights, precision="highest"):
    """The full ``(N, K)`` weighted log-probability matrix of ``patches``
    ``(N, d)`` (the reference's ``estimate_log_prob``), in float32
    products; ``precision`` is accepted for the JAX signature."""
    y = (torch.einsum("nd,kdj->knj", patches, prec_chol)
         - means_prec[:, None, :])
    q = torch.einsum("knj,j->kn", torch.square(y), pixel_weights)
    const = -0.5 * patches.shape[-1] * LOG_2PI + log_det + log_weights
    return -0.5 * q.T + const


def gmm_score(patches, means_prec, prec_chol, log_det, log_weights,
              pixel_weights, marginalize=False, precision="highest"):
    """Per-patch score of ``patches`` ``(N, d)``: ``(values, argmax)``,
    ``values`` the best component's logit (MAP) or the logsumexp over the
    components (``marginalize``), ``argmax`` the best component (int32).
    ``values`` is twice differentiable with respect to ``patches``; the
    GMM's arrays take no gradient. ``precision`` is accepted for the JAX
    signature: the scorer's logits are float32."""
    packed = pack_gmm_buffers(*(np.asarray(torch.as_tensor(a).detach().cpu())
                                for a in (means_prec, prec_chol, log_det,
                                          log_weights, pixel_weights)))
    return gmm_score_patches(patches, kernel_buffers(packed, patches.device),
                             marginalize=marginalize, mode="f32")
