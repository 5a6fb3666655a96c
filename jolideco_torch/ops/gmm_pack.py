"""GMM buffers in quadratic-form layout (numpy).

Counterpart of the JAX package's ``ops/gmm_pallas.py::pack_gmm_buffers``.
With precision-Cholesky factors ``L_k``, pixel weights ``W`` and
whitened means ``m'_k = mu_k L_k``, the weighted Mahalanobis term is a
quadratic form

    q_k(x) = x A_k x^T - 2 x b_k + c_k,
    A_k = L_k W L_k^T,  b_k = m'_k W L_k^T,  c_k = m'_k W m'_k^T,

and the logit is ``-q_k / 2 - d log(2 pi) / 2 + log|L_k| + log pi_k``.
Products are taken in float64 on the host and cast to float32 once.
Components are not padded: the CUDA kernels loop over exactly K.
"""

import numpy as np

__all__ = ["LOG_2PI", "pack_gmm_buffers"]

LOG_2PI = float(np.log(2.0 * np.pi))


def pack_gmm_buffers(means_prec, prec_chol, log_det, log_weights,
                     pixel_weights):
    """Quadratic-form buffers of a GMM.

    Returns
    -------
    dict of numpy arrays
        float32 ``aq (d*d, K)`` with ``aq[j*d + e, k] = A_k[j, e]``,
        ``bq (d, K)`` with ``bq[:, k] = b_k`` and ``const2 (1, K)``
        holding ``-d log(2 pi)/2 + log|L_k| + log pi_k - c_k/2``: the
        first K columns of the JAX package's arrays of the same names.
        Also float64 ``a_quad (K, d, d)``, from which the CUDA kernel's
        own layout is cut (``ops.gmm_fused.kernel_buffers``).
    """
    prec_chol = np.asarray(prec_chol, np.float64)
    means_prec = np.asarray(means_prec, np.float64)
    w = np.asarray(pixel_weights, np.float64).reshape(-1)
    k, d, _ = prec_chol.shape

    a_quad = np.einsum("kde,e,kje->kdj", prec_chol, w, prec_chol)
    b_quad = np.einsum("ke,e,kje->kj", means_prec, w, prec_chol)
    c_quad = np.einsum("ke,e,ke->k", means_prec, w, means_prec)

    aq = np.ascontiguousarray(a_quad.reshape(k, d * d).T, dtype=np.float32)
    bq = np.ascontiguousarray(b_quad.T, dtype=np.float32)
    const2 = (
        -0.5 * d * LOG_2PI
        + np.asarray(log_det, np.float64)
        + np.asarray(log_weights, np.float64)
        - 0.5 * c_quad
    ).astype(np.float32)[None, :]
    return {"aq": aq, "bq": bq, "const2": const2, "a_quad": a_quad}
