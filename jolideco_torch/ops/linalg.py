"""Linear-algebra helpers for the GMM (the JAX package's ``ops/linalg.py``)."""

import numpy as np

__all__ = ["compute_precision_cholesky"]


def compute_precision_cholesky(covariances):
    """Cholesky factors of the precision matrices of a GMM.

    For each covariance ``S`` computes ``P`` with ``P @ P.T = S^{-1}``,
    laid out like sklearn's ``precisions_cholesky_``:
    ``P = solve_triangular(chol(S, lower), I, lower).T``. Host-side
    float64; the GMM is built once.

    Parameters
    ----------
    covariances : array ``(K, d, d)``

    Returns
    -------
    precisions_chol : array ``(K, d, d)`` float64
    """
    from scipy import linalg

    covariances = np.asarray(covariances)
    shape = covariances.shape
    precisions_chol = np.empty(shape)

    for k, covariance in enumerate(covariances):
        try:
            cov_chol = linalg.cholesky(covariance, lower=True)
        except linalg.LinAlgError:
            raise ValueError(f"Cholesky decomposition failed for component {k}")

        precisions_chol[k] = linalg.solve_triangular(
            cov_chol, np.eye(shape[1]), lower=True
        ).T

    return precisions_chol
