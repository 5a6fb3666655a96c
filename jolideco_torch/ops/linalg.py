"""Linear-algebra helpers: the GMM's precision factors (the JAX
package's ``ops/linalg.py``), the bf16 rounding of the precision dial's
``"bf16"`` mode, the bf16 hi/lo split of its ``"split"`` mode and the
three-way split of the float32 matrix-DFT kernels (``"highest"``)."""

import numpy as np

from .splitfp import bf16_round

__all__ = ["bf16_round", "bf16_split", "bf16_split3",
           "compute_precision_cholesky"]


def bf16_split(x):
    """``(hi, lo)`` of a float32 tensor, each bf16-valued in float32:
    ``hi = bf16(x)``, ``lo = bf16(x - hi)`` (round to nearest even)."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def bf16_split3(x):
    """``(hi, mid, lo)`` of a float32 tensor, each bf16-valued in
    float32: ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi
    - mid)`` (round to nearest even; both differences are exact)."""
    hi = bf16_round(x)
    rest = x - hi
    mid = bf16_round(rest)
    return hi, mid, bf16_round(rest - mid)


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
