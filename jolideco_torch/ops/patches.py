"""Overlapping-patch helpers (the JAX package's ``ops/patches.py``).

Patch elements are row-major within a patch. The grouped enumeration
decomposes the stride-``s`` overlapping grid into ``(p/s)²`` offset
classes; each class is a non-overlapping tiling taken with one slice
and a reshape, and classes follow each other (group-major order).
"""

import numpy as np

__all__ = ["get_pixel_weights", "view_as_overlapping_patches_grouped"]


def view_as_overlapping_patches_grouped(image, shape, stride):
    """Overlapping patches of ``image (..., H, W)`` in group order.

    Same patch set and order as the JAX function: offset groups
    ``(a, b)`` for ``a, b in range(0, p, s)``, each the
    ``((H-a)//p) x ((W-b)//p)`` tiling starting at ``(a, b)``.

    Returns
    -------
    patches : tensor ``(n_patches, p * p)``
    """
    import torch

    p, s = shape[0], stride
    h, w = image.shape[-2:]
    if shape[0] != shape[1] or p % s != 0:
        raise ValueError(
            "grouped extraction needs square patches with stride | patch; "
            f"got shape={shape}, stride={stride}"
        )
    img = image.reshape(h, w)
    groups = []
    for a in range(0, p, s):
        for b in range(0, p, s):
            na = (h - a) // p
            nb = (w - b) // p
            sl = img[a:a + na * p, b:b + nb * p]
            pt = sl.reshape(na, p, nb, p).permute(0, 2, 1, 3)
            groups.append(pt.reshape(na * nb, p * p))
    return torch.cat(groups, dim=0)


def _evaluate_trapez(x, width, slope):
    """One-dimensional trapezoid profile."""
    x = np.asarray(x, dtype=np.float64)
    x2 = min(-width / 2.0, 0)
    x3 = max(width / 2.0, 0)
    x1 = x2 - 1.0 / slope
    x4 = x3 + 1.0 / slope

    range_a = np.logical_and(x >= x1, x < x2)
    range_b = np.logical_and(x >= x2, x < x3)
    range_c = np.logical_and(x >= x3, x < x4)
    val_a = slope * (x - x1)
    val_c = slope * (x4 - x)
    return np.select([range_a, range_b, range_c], [val_a, 1, val_c])


def get_pixel_weights(patch_shape, stride):
    """Trapezoidal per-pixel weights down-weighting patch overlap.

    Host-side numpy, normalised to sum to ``stride**2``.
    """
    width = np.max(patch_shape)
    overlap = width - stride

    if overlap == 0:
        return np.full(patch_shape, stride**2 / float(np.prod(patch_shape)))

    value = (width - 1.0) / 2
    x = np.linspace(-value, value, width)

    values = _evaluate_trapez(x=x, width=(stride - overlap), slope=1.0 / overlap)
    weights = values * values[:, np.newaxis]
    weights = weights / weights.sum() * stride**2
    return weights
