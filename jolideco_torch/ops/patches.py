"""Overlapping-patch helpers (the JAX package's ``ops/patches.py``).

Patch elements are row-major within a patch. The grouped enumeration
decomposes the stride-``s`` overlapping grid into ``(p/s)²`` offset
classes; each class is a non-overlapping tiling taken with one slice
and a reshape, and classes follow each other (group-major order). The
row-major enumeration (:func:`view_as_overlapping_patches`) takes any
stride. Jittered patches are gathered at corners drawn ahead
(:func:`draw_patch_jitter`); their backward adds overlapping patches
into the image (with atomics on a card).
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "count_overlapping_patches",
    "count_random_patches",
    "draw_patch_jitter",
    "evaluate_trapez",
    "extract_patches_at",
    "get_pixel_weights",
    "grouped_patch_corners",
    "random_patch_indices",
    "reconstruct_from_overlapping_patches",
    "reconstruct_from_overlapping_patches_at",
    "view_as_overlapping_patches",
    "view_as_overlapping_patches_grouped",
    "view_as_random_overlapping_patches",
    "view_as_single_group_patches",
]


def extract_patches_at(image, idy, idx, shape):
    """Patches ``(n, ph * pw)`` of ``image (H, W)`` with top-left corners
    ``(idy, idx)`` (integer tensors of one shape ``(n,)``)."""
    ph, pw = shape
    dy = torch.arange(ph, device=image.device)
    dx = torch.arange(pw, device=image.device)
    rows = idy[:, None, None] + dy[None, :, None]
    cols = idx[:, None, None] + dx[None, None, :]
    return image[rows, cols].reshape((-1, ph * pw))


def view_as_overlapping_patches(image, shape, stride=None):
    """Overlapping patches of ``image (..., H, W)`` in row-major order of
    their corners, any stride (default half the patch): ``(n, ph * pw)``.
    """
    if stride is None:
        stride = shape[0] // 2
    h, w = image.shape[-2], image.shape[-1]
    cols = F.unfold(image.reshape(1, 1, h, w), tuple(shape),
                    stride=int(stride))
    return cols[0].transpose(0, 1)


def view_as_overlapping_patches_grouped(image, shape, stride):
    """Overlapping patches of ``image (..., H, W)`` in group order.

    Same patch set and order as the JAX function: offset groups
    ``(a, b)`` for ``a, b in range(0, p, s)``, each the
    ``((H-a)//p) x ((W-b)//p)`` tiling starting at ``(a, b)``.

    Returns
    -------
    patches : tensor ``(n_patches, p * p)``
    """
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


def grouped_patch_corners(image_shape, shape, stride):
    """Corners ``(n, 2)`` of ``(y, x)`` in the order of
    :func:`view_as_overlapping_patches_grouped` (numpy)."""
    p, s = shape[0], stride
    h, w = image_shape[-2:]
    corners = []
    for a in range(0, p, s):
        for b in range(0, p, s):
            cy = a + p * np.arange((h - a) // p)
            cx = b + p * np.arange((w - b) // p)
            yy, xx = np.meshgrid(cy, cx, indexing="ij")
            corners.append(np.stack([yy.ravel(), xx.ravel()], axis=-1))
    return np.concatenate(corners, axis=0)


def view_as_single_group_patches(image, shape, stride, group_index,
                                 pad_value):
    """One offset class (``group_index``, a Python int) of the grouped
    decomposition, padded with ``pad_value`` rows to the largest class.

    Returns
    -------
    patches : tensor ``(gmax, p * p)``
    n_kept : int
        The class's real (non-padding) rows.
    """
    p, s = shape[0], stride
    h, w = image.shape[-2:]
    if shape[0] != shape[1] or p % s != 0:
        raise ValueError(
            "grouped extraction needs square patches with stride | patch; "
            f"got shape={shape}, stride={stride}"
        )
    offsets = [(a, b) for a in range(0, p, s) for b in range(0, p, s)]
    gmax = max(((h - a) // p) * ((w - b) // p) for a, b in offsets)
    a, b = offsets[int(group_index)]
    na, nb = (h - a) // p, (w - b) // p
    sl = image.reshape(h, w)[a:a + na * p, b:b + nb * p]
    pt = sl.reshape(na, p, nb, p).permute(0, 2, 1, 3).reshape(na * nb, p * p)
    if na * nb < gmax:
        pt = F.pad(pt, (0, 0, 0, gmax - na * nb), value=pad_value)
    return pt, na * nb


def count_overlapping_patches(image_shape, shape, stride):
    """Patch count of the grouped decomposition."""
    p, s = shape[0], stride
    h, w = image_shape[-2:]
    return sum(((h - a) // p) * ((w - b) // p)
               for a in range(0, p, s) for b in range(0, p, s))


def reconstruct_from_overlapping_patches_at(patches, corners, image_shape):
    """Overlap-add of ``patches (n, ph, pw)`` at ``corners (n, 2)`` into
    an image of ``image_shape`` (numpy, float64)."""
    patches = np.asarray(patches)
    image = np.zeros(image_shape)
    ph, pw = patches.shape[1:]
    for patch, (i, j) in zip(patches, np.asarray(corners)):
        image[i:i + ph, j:j + pw] += patch
    return image


def _jitter_grid(image_shape, shape, stride):
    """The unjittered corner rows and columns, and the overlap."""
    overlap = max(shape) - stride
    ny, nx = image_shape[-2:]
    base_x = np.arange(overlap, nx - stride - overlap, stride)
    base_y = np.arange(overlap, ny - stride - overlap, stride)
    return base_y, base_x, overlap


def count_random_patches(image_shape, shape, stride):
    """Patch count of a jittered extraction."""
    base_y, base_x, _ = _jitter_grid(image_shape, shape, stride)
    return len(base_y) * len(base_x)


def draw_patch_jitter(image_shape, shape, stride, generator=None):
    """The jitters of one jittered extraction: an integer in ``[-overlap,
    overlap]`` per grid column, then one per grid row, drawn with
    ``generator`` (CPU int64 tensors ``(jitter_y, jitter_x)``)."""
    base_y, base_x, overlap = _jitter_grid(image_shape, shape, stride)
    jitter_x = torch.randint(-overlap, overlap + 1, (len(base_x),),
                             generator=generator)
    jitter_y = torch.randint(-overlap, overlap + 1, (len(base_y),),
                             generator=generator)
    return jitter_y, jitter_x


def _jittered_corners(image_shape, shape, stride, jitter_y, jitter_x):
    """The jittered corner rows and columns (numpy), clipped into the
    image as the JAX package clips them."""
    base_y, base_x, _ = _jitter_grid(image_shape, shape, stride)
    ny, nx = image_shape[-2:]
    cy = np.clip(base_y + np.asarray(jitter_y), 0, ny - shape[-2])
    cx = np.clip(base_x + np.asarray(jitter_x), 0, nx - shape[-1])
    return cy, cx


def random_patch_indices(image_shape, shape, stride, jitter_y, jitter_x,
                         device=None):
    """The jittered corner grid: a regular grid from ``overlap`` with the
    given per-row and per-column jitters, clipped into the image.

    Returns
    -------
    idy, idx : int64 tensors ``(n,)`` on ``device``
        Flattened corners, row-major over the grid.
    """
    cy, cx = _jittered_corners(image_shape, shape, stride, jitter_y,
                               jitter_x)
    idy, idx = np.meshgrid(cy, cx, indexing="ij")
    return (torch.as_tensor(idy.ravel(), dtype=torch.int64, device=device),
            torch.as_tensor(idx.ravel(), dtype=torch.int64, device=device))


def view_as_random_overlapping_patches(image, shape, stride, jitter_y,
                                       jitter_x):
    """Jittered overlapping patches of ``image (..., H, W)`` at the drawn
    jitters (:func:`draw_patch_jitter`), in the order of
    :func:`random_patch_indices`.

    The corners form a grid (one jitter a row, one a column), so the
    patches are two separable gathers, of rows and then of columns,
    whose backwards add into the image without sorting indices (a gather
    at each patch's pixels would sort them).
    """
    im = image.reshape(image.shape[-2:])
    cy, cx = _jittered_corners(im.shape, shape, stride, jitter_y, jitter_x)
    ph, pw = shape
    rows = (cy[:, None] + np.arange(ph)).reshape(-1)
    cols = (cx[:, None] + np.arange(pw)).reshape(-1)
    # one host-to-device copy of the drawn grid
    index = torch.as_tensor(np.concatenate([rows, cols]).astype(np.int64),
                            device=image.device)
    sub = im.index_select(0, index[:rows.size]).index_select(
        1, index[rows.size:])
    n_y, n_x = len(cy), len(cx)
    return sub.reshape(n_y, ph, n_x, pw).permute(0, 2, 1, 3).reshape(
        n_y * n_x, ph * pw)


def evaluate_trapez(x, width, slope):
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

    values = evaluate_trapez(x=x, width=(stride - overlap), slope=1.0 / overlap)
    weights = values * values[:, np.newaxis]
    weights = weights / weights.sum() * stride**2
    return weights


def reconstruct_from_overlapping_patches(patches, image_shape, stride=None):
    """Overlap-add of weighted patches ``(n, ph, pw)`` (numpy, row-major
    over the grid of stride ``stride``, default half a patch) into an image
    of ``image_shape``: a host-side diagnostic (numpy in, numpy out)."""
    patches = np.asarray(patches)
    if stride is None:
        stride = patches.shape[-1] // 2
    ph, pw = patches.shape[1:]
    image = np.zeros(image_shape)
    weights = get_pixel_weights(patch_shape=(ph, pw), stride=stride)
    corners = ((i, j) for i in range(0, image_shape[0] - ph + 1, stride)
               for j in range(0, image_shape[1] - pw + 1, stride))
    for patch, (i, j) in zip(patches, corners):
        image[i:i + ph, j:j + pw] += weights * patch
    return image
