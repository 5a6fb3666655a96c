"""Image-space ops (the JAX package's ``ops/image.py``): resampling, warps,
sum pool, cycle spins, interpolation.

The warps (``shift_image``, ``rescale_image``) sample the input at
coordinates that depend on the row alone and on the column alone, so
each is a separable bilinear gather in pixel units: per axis ``floor``,
two weights and two masked reads (zeros outside), the coordinates
computed as the JAX package computes them (``arange + scale * shift``
in float32). The value and both gradients therefore follow
``jax.scipy.ndimage.map_coordinates(order=1, mode="constant")``: at an
integer coordinate the gradient with respect to the shift is the
forward difference, as there. ``F.grid_sample`` would go through
normalised coordinates, where a shift of exactly 0 need not map back to
the integer.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "avg_pool",
    "cycle_spin",
    "cycle_spin_interp",
    "cycle_spin_subpixel",
    "draw_cycle_spin",
    "draw_subpixel",
    "grid_weights",
    "interp1d",
    "maybe_rescale_image",
    "rescale_image",
    "shift_image",
    "shift_images",
    "sum_pool",
    "upsample_bilinear",
]


def upsample_bilinear(image, factor):
    """Bilinear upsampling of ``image (..., H, W)`` by an integer factor.

    ``F.interpolate(mode="bilinear", align_corners=False)``: output
    pixel centres sample the input at ``(i + 0.5) / factor - 0.5`` with
    edge clamping, as the JAX package's ``jax.image.resize`` "linear".
    """
    if not factor or factor == 1:
        return image
    h, w = image.shape[-2], image.shape[-1]
    out = F.interpolate(image.reshape(-1, 1, h, w), scale_factor=factor,
                        mode="bilinear", align_corners=False)
    return out.reshape(image.shape[:-2] + (h * factor, w * factor))


def sum_pool(image, factor):
    """Flux-conserving downsampling: sum over ``factor²`` blocks."""
    if not factor or factor == 1:
        return image
    h, w = image.shape[-2], image.shape[-1]
    lead = image.shape[:-2]
    x = image.reshape(lead + (h // factor, factor, w // factor, factor))
    return x.sum(dim=(-3, -1))


def avg_pool(image, factor):
    """Mean over non-overlapping ``factor²`` blocks."""
    if not factor or factor == 1:
        return image
    return sum_pool(image, factor) / (factor * factor)


def _interp_axis(x, coords, dim):
    """Linear interpolation of ``x (N, C, H, W)`` along ``dim`` (-2 or
    -1) at ``coords (N, L)``, zeros outside."""
    size = x.shape[dim]
    lower = torch.floor(coords)
    upper_weight = coords - lower
    lower = lower.long()
    out = None
    for index, weight in ((lower, 1.0 - upper_weight),
                          (lower + 1, upper_weight)):
        valid = (index >= 0) & (index < size)
        index = index.clamp(0, size - 1)
        if dim == -2:
            index = index[:, None, :, None].expand(
                x.shape[0], x.shape[1], -1, x.shape[3])
            weight = weight[:, None, :, None]
            valid = valid[:, None, :, None]
        else:
            index = index[:, None, None, :].expand(
                x.shape[0], x.shape[1], x.shape[2], -1)
            weight = weight[:, None, None, :]
            valid = valid[:, None, None, :]
        part = torch.where(valid, torch.gather(x, dim, index), 0.0) * weight
        out = part if out is None else out + part
    return out


def _sample(image, rows, cols):
    """``image (..., H, W)`` sampled at rows ``(N, H)`` and columns
    ``(N, W)``: an ``(N,) + image.shape`` stack."""
    h, w = image.shape[-2], image.shape[-1]
    n = rows.shape[0]
    x = image.reshape(1, -1, h, w).expand(n, -1, h, w)
    x = _interp_axis(x, rows, -2)
    x = _interp_axis(x, cols, -1)
    return x.reshape((n,) + tuple(image.shape))


def shift_images(image, shifts, scale=1.0):
    """``image (..., H, W)`` shifted by each of ``shifts (N, ..., 2)``
    (x, y in data pixels): an ``(N,) + image.shape`` stack.

    ``out[n, ..., y, x] = image[..., y + scale sy_n, x + scale sx_n]``,
    bilinear, zeros outside, differentiable in the image and in the
    shifts. ``scale`` is the upsampling factor that converts data
    pixels into image pixels.
    """
    shifts = torch.as_tensor(shifts, dtype=image.dtype,
                             device=image.device).reshape(-1, 2)
    h, w = image.shape[-2], image.shape[-1]
    rows = (torch.arange(h, dtype=image.dtype, device=image.device)[None, :]
            + scale * shifts[:, 1:2])
    cols = (torch.arange(w, dtype=image.dtype, device=image.device)[None, :]
            + scale * shifts[:, 0:1])
    return _sample(image, rows, cols)


def shift_image(image, shift_xy, scale=1.0):
    """Shift ``image (..., H, W)`` by ``shift_xy`` (``(2,)`` or
    ``(1, 2)``, x then y, in data pixels); see :func:`shift_images`."""
    return shift_images(image, shift_xy, scale=scale)[0]


def rescale_image(image, factor):
    """Zoom ``image (..., H, W)`` about its centre by ``factor``, keeping
    its shape: output pixel ``x`` samples the input at ``(2x + 1 - W) /
    (2 factor) + (W - 1) / 2`` (bilinear, zeros outside)."""
    h, w = image.shape[-2], image.shape[-1]
    factor = torch.as_tensor(factor, dtype=image.dtype,
                             device=image.device).reshape(())

    def coords(size):
        grid = torch.arange(size, dtype=image.dtype, device=image.device)
        return ((2.0 * grid + 1.0 - size) / (2.0 * factor)
                + (size - 1) / 2.0)[None, :]

    return _sample(image, coords(h), coords(w))[0]


def maybe_rescale_image(image, factor):
    """:func:`rescale_image`, skipped when ``factor`` is None or 1."""
    if factor is None:
        return image
    if isinstance(factor, (int, float)) and float(factor) == 1.0:
        return image
    return rescale_image(image, factor)


def draw_cycle_spin(patch_shape, generator=None):
    """The ``(shift_y, shift_x)`` of one cycle spin, drawn uniformly from
    ``[-p//4, p//4]`` per axis with ``generator`` (x first, then y)."""
    x_max, y_max = patch_shape
    x_width, y_width = x_max // 4, y_max // 4
    shift_x = int(torch.randint(-x_width, x_width + 1, (),
                                generator=generator))
    shift_y = int(torch.randint(-y_width, y_width + 1, (),
                                generator=generator))
    return shift_y, shift_x


def cycle_spin(image, patch_shape, generator=None, shifts=None):
    """Integer cyclic roll of up to ``patch // 4`` pixels per axis.

    Draws ``(shift_y, shift_x)`` uniformly from ``[-p//4, p//4]`` with
    ``generator`` (a CPU ``torch.Generator``, so drawing never waits on
    the device), or takes explicit ``shifts`` so that tests can inject
    the shifts the JAX package's ``ops.image.cycle_spin`` drew.

    Returns
    -------
    image : tensor
        Rolled image.
    shifts : tuple of int
        The ``(shift_y, shift_x)`` applied.
    """
    if shifts is None:
        shifts = draw_cycle_spin(patch_shape, generator)
    shifts = (int(shifts[0]), int(shifts[1]))
    return torch.roll(image, shifts=shifts, dims=(-2, -1)), shifts


def grid_weights(x, y, x0, y0):
    """Bilinear splat weights ``max(0, 1 - |x - x0|) * max(0, 1 - |y -
    y0|)`` (tensors or numpy arrays)."""
    dx = abs(x - x0)
    dy = abs(y - y0)
    if torch.is_tensor(dx):
        return (torch.where(dx < 1, 1 - dx, 0.0)
                * torch.where(dy < 1, 1 - dy, 0.0))
    return np.where(dx < 1, 1 - dx, 0.0) * np.where(dy < 1, 1 - dy, 0.0)


def draw_subpixel(generator=None):
    """The ``(x0, y0)`` offsets of one subpixel spin, each uniform in
    ``[-0.5, 0.5)`` in float32, drawn with ``generator`` (x first)."""
    x0 = torch.rand((), generator=generator) - 0.5
    y0 = torch.rand((), generator=generator) - 0.5
    return float(x0), float(y0)


def cycle_spin_subpixel(image, x0, y0):
    """Shift ``image (..., H, W)`` by the subpixel offsets ``(x0, y0)``.

    The 3x3 kernel ``grid_weights`` of the offsets, computed in float32
    on the host as the JAX package computes it on the device, is
    cross-correlated with the image under zero padding ('same'): nine
    shifted, scaled copies summed in the JAX package's order.
    """
    grid = np.arange(-1, 2, dtype=np.float32)
    y, x = np.meshgrid(grid, grid, indexing="ij")
    kernel = grid_weights(x, y, np.float32(x0), np.float32(y0))
    kernel = kernel.astype(np.float32)
    h, w = image.shape[-2], image.shape[-1]
    padded = F.pad(image, (1, 1, 1, 1))
    out = torch.zeros_like(image)
    for dy in range(3):
        for dx in range(3):
            out = out + float(kernel[dy, dx]) * padded[..., dy:dy + h,
                                                       dx:dx + w]
    return out


def cycle_spin_interp(image, patch_shape, generator=None, shifts=None,
                      scale=1.0):
    """Continuous cycle spin: uniform shifts of up to ``patch // 4``
    pixels per axis applied with the bilinear :func:`shift_image`.

    Draws ``(shift_x, shift_y)`` with ``generator`` (x first), or takes
    them as ``shifts``. Returns the shifted image and the shifts times
    ``scale``.
    """
    x_max, y_max = patch_shape
    x_width, y_width = x_max // 4, y_max // 4
    if shifts is None:
        shift_x = (torch.rand((), generator=generator) * 2 - 1) * x_width
        shift_y = (torch.rand((), generator=generator) * 2 - 1) * y_width
        shifts = (float(shift_x), float(shift_y))
    shifts = scale * torch.tensor(shifts, dtype=image.dtype,
                                  device=image.device)
    return shift_image(image, shifts, scale=1.0), shifts


def interp1d(x, xp, fp):
    """Piecewise-linear interpolation with the JAX package's arithmetic.

    ``searchsorted`` clipped to ``[0, len(xp) - 2]``, then a lerp
    between ``idx - 1`` and ``idx`` that extrapolates outside the table.
    At or below ``xp[0]`` the index is 0, so the left point is
    ``xp[-1]``, ``fp[-1]`` (a negative index wraps, in both packages).
    """
    idx = torch.clip(torch.searchsorted(xp, x.contiguous()), 0, len(xp) - 2)
    y0, y1 = fp[idx - 1], fp[idx]
    x0, x1 = xp[idx - 1], xp[idx]
    weights = (x - x0) / (x1 - x0)
    return y0 + weights * (y1 - y0)
