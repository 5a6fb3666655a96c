"""Analytic 2-D kernels (numpy).

Copy of the JAX package's ``utils/kernels.py::gaussian_kernel_2d``, which
cannot be imported from here without pulling in JAX. Semantics follow
astropy's ``Gaussian2DKernel``: the default size is ``8 * sigma``
rounded up to the next odd integer, ``mode="center"`` evaluates the
profile at pixel centers, ``mode="oversample"`` averages over an
``oversample x oversample`` subpixel grid, and kernels sum to one.
"""

import numpy as np

__all__ = ["gaussian_kernel_2d"]


def _default_size(width):
    size = int(np.ceil(8 * width))
    return size + 1 if size % 2 == 0 else size


def _grid(x_size, y_size, oversample=1):
    """Subpixel-offset coordinate grids centered on the kernel."""
    cx = (x_size - 1) / 2
    cy = (y_size - 1) / 2
    step = 1.0 / oversample
    offsets = (np.arange(oversample) + 0.5) * step - 0.5
    x = np.arange(x_size)[:, None] + offsets[None, :]
    y = np.arange(y_size)[:, None] + offsets[None, :]
    return (x - cx), (y - cy)


def _mode_factor(mode, oversample):
    if mode == "oversample":
        return int(oversample)
    if mode == "center":
        return 1
    raise ValueError(
        f"Unsupported kernel mode {mode!r}; choose 'center' or "
        "'oversample'"
    )


def gaussian_kernel_2d(sigma, x_size=None, y_size=None, mode="center",
                       oversample=10):
    """Normalised 2-D Gaussian kernel.

    Parameters
    ----------
    sigma : float
        Standard deviation in pixels.
    x_size, y_size : int, optional
        Kernel size; defaults to ``8 * sigma`` rounded up to odd.
    mode : {"center", "oversample"}
    """
    x_size = x_size or _default_size(sigma)
    y_size = y_size or x_size

    factor = _mode_factor(mode, oversample)
    dx, dy = _grid(x_size, y_size, factor)

    gx = np.exp(-(dx**2) / (2 * sigma**2)).mean(axis=1)
    gy = np.exp(-(dy**2) / (2 * sigma**2)).mean(axis=1)
    kernel = gy[:, None] * gx[None, :]
    return kernel / kernel.sum()
