"""Row-sharded (distributed pencil) FFT convolution.

Counterpart of the JAX package's ``ops/dist_fft.py``. On a 2-D ``(obs,
row)`` mesh every rank holds ``H / R`` complete image rows of its
observations, and the convolution with a precomputed kernel spectrum
(:func:`ops.fft.convolve_fft_precomputed`) runs as a pencil
decomposition over the ``row`` group of ``R`` ranks:

1. a local ``rfft`` along W (the rows are complete);
2. an ``all_to_all`` over the row group: every rank then holds all ``H``
   rows of ``(Fw // 2 + 1) / R`` spectrum columns;
3. a local ``fft`` along H, zero-padded to ``Fh``, the product with the
   rank's columns of the kernel spectrum, the ``ifft`` and the crop back
   to ``H`` rows;
4. the ``all_to_all`` back, and a local ``irfft`` along W cropped to W.

Every transform is a dense local one (cuFFT on the card), so each rank
does ``1 / R`` of the convolution's work. The adjoint is the same
pipeline with the conjugate spectrum, as in the JAX package's
``custom_vjp``: the backward costs one forward, and is itself
differentiable (the Hessian probe takes a second derivative through
it).
"""

import torch

from ..parallel.mesh import all_to_all, mesh_size
from .fft import _unbroadcast

__all__ = ["dist_convolve_fft", "spatial_fft_shape"]


def spatial_fft_shape(image_shape, kernel_shape, n_row_shards):
    """An FFT shape whose half-spectrum splits evenly over row shards.

    The minimal linear-convolution shape ``(H + kh - 1, W + kw - 1)``
    with the width grown until ``Fw // 2 + 1`` is a multiple of
    ``n_row_shards``: pass it as ``fft_shape=`` to
    ``StackedPoissonLoss.from_datasets`` for a loss sharded over rows.
    """
    fh = image_shape[-2] + kernel_shape[-2] - 1
    fw = image_shape[-1] + kernel_shape[-1] - 1
    while (fw // 2 + 1) % n_row_shards:
        fw += 1
    return (fh, fw)


def _pipeline(x, kft, fft_shape, group, h):
    fh, fw = fft_shape
    w = x.shape[-1]
    rows, cols = x.ndim - 2, x.ndim - 1
    xf = torch.fft.rfft(x, n=fw, dim=-1)                 # (..., H/R, Fwh)
    xf = all_to_all(xf, cols, rows, group)               # (..., H, Fwh/R)
    yf = torch.fft.fft(xf, n=fh, dim=-2)
    yf = torch.fft.ifft(yf * kft, dim=-2)[..., :h, :]
    yf = all_to_all(yf, rows, cols, group)               # (..., H/R, Fwh)
    return torch.fft.irfft(yf, n=fw, dim=-1)[..., :w]


class _DistConvolveFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kft, fft_shape, group, h):
        ctx.save_for_backward(kft)
        ctx.args = (fft_shape, group, h)
        ctx.image_shape = tuple(x.shape)
        return _pipeline(x, kft, fft_shape, group, h)

    @staticmethod
    def backward(ctx, grad):
        (kft,) = ctx.saved_tensors
        dx = _DistConvolveFFT.apply(grad.contiguous(), kft.conj(), *ctx.args)
        return _unbroadcast(dx, ctx.image_shape), None, None, None, None


def dist_convolve_fft(x, kft, fft_shape, mesh, row_axis="row"):
    """Row-sharded linear convolution with a precomputed kernel rFFT.

    Parameters
    ----------
    x : tensor ``(..., H / R, W)``
        This rank's rows of the images: block ``r`` of ``R`` equal blocks,
        ``r`` the rank's coordinate along ``row_axis``.
    kft : complex tensor ``(..., Fh, (Fw // 2 + 1) / R)``
        This rank's block of columns of the spectrum from
        ``ops.fft.kernel_fft`` (or ``build_kernel_stack``) at
        ``fft_shape``; it broadcasts against ``x`` and takes no gradient.
    fft_shape : tuple of int
        ``(Fh, Fw)``, with ``Fw // 2 + 1`` divisible by ``R`` (see
        :func:`spatial_fft_shape`).
    mesh : DeviceMesh, and ``row_axis`` the name of its image-row
        dimension.

    Returns
    -------
    out : tensor ``(..., H / R, W)``: this rank's rows of the convolution.
    """
    n_rows = mesh_size(mesh, row_axis)
    fh, fw = (int(s) for s in fft_shape)
    fwh = fw // 2 + 1
    if fwh % n_rows or kft.shape[-1] * n_rows != fwh:
        raise ValueError(
            f"row sharding over {n_rows} ranks needs Fw//2+1 ({fwh}) "
            f"divisible by it and this rank's spectrum block of "
            f"{fwh // n_rows} columns, got {kft.shape[-1]}; build the loss "
            "with fft_shape=spatial_fft_shape(...)"
        )
    return _DistConvolveFFT.apply(x, kft, (fh, fw), mesh.get_group(row_axis),
                                  x.shape[-2] * n_rows)
