"""FFT linear convolution on ``torch.fft`` (the JAX package's ``ops/fft.py``).

Kernels are embedded origin-centered (the center pixel ``(k - 1) // 2``
rolled to ``(0, 0)``), so the circular convolution at a shape of at
least ``image + kernel - 1`` restricted to ``[:H, :W]`` equals the
centered crop of the full linear convolution. Kernel spectra are
computed once per dataset stack at build time. On a CUDA tensor the
transforms are cuFFT's.

The JAX package also packs observation pairs into one complex transform
(``kernel_fft_pair``/``convolve_fft_packed_pair``); that is a
throughput trick for the TPU's FFT and is not ported: a batched
per-observation ``rfft2`` has the same semantics.
"""

import torch

__all__ = [
    "build_kernel_stack",
    "convolve_fft_precomputed",
    "fft_conv_shape",
    "kernel_fft",
    "upsample_center_pad_kernels",
]


def fft_conv_shape(image_shape, kernel_shape):
    """Minimal FFT shape ``(H + kh - 1, W + kw - 1)`` for linear convolution."""
    return (
        image_shape[-2] + kernel_shape[-2] - 1,
        image_shape[-1] + kernel_shape[-1] - 1,
    )


def _origin_centered(kernel, fft_shape):
    """Embed ``kernel`` into ``fft_shape`` with its center at ``(0, 0)``."""
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    padded = torch.nn.functional.pad(
        kernel, (0, fft_shape[1] - kw, 0, fft_shape[0] - kh)
    )
    return torch.roll(
        padded, shifts=(-((kh - 1) // 2), -((kw - 1) // 2)), dims=(-2, -1)
    )


def kernel_fft(kernel, image_shape, fft_shape=None):
    """rFFT of an origin-centered kernel: ``(..., fh, fw // 2 + 1)`` complex."""
    min_shape = fft_conv_shape(image_shape, kernel.shape)
    if fft_shape is None:
        fft_shape = min_shape
    if fft_shape[0] < min_shape[0] or fft_shape[1] < min_shape[1]:
        raise ValueError(
            f"fft_shape {fft_shape} too small for linear convolution, "
            f"need at least {min_shape}"
        )
    return torch.fft.rfft2(_origin_centered(kernel, fft_shape), s=fft_shape)


def _convolve_impl(image, kft, fft_shape):
    h, w = image.shape[-2], image.shape[-1]
    image_ft = torch.fft.rfft2(image, s=tuple(fft_shape))
    out = torch.fft.irfft2(image_ft * kft, s=tuple(fft_shape))
    return out[..., :h, :w]


def _unbroadcast(grad, shape):
    """Sum ``grad`` back to ``shape`` where the forward broadcast it."""
    if tuple(grad.shape) == tuple(shape):
        return grad
    extra = grad.ndim - len(shape)
    if extra > 0:
        grad = grad.sum(dim=tuple(range(extra)))
    axes = tuple(
        i for i, (d, s) in enumerate(zip(grad.shape, shape))
        if d != s and s == 1
    )
    if axes:
        grad = grad.sum(dim=axes, keepdim=True)
    return grad


class _ConvolveFFT(torch.autograd.Function):
    """Convolution with a frozen spectrum; the adjoint is the same op
    with the conjugate spectrum (a correlation), so the gradient costs
    one forward."""

    @staticmethod
    def forward(ctx, image, kft, fft_shape):
        ctx.save_for_backward(kft)
        ctx.fft_shape = tuple(fft_shape)
        ctx.image_shape = tuple(image.shape)
        return _convolve_impl(image, kft, fft_shape)

    @staticmethod
    def backward(ctx, grad):
        (kft,) = ctx.saved_tensors
        dimage = _convolve_impl(grad, kft.conj(), ctx.fft_shape)
        return _unbroadcast(dimage, ctx.image_shape), None, None


def convolve_fft_precomputed(image, kft, fft_shape):
    """Convolve ``image (..., H, W)`` with a kernel given by its rFFT.

    ``kft`` comes from :func:`kernel_fft` or :func:`build_kernel_stack`
    at ``fft_shape`` and may broadcast against ``image``; the gradient
    is summed back to the image's shape. The spectrum takes no
    gradient.
    """
    return _ConvolveFFT.apply(image, kft, tuple(fft_shape))


def upsample_center_pad_kernels(kernels, *, factor, out_shape):
    """Center-pad a same-size kernel stack to ``out_shape``.

    Each kernel's center pixel ``(k - 1) // 2`` lands on the center
    pixel of ``out_shape``. Upsampling (``factor > 1``) is not ported
    yet.
    """
    if factor and factor > 1:
        raise NotImplementedError(
            "kernel upsampling (factor > 1) is not ported yet"
        )
    kh, kw = kernels.shape[-2], kernels.shape[-1]
    top = (out_shape[0] - 1) // 2 - (kh - 1) // 2
    left = (out_shape[1] - 1) // 2 - (kw - 1) // 2
    return torch.nn.functional.pad(
        kernels,
        (left, out_shape[1] - kw - left, top, out_shape[0] - kh - top),
    )


def build_kernel_stack(kernels, exposures, *, factor, fft_shape,
                       correct_edges):
    """Stacked convolution operators for a dataset stack.

    Parameters
    ----------
    kernels : tensor ``(n, 1, 1, KH, KW)``
        PSF stack, center-aligned to a common size.
    exposures : tensor ``(n, 1, 1, h, w)``
    factor : int
        Component upsampling factor (1 only for now).
    fft_shape : tuple of int
        Common FFT shape, at least image + kernel - 1.
    correct_edges : bool
        Divide exposures by ``ones * psf`` (the exposure edge
        correction).

    Returns
    -------
    kft : complex tensor ``(n, 1, 1, fh, fw // 2 + 1)``
    exposures : tensor ``(n, 1, 1, H, W)``
    """
    if factor and factor > 1:
        raise NotImplementedError(
            "exposure upsampling (factor > 1) is not ported yet"
        )
    fft_shape = tuple(fft_shape)
    kft = torch.fft.rfft2(_origin_centered(kernels, fft_shape), s=fft_shape)
    if correct_edges:
        h, w = exposures.shape[-2], exposures.shape[-1]
        ones_ft = torch.fft.rfft2(
            torch.ones((h, w), dtype=exposures.dtype,
                       device=exposures.device),
            s=fft_shape,
        )
        weights = torch.fft.irfft2(ones_ft * kft, s=fft_shape)[..., :h, :w]
        exposures = exposures / weights
    return kft, exposures
