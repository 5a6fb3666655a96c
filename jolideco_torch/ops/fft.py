"""FFT linear convolution on ``torch.fft`` (the JAX package's ``ops/fft.py``).

Kernels are embedded origin-centered (the center pixel ``(k - 1) // 2``
rolled to ``(0, 0)``), so the circular convolution at a shape of at
least ``image + kernel - 1`` restricted to ``[:H, :W]`` equals the
centered crop of the full linear convolution. Kernel spectra are
computed once per dataset stack at build time. On a CUDA tensor the
transforms are cuFFT's.

The JAX package also packs observation pairs into one complex transform
(``kernel_fft_pair``/``convolve_fft_packed_pair``), a throughput trick
for the TPU's FFT. The port keeps them as the reference and the cuFFT
yardstick of the packed matrix-DFT convolution (``ops/pallas_fft.py``);
``conv_mode="fft"`` trains on a batched per-observation ``rfft2``,
which has the same semantics.
"""

import numpy as np
import torch

from .image import rescale_image, upsample_bilinear

__all__ = [
    "build_kernel_stack",
    "convolve_fft",
    "convolve_fft_numpy",
    "convolve_fft_packed_pair",
    "convolve_fft_precomputed",
    "fft_conv_shape",
    "good_fft_size",
    "kernel_fft",
    "kernel_fft_numpy",
    "kernel_fft_pair",
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


def _origin_centered_numpy(kernel, fft_shape):
    """:func:`_origin_centered` of a numpy array, in float64."""
    kernel = np.asarray(kernel, np.float64)
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    pad = [(0, 0)] * (kernel.ndim - 2) + [(0, fft_shape[0] - kh),
                                          (0, fft_shape[1] - kw)]
    return np.roll(np.pad(kernel, pad),
                   shift=(-((kh - 1) // 2), -((kw - 1) // 2)), axis=(-2, -1))


def kernel_fft_numpy(kernel, image_shape, fft_shape):
    """:func:`kernel_fft` in float64 numpy: ``(re, im)`` float32 arrays."""
    min_shape = fft_conv_shape(image_shape, np.shape(kernel))
    if fft_shape[0] < min_shape[0] or fft_shape[1] < min_shape[1]:
        raise ValueError(
            f"fft_shape {fft_shape} too small for linear convolution, "
            f"need at least {min_shape}"
        )
    kft = np.fft.rfft2(_origin_centered_numpy(kernel, fft_shape), s=fft_shape)
    return np.asarray(kft.real, np.float32), np.asarray(kft.imag, np.float32)


def convolve_fft_numpy(image, kernel):
    """:func:`convolve_fft` in float64 numpy."""
    image = np.asarray(image, np.float64)
    fft_shape = fft_conv_shape(image.shape, np.shape(kernel))
    kft = np.fft.rfft2(_origin_centered_numpy(kernel, fft_shape), s=fft_shape)
    h, w = image.shape[-2], image.shape[-1]
    out = np.fft.irfft2(np.fft.rfft2(image, s=fft_shape) * kft, s=fft_shape)
    return out[..., :h, :w]


def good_fft_size(n):
    """Smallest 5-smooth size (a product of 2, 3 and 5) of at least ``n``.
    The port convolves at the minimal linear-convolution shape; this is a
    helper for trying others."""
    n = int(n)
    if n <= 2:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


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


def convolve_fft(image, kernel, kft=None):
    """Linear convolution of ``image (..., H, W)`` with ``kernel``,
    centred and cropped to the image's shape (``fftconvolve(mode="same")``
    for odd kernels), at the minimal FFT shape. ``kft`` is the kernel's
    spectrum there (:func:`kernel_fft`), to pass when it is cached."""
    fft_shape = fft_conv_shape(image.shape, kernel.shape)
    if kft is None:
        kft = kernel_fft(kernel, image.shape[-2:], fft_shape)
    return convolve_fft_precomputed(image, kft, fft_shape)


def kernel_fft_pair(kernel0, kernel1, image_shape, fft_shape):
    """Full spectra ``(A, B) = ((K0 + K1)/2, (K0 - K1)/2)`` of an
    origin-centered kernel pair at ``fft_shape``, for
    :func:`convolve_fft_packed_pair`.

    The kernels are ``(..., kh, kw)`` tensors; the transforms run in
    float64 and the spectra come back as complex64 on the kernels'
    device.
    """
    min0 = fft_conv_shape(image_shape, kernel0.shape)
    min1 = fft_conv_shape(image_shape, kernel1.shape)
    if (fft_shape[0] < max(min0[0], min1[0])
            or fft_shape[1] < max(min0[1], min1[1])):
        raise ValueError(
            f"fft_shape {fft_shape} too small for linear convolution"
        )
    fft_shape = tuple(fft_shape)
    f0, f1 = (
        torch.fft.fft2(_origin_centered(k.to(torch.float64), fft_shape),
                       s=fft_shape)
        for k in (kernel0, kernel1)
    )
    return ((0.5 * (f0 + f1)).to(torch.complex64),
            (0.5 * (f0 - f1)).to(torch.complex64))


def convolve_fft_packed_pair(x0, x1, a, b, fft_shape):
    """Convolve two real image stacks with two kernels via one complex FFT.

    With ``Z = fft2(x0 + i x1)`` and ``Z~[m] = Z[-m]`` per axis,
    ``ifft2(A Z + B conj(Z~)) = y0 + i y1``; returns ``(y0, y1) = (x0 *
    k0, x1 * k1)`` cropped to the input shape. ``(a, b)`` come from
    :func:`kernel_fft_pair`; ``(conj(a), conj(b))`` give the adjoint.
    """
    h, w = x0.shape[-2], x0.shape[-1]
    pad = (0, fft_shape[1] - w, 0, fft_shape[0] - h)
    z = torch.fft.fft2(torch.complex(torch.nn.functional.pad(x0, pad),
                                     torch.nn.functional.pad(x1, pad)))
    z_rev = torch.roll(torch.flip(z, dims=(-2, -1)), shifts=(1, 1),
                       dims=(-2, -1))
    y = torch.fft.ifft2(a * z + b * z_rev.conj())
    return y.real[..., :h, :w], y.imag[..., :h, :w]


def upsample_center_pad_kernels(kernels, *, factor, out_shape, scales=None):
    """Upsample a same-size kernel stack and center-pad it to ``out_shape``.

    With ``factor > 1`` the kernels are upsampled bilinearly and divided
    by ``factor²`` (flux conservation). ``scales`` (one per kernel,
    optional) zooms each upsampled kernel about its centre by the static
    ``psf_scale`` calibration, before the padding. Each kernel's center
    pixel ``(k - 1) // 2`` then lands on the center pixel of
    ``out_shape``.
    """
    if factor and factor > 1:
        kernels = upsample_bilinear(kernels, factor) / factor**2
    if scales is not None:
        kernels = torch.stack([rescale_image(k, float(s))
                               for k, s in zip(kernels, scales)])
    kh, kw = kernels.shape[-2], kernels.shape[-1]
    top = (out_shape[0] - 1) // 2 - (kh - 1) // 2
    left = (out_shape[1] - 1) // 2 - (kw - 1) // 2
    return torch.nn.functional.pad(
        kernels,
        (left, out_shape[1] - kw - left, top, out_shape[0] - kh - top),
    )


def build_kernel_stack(kernels, exposures, *, factor, fft_shape,
                       correct_edges, conv_kernels=None):
    """Stacked convolution operators for a dataset stack.

    Parameters
    ----------
    kernels : tensor ``(n, 1, 1, KH, KW)``
        PSF stack, upsampled and center-aligned to a common size
        (:func:`upsample_center_pad_kernels`).
    exposures : tensor ``(n, 1, 1, h, w)``
        Exposures at data resolution.
    factor : int
        Component upsampling factor: the exposures are upsampled
        bilinearly before the edge correction.
    fft_shape : tuple of int
        Common FFT shape, at least upsampled image + kernel - 1.
    correct_edges : bool
        Divide exposures by ``ones * psf`` (the exposure edge
        correction), always with the unscaled ``kernels``.
    conv_kernels : tensor like ``kernels``, optional
        Kernels of the convolution spectra where they differ from
        ``kernels``: the ``psf_scale`` calibration's zoomed ones.

    Returns
    -------
    kft : complex tensor ``(n, 1, 1, fh, fw // 2 + 1)``
    exposures : tensor ``(n, 1, 1, H, W)``
    """
    fft_shape = tuple(fft_shape)
    if factor and factor > 1:
        exposures = upsample_bilinear(exposures, factor)

    def spectra(k):
        return torch.fft.rfft2(_origin_centered(k, fft_shape), s=fft_shape)

    kft = spectra(kernels if conv_kernels is None else conv_kernels)
    if correct_edges:
        h, w = exposures.shape[-2], exposures.shape[-1]
        ones_ft = torch.fft.rfft2(
            torch.ones((h, w), dtype=exposures.dtype,
                       device=exposures.device),
            s=fft_shape,
        )
        edge_kft = kft if conv_kernels is None else spectra(kernels)
        weights = torch.fft.irfft2(ones_ft * edge_kft,
                                   s=fft_shape)[..., :h, :w]
        exposures = exposures / weights
    return kft, exposures
