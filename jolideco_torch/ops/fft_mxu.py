"""Matrix-DFT convolution, one observation at a time: the 4-step
(Cooley-Tukey) DFT as two matrix products per axis (the JAX package's
``ops/fft_mxu.py``, ``conv_mode="mxu"``).

Along an axis of size ``N = N1 * N2`` (``N1``, ``N2`` as close as they go,
:func:`mxu_conv_shape`), with ``x`` viewed as ``(N1, N2)``::

    A[k1, n2] = sum_n1 F1[k1, n1] x[n1, n2]        (product over N1)
    B[k1, n2] = A[k1, n2] * w^(k1 n2)              (twiddles)
    X[k1, k2] = sum_n2 B[k1, n2] F2[n2, k2]        (product over N2)

``X`` comes out in the ``(k1, k2)`` layout, a permutation of the natural
frequency order. A convolution does not care: the kernel's spectrum is
taken by the same transform, the product is pointwise in any fixed order
of the frequencies, and the inverse transform (conjugate matrices, stages
reversed) undoes the permutation.

Precision: ``"split3"`` (what the stacked loss runs) takes each complex
contraction as four real ones, each as three products of bf16 hi/lo parts
(``_split_mm``) summed in float32: about 2^-16 relative. ``"highest"``
takes plain float32 products. The parts are exact in float32, so every
product here is a float32 product (TF32 stays off, ``config``); the
tensors are never multiplied as bf16, which would round each sum to bf16.
"""

from functools import lru_cache

import numpy as np
import torch

from .splitfp import bf16_round, check_precision

__all__ = [
    "DFTConvPlan",
    "make_dft_tables",
    "mxu_conv_shape",
    "mxu_convolve",
    "mxu_dft2",
    "mxu_idft2",
    "mxu_kernel_spectrum",
]


def _split_size(n):
    """``(N1, N2)`` with ``N1 * N2 = n`` and the two as close as possible."""
    for n1 in range(int(np.sqrt(n)), 0, -1):
        if n % n1 == 0:
            return (n1, n // n1)
    return None


def mxu_conv_shape(min_size):
    """Smallest size of cheapest balanced factors from ``min_size`` on.

    Of the 64 sizes from ``min_size``, those whose factors differ by at
    most a factor 1.5, the one of least product cost ``N (N1 + N2)``.
    """
    best = None
    for n in range(int(min_size), int(min_size) + 64):
        n1, n2 = _split_size(n)
        if n2 / n1 > 1.5:
            continue
        cost = n * (n1 + n2)
        if best is None or cost < best[0]:
            best = (cost, n)
    return best[1] if best else int(min_size)


@lru_cache(maxsize=32)
def _axis_tables(n):
    """Stage matrices and twiddles of one axis of size ``n``: computed in
    float64 on the host, kept as complex64 numpy arrays."""
    n1, n2 = _split_size(n)
    w = np.exp(-2j * np.pi / n)
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = w ** np.outer(np.arange(n1), np.arange(n2))
    return {
        "f1": f1.astype(np.complex64),
        "f2": f2.astype(np.complex64),
        "tw": tw.astype(np.complex64),
        "f1i": np.conj(f1).astype(np.complex64) / n1,
        "f2i": np.conj(f2).astype(np.complex64) / n2,
        "twi": np.conj(tw).astype(np.complex64),
    }


def make_dft_tables(fft_shape, device=None):
    """The stage matrices and twiddles of both axes of ``fft_shape`` as
    complex64 tensors on ``device`` (default the CPU), keyed
    ``"{rows|cols}_{f1|f2|tw|f1i|f2i|twi}"`` as in the JAX package."""
    out = {}
    for prefix, n in (("rows", fft_shape[0]), ("cols", fft_shape[1])):
        for key, table in _axis_tables(int(n)).items():
            out[f"{prefix}_{key}"] = torch.as_tensor(table, device=device)
    return out


def _axis_view(tables, prefix):
    view = {key: tables[f"{prefix}_{key}"]
            for key in ("f1", "f2", "tw", "f1i", "f2i", "twi")}
    view["n1"], view["n2"] = view["f1"].shape[0], view["f2"].shape[0]
    return view


def _split_mm(spec, a, b_hi, b_lo):
    """``einsum(spec, a, b)`` from three products of bf16 parts, summed in
    float32 (the lo x lo term dropped, about 2^-16 relative)."""
    a_hi = bf16_round(a)
    a_lo = a - a_hi
    return (torch.einsum(spec, a_hi, b_hi) + torch.einsum(spec, a_lo, b_hi)
            + torch.einsum(spec, a_hi, b_lo))


def _matrix_parts(m):
    """Real and imaginary parts of a complex matrix and their bf16 hi/lo
    splits (the lo parts are the float32 residuals)."""
    re, im = m.real.float(), m.imag.float()
    re_hi, im_hi = bf16_round(re), bf16_round(im)
    return {"re": re, "im": im, "re_hi": re_hi, "re_lo": re - re_hi,
            "im_hi": im_hi, "im_lo": im - im_hi}


def _cplx_contract(spec, xr, xi, m, precision):
    """``(xr + i xi)`` contracted with the complex matrix of parts ``m``
    by ``spec``, in four real contractions: ``(real, imaginary)``."""
    if precision == "split3":
        def mm(a, part):
            return _split_mm(spec, a, m[f"{part}_hi"], m[f"{part}_lo"])
    else:
        def mm(a, part):
            return torch.einsum(spec, a, m[part])
    rr, ii = mm(xr, "re"), mm(xi, "im")
    ri, ir = mm(xr, "im"), mm(xi, "re")
    return rr - ii, ri + ir


def _dft_last_parts(xr, xi, view, inverse, precision):
    """Permuted (inverse) DFT along the last axis in real arithmetic: the
    forward takes natural order to the ``(k1, k2)`` layout, the inverse
    takes that layout back with the stages reversed."""
    n1, n2 = view["n1"], view["n2"]
    lead = xr.shape[:-1]
    xr = xr.reshape(lead + (n1, n2))
    xi = xi.reshape(lead + (n1, n2))
    if not inverse:
        tw = view["tw"]
        ar, ai = _cplx_contract("...nt,kn->...kt", xr, xi,
                                _matrix_parts(view["f1"]), precision)
        twr, twi = tw.real.float(), tw.imag.float()
        br, bi = ar * twr - ai * twi, ar * twi + ai * twr
        outr, outi = _cplx_contract("...kt,tj->...kj", br, bi,
                                    _matrix_parts(view["f2"]), precision)
    else:
        tw = view["twi"]
        ar, ai = _cplx_contract("...kj,jt->...kt", xr, xi,
                                _matrix_parts(view["f2i"]), precision)
        twr, twi = tw.real.float(), tw.imag.float()
        br, bi = ar * twr - ai * twi, ar * twi + ai * twr
        outr, outi = _cplx_contract("...kt,nk->...nt", br, bi,
                                    _matrix_parts(view["f1i"]), precision)
    return outr.reshape(lead + (n1 * n2,)), outi.reshape(lead + (n1 * n2,))


def _dft_last(x, view, inverse):
    """Permuted (inverse) DFT along the last axis of a complex tensor, in
    complex64 products."""
    n1, n2 = view["n1"], view["n2"]
    lead = x.shape[:-1]
    x = x.reshape(lead + (n1, n2))
    if not inverse:
        a = torch.einsum("...nt,kn->...kt", x, view["f1"]) * view["tw"]
        out = torch.einsum("...kt,tj->...kj", a, view["f2"])
    else:
        a = torch.einsum("...kj,jt->...kt", x, view["f2i"].T) * view["twi"]
        out = torch.einsum("...kt,nk->...nt", a, view["f1i"])
    return out.reshape(lead + (n1 * n2,))


def _dft2(x, tables, inverse):
    x = _dft_last(x, _axis_view(tables, "cols"), inverse).transpose(-1, -2)
    x = _dft_last(x, _axis_view(tables, "rows"), inverse)
    return x.transpose(-1, -2)


def _check_complex_precision(precision):
    if precision != "highest":
        raise ValueError("the complex transforms take precision='highest' "
                         f"(complex64 products), got {precision!r}")


def mxu_dft2(x, tables, precision="highest"):
    """Permuted 2-D DFT of a complex ``(..., rows, cols)`` tensor."""
    _check_complex_precision(precision)
    return _dft2(x, tables, inverse=False)


def mxu_idft2(x, tables, precision="highest"):
    """Inverse of :func:`mxu_dft2`."""
    _check_complex_precision(precision)
    return _dft2(x, tables, inverse=True)


def _origin_centered_pad(kernel, fft_shape):
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    embedded = torch.nn.functional.pad(
        kernel, (0, int(fft_shape[1]) - kw, 0, int(fft_shape[0]) - kh))
    return torch.roll(embedded, shifts=(-((kh - 1) // 2), -((kw - 1) // 2)),
                      dims=(-2, -1))


def mxu_kernel_spectrum(kernel, fft_shape, tables, precision="highest"):
    """Permuted spectrum of ``kernel (..., kh, kw)`` embedded with its
    centre pixel ``(k - 1) // 2`` at the origin of ``fft_shape``."""
    embedded = _origin_centered_pad(kernel, fft_shape)
    return mxu_dft2(embedded.to(torch.complex64), tables, precision)


def _dft2_parts(xr, xi, tables, inverse, precision):
    xr, xi = _dft_last_parts(xr, xi, _axis_view(tables, "cols"), inverse,
                             precision)
    xr, xi = xr.transpose(-1, -2), xi.transpose(-1, -2)
    xr, xi = _dft_last_parts(xr, xi, _axis_view(tables, "rows"), inverse,
                             precision)
    return xr.transpose(-1, -2), xi.transpose(-1, -2)


def mxu_convolve(image, kernel_spectrum, tables, fft_shape,
                 precision="split3"):
    """Linear convolution of ``image (..., H, W)`` with a kernel given by
    its permuted spectrum (:func:`mxu_kernel_spectrum` at ``fft_shape``),
    cropped to ``(H, W)``. ``"split3"`` (the default) runs every
    contraction in real arithmetic on split-float products, ``"highest"``
    in complex64 products. Differentiable by autograd through its stages
    (twice, for the flux-error probe)."""
    check_precision(precision)
    h, w = image.shape[-2], image.shape[-1]
    pad = (0, int(fft_shape[1]) - w, 0, int(fft_shape[0]) - h)
    if precision == "split3":
        xr = torch.nn.functional.pad(image, pad).float()
        xi = torch.zeros_like(xr)
        xr, xi = _dft2_parts(xr, xi, tables, False, precision)
        kr, ki = kernel_spectrum.real.float(), kernel_spectrum.imag.float()
        yr, yi = xr * kr - xi * ki, xr * ki + xi * kr
        outr, _ = _dft2_parts(yr, yi, tables, True, precision)
        return outr[..., :h, :w].to(image.dtype)
    x = torch.nn.functional.pad(image, pad).to(torch.complex64)
    out = _dft2(_dft2(x, tables, False) * kernel_spectrum, tables, True)
    return out.real[..., :h, :w].to(image.dtype)


class DFTConvPlan:
    """2-D convolution plan with the kernels' permuted spectra computed
    once.

    Parameters
    ----------
    image_shape : (H, W)
    kernel : tensor ``(..., kh, kw)``
        Spatial kernel(s), embedded origin-centered like
        ``ops.fft.kernel_fft``.
    fft_shape : (sh, sw), optional
        Transform size; by default :func:`mxu_conv_shape` of the linear
        convolution's.
    precision : ``"highest"`` (default) or ``"split3"``
    """

    def __init__(self, image_shape, kernel, fft_shape=None,
                 precision="highest"):
        kh, kw = kernel.shape[-2], kernel.shape[-1]
        h, w = image_shape
        if fft_shape is None:
            fft_shape = (mxu_conv_shape(h + kh - 1),
                         mxu_conv_shape(w + kw - 1))
        self.fft_shape = tuple(int(s) for s in fft_shape)
        self.image_shape = (int(h), int(w))
        self.precision = precision
        self.tables = make_dft_tables(self.fft_shape, device=kernel.device)
        self.kernel_spectrum = mxu_kernel_spectrum(
            kernel, self.fft_shape, self.tables, precision)

    def convolve(self, image, kernel_spectrum=None):
        """Convolve ``(..., H, W)`` with the planned kernel."""
        if kernel_spectrum is None:
            kernel_spectrum = self.kernel_spectrum
        return mxu_convolve(image, kernel_spectrum, self.tables,
                            self.fft_shape, self.precision)
