"""Pair-packed Cooley-Tukey matrix-DFT convolution (the JAX package's
``ops/ct_conv.py``, ``conv_mode="ct"``).

The second version of ``ops/fft_mxu.py``'s permuted 4-step DFT, with its
three changes:

- **Pair packing.** Two real images ride one complex transform, the
  Hermitian unpacking folded into precomputed spectra ``W = A Z + B
  conj(Z~)`` as in ``ops.fft.convolve_fft_packed_pair``. The negation
  ``Z~[m] = Z[-m]`` is a permutation in the CT layout too: on each
  flattened ``(k1, k2)`` axis slot ``0`` stays, slots ``1 .. n2 - 1`` flip
  among themselves and slots ``n2 .. N - 1`` among themselves
  (:func:`_neg_freq_last`).
- **Karatsuba's three products** for each complex contraction (``t1 = xr
  M_r``, ``t2 = xi M_i``, ``t3 = (xr + xi)(M_r + M_i)``), each from three
  products of bf16 hi/lo parts summed in float32 (``"split3"``, about
  2^-16 relative); ``"highest"`` takes plain float32 products.
- **Factors** (:func:`ct_conv_shape`) with one large leading factor,
  ``ct_factor(n)[0]`` the largest divisor up to 256 (1089 = 121 x 9).

A real image goes through :func:`ct_convolve_single` (the first forward
and the last inverse stage then take two real products instead of
three); observation pairs go through :func:`ct_convolve_pair`. Both
have the same convolution with conjugate spectra as their adjoint, in
a ``torch.autograd.Function`` whose backward runs differentiable
stages, so that the flux-error probe can differentiate twice.

The tables are computed in float64 on the host; their bf16 hi/lo parts
(the lo parts rounded to bf16 as well) and the Karatsuba sums are kept
as float32 tensors. Every product is a float32 product (TF32 stays off,
``config``); the operands are never multiplied as bf16 tensors, which
would round each sum to bf16.
"""

from functools import lru_cache

import numpy as np
import torch

from .fft import _origin_centered_numpy, _unbroadcast, fft_conv_shape
from .linalg import bf16_split
from .splitfp import bf16_round, check_precision

__all__ = [
    "ct_build_pair_spectra",
    "ct_conv_shape",
    "ct_convolve_pair",
    "ct_convolve_single",
    "ct_dft2",
    "ct_factor",
    "ct_idft2",
    "ct_kernel_pair",
    "ct_kernel_spectra",
    "make_ct_tables",
]

_PARTS = ("r", "i", "s", "r_hi", "r_lo", "i_hi", "i_lo", "s_hi", "s_lo")
_KEYS = ("f1", "f2", "tw", "f1i", "f2i", "twi")


# ----------------------------------------------------------------- shapes

def ct_factor(n):
    """``(n1, n2)`` with ``n1`` the largest divisor of ``n`` up to 256."""
    for n1 in range(min(n, 256), 0, -1):
        if n % n1 == 0:
            return (n1, n // n1)
    return None


def ct_conv_shape(min_size):
    """Of the 128 sizes from ``min_size``, those whose leading factor is at
    least 32, the one of least estimated cost ``n (n1 / u + 3 n2)`` with
    ``u = min(n1, 128) / 128`` (the JAX package's rule, kept so that both
    packages pick the same transform)."""
    best = None
    for n in range(int(min_size), int(min_size) + 128):
        n1, n2 = ct_factor(n)
        if n1 < 32:
            continue
        util1 = min(n1, 128) / 128.0
        cost = n * (n1 / util1 + 3.0 * n2)
        if best is None or cost < best[0]:
            best = (cost, n)
    return best[1] if best else int(min_size)


# ----------------------------------------------------------------- tables

@lru_cache(maxsize=32)
def _axis_tables_np(n, n1):
    """Stage matrices and twiddles of one axis, complex128."""
    n2 = n // n1
    if n1 * n2 != n:
        raise ValueError(f"{n1} does not divide {n}")
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    return {"f1": f1, "f2": f2, "tw": tw, "f1i": np.conj(f1) / n1,
            "f2i": np.conj(f2) / n2, "twi": np.conj(tw)}


def _parts(m, device):
    """float32 real and imaginary parts of a complex matrix, their sum
    (Karatsuba's third operand), and bf16 hi/lo splits of each, the lo
    parts rounded to bf16 too."""
    out = {}
    re = np.asarray(m.real, np.float32)
    im = np.asarray(m.imag, np.float32)
    for name, arr in (("r", re), ("i", im), ("s", re + im)):
        arr = torch.as_tensor(arr, device=device)
        out[name] = arr
        out[f"{name}_hi"], out[f"{name}_lo"] = bf16_split(arr)
    return out


def make_ct_tables(fft_shape, factors=None, device=None):
    """The float32 parts of both axes' stage matrices and twiddles for a
    2-D permuted DFT of ``fft_shape`` on ``device`` (default the CPU),
    keyed ``"{rows|cols}_{f1|f2|tw|f1i|f2i|twi}_{part}"`` as in the JAX
    package; ``factors`` ``((n1r, n2r), (n1c, n2c))`` defaults to
    :func:`ct_factor` of each axis."""
    rows, cols = int(fft_shape[0]), int(fft_shape[1])
    if factors is None:
        factors = (ct_factor(rows), ct_factor(cols))
    out = {}
    for prefix, n, (n1, _) in (("rows", rows, factors[0]),
                               ("cols", cols, factors[1])):
        tables = _axis_tables_np(n, n1)
        for key in _KEYS:
            for part, tensor in _parts(tables[key], device).items():
                out[f"{prefix}_{key}_{part}"] = tensor
    return out


def _perm_index(n, n1):
    """Natural frequency at each flattened CT slot: slot ``j = k1 n2 + k2``
    holds frequency ``k1 + n1 k2``."""
    n2 = n // n1
    j = np.arange(n)
    return j // n2 + n1 * (j % n2)


def ct_kernel_pair(kernel0, kernel1, image_shape, fft_shape, factors=None,
                   device=None):
    """Packed-pair spectra ``(a_re, a_im, b_re, b_im)`` of two kernels in
    the permuted CT layout: ``A = (F0 + F1) / 2``, ``B = (F0 - F1) / 2`` of
    the origin-centered kernels (``(..., kh, kw)`` arrays), from float64
    numpy FFTs reindexed per axis; float32 tensors on ``device``."""
    min0 = fft_conv_shape(image_shape, np.shape(kernel0))
    min1 = fft_conv_shape(image_shape, np.shape(kernel1))
    if (fft_shape[0] < max(min0[0], min1[0])
            or fft_shape[1] < max(min0[1], min1[1])):
        raise ValueError(
            f"fft_shape {fft_shape} too small for linear convolution"
        )
    if factors is None:
        factors = (ct_factor(int(fft_shape[0])), ct_factor(int(fft_shape[1])))
    f0, f1 = (np.fft.fft2(_origin_centered_numpy(k, fft_shape), s=fft_shape)
              for k in (kernel0, kernel1))
    a, b = 0.5 * (f0 + f1), 0.5 * (f0 - f1)
    pr = _perm_index(int(fft_shape[0]), factors[0][0])
    pc = _perm_index(int(fft_shape[1]), factors[1][0])
    a = a[..., pr, :][..., :, pc]
    b = b[..., pr, :][..., :, pc]
    return tuple(torch.as_tensor(np.ascontiguousarray(part, np.float32),
                                 device=device)
                 for part in (a.real, a.imag, b.real, b.imag))


# ------------------------------------------------------------- transforms

def _axis_view(tables, prefix):
    view = {key: {p: tables[f"{prefix}_{key}_{p}"] for p in _PARTS}
            for key in _KEYS}
    view["n1"] = view["f1"]["r"].shape[0]
    view["n2"] = view["f2"]["r"].shape[0]
    return view


def _split_mm(spec, x, hi, lo):
    """``einsum(spec, x, m)`` from three products of bf16 parts (``m``'s
    from the tables, ``x``'s split here) summed in float32."""
    x_hi = bf16_round(x)
    x_lo = x - x_hi
    return (torch.einsum(spec, x_hi, hi) + torch.einsum(spec, x_lo, hi)
            + torch.einsum(spec, x_hi, lo))


def _mm_real(spec, x, m, part, precision):
    """Real contraction of ``x`` with one part (``"r"``, ``"i"`` or
    ``"s"``) of a complex matrix."""
    if precision == "split3":
        return _split_mm(spec, x, m[f"{part}_hi"], m[f"{part}_lo"])
    return torch.einsum(spec, x, m[part])


def _cmm(spec, xr, xi, m, precision):
    """Karatsuba's complex contraction ``(xr + i xi) M`` in three real
    ones: ``re = t1 - t2``, ``im = t3 - t1 - t2``."""
    t1 = _mm_real(spec, xr, m, "r", precision)
    t2 = _mm_real(spec, xi, m, "i", precision)
    t3 = _mm_real(spec, xr + xi, m, "s", precision)
    return t1 - t2, t3 - t1 - t2


def _twiddle(ar, ai, tw):
    twr, twi = tw["r"], tw["i"]
    return ar * twr - ai * twi, ar * twi + ai * twr


def _flat(x, lead, n):
    return x.reshape(lead + (n,))


def _ct_axis_last(xr, xi, view, inverse, precision):
    """Permuted (inverse) DFT along the last axis, in real arithmetic."""
    n1, n2 = view["n1"], view["n2"]
    lead = xr.shape[:-1]
    xr = xr.reshape(lead + (n1, n2))
    xi = xi.reshape(lead + (n1, n2))
    if not inverse:
        ar, ai = _cmm("...nt,nk->...kt", xr, xi, view["f1"], precision)
        ar, ai = _twiddle(ar, ai, view["tw"])
        outr, outi = _cmm("...kt,tj->...kj", ar, ai, view["f2"], precision)
    else:
        ar, ai = _cmm("...kj,jt->...kt", xr, xi, view["f2i"], precision)
        ar, ai = _twiddle(ar, ai, view["twi"])
        outr, outi = _cmm("...kt,kn->...nt", ar, ai, view["f1i"], precision)
    return _flat(outr, lead, n1 * n2), _flat(outi, lead, n1 * n2)


def _ct_axis_last_realin(x, view, precision):
    """Forward permuted DFT along the last axis of a real input: stage 1
    takes two real products instead of Karatsuba's three."""
    n1, n2 = view["n1"], view["n2"]
    lead = x.shape[:-1]
    x = x.reshape(lead + (n1, n2))
    ar = _mm_real("...nt,nk->...kt", x, view["f1"], "r", precision)
    ai = _mm_real("...nt,nk->...kt", x, view["f1"], "i", precision)
    ar, ai = _twiddle(ar, ai, view["tw"])
    outr, outi = _cmm("...kt,tj->...kj", ar, ai, view["f2"], precision)
    return _flat(outr, lead, n1 * n2), _flat(outi, lead, n1 * n2)


def _ct_axis_last_realout(xr, xi, view, precision):
    """Inverse permuted DFT along the last axis keeping the real part
    only: the last stage takes two real products instead of three."""
    n1, n2 = view["n1"], view["n2"]
    lead = xr.shape[:-1]
    xr = xr.reshape(lead + (n1, n2))
    xi = xi.reshape(lead + (n1, n2))
    ar, ai = _cmm("...kj,jt->...kt", xr, xi, view["f2i"], precision)
    ar, ai = _twiddle(ar, ai, view["twi"])
    out = (_mm_real("...kt,kn->...nt", ar, view["f1i"], "r", precision)
           - _mm_real("...kt,kn->...nt", ai, view["f1i"], "i", precision))
    return _flat(out, lead, n1 * n2)


def _t(x):
    return x.transpose(-1, -2)


def _ct2_parts(xr, xi, tables, inverse, precision):
    """2-D permuted (inverse) DFT: the columns' pass, then the rows'."""
    cols, rows = _axis_view(tables, "cols"), _axis_view(tables, "rows")
    xr, xi = _ct_axis_last(xr, xi, cols, inverse, precision)
    xr, xi = _ct_axis_last(_t(xr), _t(xi), rows, inverse, precision)
    return _t(xr), _t(xi)


def _real_imag(z):
    if z.is_complex():
        return z.real, z.imag
    return z, torch.zeros_like(z)


def ct_dft2(z, tables, precision="split3"):
    """Permuted 2-D DFT of a ``(..., rows, cols)`` tensor (complex out)."""
    check_precision(precision)
    xr, xi = _ct2_parts(*_real_imag(z), tables, False, precision)
    return torch.complex(xr, xi)


def ct_idft2(z, tables, precision="split3"):
    """Inverse of :func:`ct_dft2`."""
    check_precision(precision)
    xr, xi = _ct2_parts(*_real_imag(z), tables, True, precision)
    return torch.complex(xr, xi)


def _neg_freq_last(x, n2):
    """Frequency negation along the last (flattened CT) axis: ``out[j] =
    x[slot of -freq(j)]``. Slot 0 stays, slots ``[1, n2)`` flip among
    themselves, slots ``[n2, N)`` flip among themselves (from ``k1' =
    (n1 - k1) % n1``, ``k2' = (n2 - k2 - [k1 > 0]) % n2``)."""
    return torch.cat([x[..., :1], torch.flip(x[..., 1:n2], dims=(-1,)),
                      torch.flip(x[..., n2:], dims=(-1,))], dim=-1)


def _neg_freq2(x, n2r, n2c):
    """2-D frequency negation in the CT layout (both axes)."""
    return _t(_neg_freq_last(_t(_neg_freq_last(x, n2c)), n2r))


# ------------------------------------------------------------ convolution

def _pad_to(x, fft_shape):
    h, w = x.shape[-2], x.shape[-1]
    return torch.nn.functional.pad(
        x, (0, int(fft_shape[1]) - w, 0, int(fft_shape[0]) - h))


def _ct_conv_pair_impl(x0, x1, ar, ai, br, bi, tables, fft_shape,
                       precision):
    h, w = x0.shape[-2], x0.shape[-1]
    zr, zi = _ct2_parts(_pad_to(x0, fft_shape), _pad_to(x1, fft_shape),
                        tables, False, precision)
    n2r = _axis_view(tables, "rows")["n2"]
    n2c = _axis_view(tables, "cols")["n2"]
    # W = A Z + B conj(Z~): the Hermitian unpacking folded into (A, B)
    zrr, zri = _neg_freq2(zr, n2r, n2c), _neg_freq2(zi, n2r, n2c)
    wr = ar * zr - ai * zi + br * zrr + bi * zri
    wi = ar * zi + ai * zr + bi * zrr - br * zri
    yr, yi = _ct2_parts(wr, wi, tables, True, precision)
    return yr[..., :h, :w], yi[..., :h, :w]


class _ConvolvePair(torch.autograd.Function):
    """The pair convolution; its adjoint is the same convolution with the
    conjugate spectra (a pair of correlations), run through differentiable
    stages so that it can be differentiated again."""

    @staticmethod
    def forward(ctx, x0, x1, ar, ai, br, bi, tables, fft_shape, precision):
        ctx.save_for_backward(ar, ai, br, bi)
        ctx.args = (tables, fft_shape, precision)
        ctx.shapes = (tuple(x0.shape), tuple(x1.shape))
        return _ct_conv_pair_impl(x0, x1, ar, ai, br, bi, tables, fft_shape,
                                  precision)

    @staticmethod
    def backward(ctx, g0, g1):
        ar, ai, br, bi = ctx.saved_tensors
        d0, d1 = _ct_conv_pair_impl(g0, g1, ar, -ai, br, -bi, *ctx.args)
        return (_unbroadcast(d0, ctx.shapes[0]),
                _unbroadcast(d1, ctx.shapes[1])) + (None,) * 7


def ct_convolve_pair(x0, x1, ar, ai, br, bi, tables, fft_shape,
                     precision="split3"):
    """Convolve two real image stacks with two kernels through one CT
    transform: ``(y0, y1) = (x0 * k0, x1 * k1)`` cropped to the input
    shape, ``(ar, ai, br, bi)`` from :func:`ct_kernel_pair` or
    :func:`ct_build_pair_spectra` at ``fft_shape``. The gradient costs one
    forward (conjugate spectra); the spectra take none."""
    check_precision(precision)
    return _ConvolvePair.apply(x0, x1, ar, ai, br, bi, tables,
                               tuple(fft_shape), precision)


def _ct_conv_single_impl(x, fr, fi, tables, fft_shape, precision):
    h, w = x.shape[-2], x.shape[-1]
    cols, rows = _axis_view(tables, "cols"), _axis_view(tables, "rows")
    zr, zi = _ct_axis_last_realin(_pad_to(x, fft_shape), cols, precision)
    zr, zi = _ct_axis_last(_t(zr), _t(zi), rows, False, precision)
    zr, zi = _t(zr), _t(zi)
    wr, wi = fr * zr - fi * zi, fr * zi + fi * zr
    yr, yi = _ct_axis_last(wr, wi, cols, True, precision)
    out = _ct_axis_last_realout(_t(yr), _t(yi), rows, precision)
    return _t(out)[..., :h, :w]


class _ConvolveSingle(torch.autograd.Function):
    """The single-image convolution; adjoint as :class:`_ConvolvePair`'s."""

    @staticmethod
    def forward(ctx, x, fr, fi, tables, fft_shape, precision):
        ctx.save_for_backward(fr, fi)
        ctx.args = (tables, fft_shape, precision)
        ctx.shape = tuple(x.shape)
        return _ct_conv_single_impl(x, fr, fi, tables, fft_shape, precision)

    @staticmethod
    def backward(ctx, g):
        fr, fi = ctx.saved_tensors
        dx = _ct_conv_single_impl(g, fr, -fi, *ctx.args)
        return (_unbroadcast(dx, ctx.shape),) + (None,) * 5


def ct_convolve_single(x, fr, fi, tables, fft_shape, precision="split3"):
    """Convolve a real image stack through the permuted matrix DFT, with
    the kernels' CT spectra ``(fr, fi)`` from :func:`ct_kernel_spectra`:
    the per-observation twin of :func:`ct_convolve_pair` (an odd count of
    observations, a row-sharded loss). The first forward and the last
    inverse stage take two real products; no frequency negation. The
    gradient costs one forward (conjugate spectrum)."""
    check_precision(precision)
    return _ConvolveSingle.apply(x, fr, fi, tables, tuple(fft_shape),
                                 precision)


def ct_kernel_spectra(embedded, tables):
    """CT spectra ``(re, im)`` of origin-centered embedded kernels at
    ``"highest"`` precision."""
    z = ct_dft2(embedded.to(torch.complex64), tables, "highest")
    return z.real, z.imag


def ct_build_pair_spectra(embedded, tables):
    """Packed-pair CT spectra ``(a_re, a_im, b_re, b_im)`` of a kernel
    stack: ``embedded`` ``(n, ..., fh, fw)`` holds the origin-centered
    kernels (``ops.fft._origin_centered``) at the transform shape, and
    kernels ``2i`` and ``2i + 1`` pack into one ``"highest"`` transform
    whose Hermitian unpacking is folded in; ``n // 2`` pairs."""
    n_pairs = embedded.shape[0] // 2
    k0 = embedded[0:2 * n_pairs:2]
    k1 = embedded[1:2 * n_pairs:2]
    n2r = _axis_view(tables, "rows")["n2"]
    n2c = _axis_view(tables, "cols")["n2"]
    z = ct_dft2(torch.complex(k0, k1), tables, "highest")
    zc = torch.conj(_neg_freq2(z, n2r, n2c))
    f0 = 0.5 * (z + zc)
    f1 = -0.5j * (z - zc)
    a, b = 0.5 * (f0 + f1), 0.5 * (f0 - f1)
    return a.real, a.imag, b.real, b.imag
