"""Pair-packed convolution by a two-stage matrix DFT (``conv_mode="pfft"``).

Counterpart of the JAX package's ``ops/pallas_fft.py``. Two real image
batches ``x0``, ``x1`` of shape ``(P, H, W)`` (``H``, ``W`` multiples of
128) are convolved with the kernel pairs ``(k0, k1)`` through one complex
transform of ``x0 + i x1`` at a size ``n = 128 m``:

    y0 + i y1 = IFFT2(A . Z) + FWDP2(B2 . conj(Z)),    Z = FFT2(x0 + i x1),

with the spectra ``A = (K0 + K1)/2`` and ``B2``, the frequency-reversed
``(K0 - K1)/2``, precomputed in a permuted order: storage position
``128 k2 + k1`` holds frequency ``m k1 + k2``. Each 1-D transform factors
into stage A, an ``m``-point DFT over 128-strided blocks, and stage B,
``m`` complex products with ``128 x 128`` matrices that carry the size-n
twiddles (:func:`_stage_tables`). ``FWDP`` is the inverse with conjugate
tables; the permutation cancels between the forward and the inverse, so
nothing is reordered on the device. The spectra keep the JAX package's
layout, four float32 planes ``(a_re, a_im, b2_re, b2_im)``, so both
packages take the same arrays.

Three passes, as the JAX package's three kernel bodies (``_k1_body``,
``_k2_body``, ``_k3_body``): the axis-0 forward into permuted rows; per
row the lane forward, the spectrum combine and the lane inverse; the
axis-0 inverse, cropped to ``(H, W)``. Each pass has two implementations
with one contract:

- a CUDA kernel written by hand for Hopper, run for a tensor on a CUDA
  card. In ``"f32"`` mode (the ``"highest"`` setting's)
  :func:`pfft_cols_fwd_cuda`, :func:`pfft_rows_combine_cuda` and
  :func:`pfft_cols_inv_cuda` on the tensor cores
  (``csrc/pfft_conv_wg.cu``, ``wgmma``: six bf16 products of three-way
  splits, :func:`bf16_split3`, summed in float32, the TPU's
  ``Precision.HIGHEST``). In ``"split"`` mode (the
  default dial's) the three passes run on the tensor cores too, three
  bf16 products a step (``csrc/pfft_conv_wg.cu``, ``wgmma``):
  :func:`pfft_cols_fwd_tc_cuda`, :func:`pfft_rows_combine_tc_cuda` and
  :func:`pfft_cols_inv_tc_cuda`; in ``"bf16"`` mode (the ``"default"``
  setting's) the same kernels with one product a step:
  :func:`pfft_cols_fwd_bf16_cuda`, :func:`pfft_rows_combine_bf16_cuda`,
  :func:`pfft_cols_inv_bf16_cuda`. The file's header says what bounds
  each kernel and how it is built;
- a plain PyTorch version (einsums on the stage tables), run for a
  tensor on the CPU and the reference of the kernels on the card:
  :func:`conv_packed_pfft_plain`, in float32 or float64.

The rule is ``config.dispatch``. Each wrapper counts its launches
(``pfft_cols_fwd_cuda.launches``, ...) and the plain version its calls.

``"split"`` computes each stage-B product of the three passes as the
JAX package's ``_dot`` does: both operands split into bf16 high and low
parts, three products ``hi.hi + hi.lo + lo.hi`` summed in float32.
``"bf16"`` likewise: both operands rounded to bf16, one product summed
in float32. The plain version's complex product ``x . M`` runs as a
real product of the interleaved row ``(re, im, re, im, ...)`` with the
interleaved real ``(256, 256)`` form of ``M``
(:func:`interleaved_stage_matrices`), 4 real products per complex one
where the TPU takes Karatsuba's 3 (and, in ``"bf16"``, also rounds their
``re + im`` sums to bf16); the kernels take the same bf16 products from
the planes of ``M``'s real and imaginary parts (:func:`wg_stage_tables`),
so on the CPU the ``"pfft"`` path matches the card's kernels of either
mode to summation order. In float64 the mode is ignored: that is the
anchor.

The adjoint of the convolution is the correlation: the same pipeline
with the imaginary parts of both spectra negated (``conj_spec``). The
autograd rule applies that pipeline as a differentiable function, so
the gradient has a graph and a second derivative (the flux-error probe,
reverse over reverse) costs one more pipeline. The spectra take no
gradient.
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import dispatch, pfft_mode
from .fft import _origin_centered, fft_conv_shape
from .gmm_fused import TC_PRODUCTS, _check, _raise_on_error
from .linalg import bf16_round, bf16_split, bf16_split3

__all__ = [
    "PFFT_LANE",
    "bf16_split",
    "bf16_split3",
    "cols_fwd_plain",
    "cols_inv_plain",
    "conv_packed_pfft",
    "conv_packed_pfft_plain",
    "default_pfft_mode",
    "interleaved_stage_matrices",
    "pfft_cols_fwd_bf16_cuda",
    "pfft_cols_fwd_cuda",
    "pfft_cols_fwd_tc_cuda",
    "pfft_cols_inv_bf16_cuda",
    "pfft_cols_inv_cuda",
    "pfft_cols_inv_tc_cuda",
    "pfft_conv_cuda",
    "pfft_pair_spectra",
    "pfft_pair_spectra_device",
    "pfft_rows_combine_bf16_cuda",
    "pfft_rows_combine_cuda",
    "pfft_rows_combine_tc_cuda",
    "pfft_size",
    "reset_counters",
    "rows_combine_plain",
    "wg_f32_tables",
    "wg_stage_tables",
]

PFFT_LANE = 128  # stage-B block; transform sizes are multiples of this
MODES = ("f32", "split", "bf16")


def default_pfft_mode():
    """The matmul-DFT mode the precision dial names (``config.pfft_mode``):
    ``highest`` -> ``f32``, ``high`` -> ``split``, ``default`` -> ``bf16``."""
    return pfft_mode()


def pfft_size(n):
    """Smallest transform size ``128 m >= n``."""
    return -(-int(n) // PFFT_LANE) * PFFT_LANE


@lru_cache(maxsize=8)
def interleaved_stage_matrices(m):
    """The stage-B matrices ``mf[k2]`` and ``mi[k2]`` in interleaved real
    form, float32 ``(m, 256, 256)`` each.

    For a complex ``M`` applied from the right (``x . M``),
    ``R[2k, 2j] = Re M[k, j]``, ``R[2k, 2j + 1] = Im M[k, j]``,
    ``R[2k + 1, 2j] = -Im M[k, j]`` and ``R[2k + 1, 2j + 1] = Re M[k, j]``:
    a complex row as it lies in memory, ``(re, im, ...)``, times ``R`` is
    ``x . M`` in the same layout.
    """
    t = _stage_tables(m)

    def interleave(mat):
        r = np.empty((m, 2 * PFFT_LANE, 2 * PFFT_LANE))
        r[:, 0::2, 0::2] = mat.real
        r[:, 0::2, 1::2] = mat.imag
        r[:, 1::2, 0::2] = -mat.imag
        r[:, 1::2, 1::2] = mat.real
        return r.astype(np.float32)

    return {"mf": interleave(t["mf"]), "mi": interleave(t["mi"])}


@lru_cache(maxsize=8)
def _stage_tables(m):
    """Stage tables of the size ``n = 128 m`` transform (complex128).

    - ``wf[n2, k2] = exp(-2 pi i n2 k2 / m)``, ``wi[a, k2]`` its conjugate:
      stage A of the forward and of the inverse;
    - ``mf[k2][n1, k1] = W128^{n1 k1} Wn^{n1 k2}`` and
      ``mi[k2][k1, b] = W128^{-b k1} Wn^{-b k2} / n`` (``W_N =
      exp(-2 pi i / N)``): stage B of the forward and of the inverse.
    """
    n = PFFT_LANE * m
    i = np.arange(PFFT_LANE, dtype=np.float64)[:, None]
    j = np.arange(PFFT_LANE, dtype=np.float64)[None, :]
    mf = np.stack([np.exp(-2j * np.pi * i * j / PFFT_LANE)
                   * np.exp(-2j * np.pi * i * k2 / n) for k2 in range(m)])
    mi = np.stack([np.exp(2j * np.pi * j * i / PFFT_LANE)
                   * np.exp(2j * np.pi * j * k2 / n) / n for k2 in range(m)])
    wf = np.exp(-2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    return {"wf": wf, "wi": wf.conj(), "mf": mf, "mi": mi}


def _perm(n):
    """Natural frequency index held at each storage position."""
    m = n // PFFT_LANE
    p = np.arange(n)
    return m * (p % PFFT_LANE) + p // PFFT_LANE


def _check_size(n, need):
    n = int(n)
    if n % PFFT_LANE:
        raise ValueError(
            f"pfft transform size must be a multiple of {PFFT_LANE}, got {n}"
        )
    if n < need:
        raise ValueError(
            f"pfft size {n} too small for linear convolution, need >= {need}"
        )
    return n


def _min_size(image_shape, shape0, shape1):
    min0 = fft_conv_shape(image_shape, shape0)
    min1 = fft_conv_shape(image_shape, shape1)
    return max(min0[0], min1[0], min0[1], min1[1])


def pfft_pair_spectra(kernel0, kernel1, image_shape, n):
    """Permuted packed spectra of one kernel pair, on the host (numpy).

    Origin-centered kernels, float64 transforms; returns the four float32
    planes ``(a_re, a_im, b2_re, b2_im)`` of shape ``(n, n)``, with ``B``
    frequency-reversed so that the pipeline needs no reversal.
    """
    n = _check_size(n, _min_size(image_shape, np.shape(kernel0),
                                 np.shape(kernel1)))
    fs = (n, n)

    def spectrum(kernel):
        kernel = np.asarray(kernel, np.float64)
        kh, kw = kernel.shape
        padded = np.pad(kernel, ((0, n - kh), (0, n - kw)))
        padded = np.roll(padded, (-((kh - 1) // 2), -((kw - 1) // 2)),
                         axis=(0, 1))
        return np.fft.fft2(padded, s=fs)

    f0, f1 = spectrum(kernel0), spectrum(kernel1)
    a = 0.5 * (f0 + f1)
    b = 0.5 * (f0 - f1)
    rev = (-np.arange(n)) % n
    p = _perm(n)
    a = a[p][:, p]
    b2 = b[rev][:, rev][p][:, p]
    return tuple(np.ascontiguousarray(t, np.float32)
                 for t in (a.real, a.imag, b2.real, b2.imag))


def pfft_pair_spectra_device(kernels_even, kernels_odd, image_shape, n):
    """:func:`pfft_pair_spectra` for stacked kernels, on their device.

    ``kernels_even``/``kernels_odd`` are ``(P, ..., kh, kw)`` tensors;
    returns four float32 plane stacks ``(P, ..., n, n)``. The transforms
    run in float64 (complex128), so the planes match the host version's
    to float32 rounding.
    """
    n = _check_size(n, _min_size(image_shape, kernels_even.shape,
                                 kernels_odd.shape))
    device = kernels_even.device
    perm = torch.as_tensor(_perm(n), device=device)
    rev = torch.as_tensor((-np.arange(n)) % n, device=device)

    def spectrum(kernels):
        return torch.fft.fft2(
            _origin_centered(kernels.to(torch.float64), (n, n)), s=(n, n))

    f0, f1 = spectrum(kernels_even), spectrum(kernels_odd)
    a = 0.5 * (f0 + f1)
    b2 = (0.5 * (f0 - f1))[..., rev, :][..., rev]
    a = a[..., perm, :][..., perm]
    b2 = b2[..., perm, :][..., perm]
    return tuple(t.to(torch.float32).contiguous()
                 for t in (a.real, a.imag, b2.real, b2.imag))


# ----------------------------------------------------------------------
# plain versions


@lru_cache(maxsize=16)
def _plain_tables(m, dtype, device):
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return {name: torch.as_tensor(t, dtype=cdtype, device=device)
            for name, t in _stage_tables(m).items()}


@lru_cache(maxsize=16)
def _split_tables(m, device):
    """:func:`interleaved_stage_matrices` split into bf16 hi and lo, as
    float32 ``(m, 256, 256)`` tensors on ``device``."""
    return {name: bf16_split(torch.as_tensor(r, device=device))
            for name, r in interleaved_stage_matrices(m).items()}


def _mode_tables(m, device, mode):
    """The interleaved stage matrices as the bf16 mode ``mode`` takes
    them: ``(hi, lo)`` for ``"split"``, ``(hi,)`` (their bf16 rounding)
    for ``"bf16"``."""
    tables = _split_tables(m, device)
    if mode == "split":
        return tables
    return {name: parts[:1] for name, parts in tables.items()}


def _tc_product(x, r):
    """``x . M[k2]`` for complex64 ``x`` ``(..., m, rows, 128)`` and the
    interleaved ``M`` in the planes ``r`` of :func:`_mode_tables`
    ``(m, 256, 256)``: ``(hi, lo)``, the three bf16 products of
    ``"split"``, or ``(hi,)``, the one of ``"bf16"``, summed in
    float32."""
    shape = x.shape
    xr = torch.view_as_real(x.contiguous()).reshape(*shape[:-1], 2 * PFFT_LANE)
    if len(r) == 2:
        x_hi, x_lo = bf16_split(xr)
        r_hi, r_lo = r
        out = x_hi @ r_hi + x_hi @ r_lo + x_lo @ r_hi
    else:
        out = bf16_round(xr) @ r[0]
    return torch.view_as_complex(out.reshape(*shape, 2).contiguous())


def _tc_mode(mode, dtype):
    """The bf16 mode (``"split"`` or ``"bf16"``) that ``mode`` computes in
    ``dtype``, or None (``"f32"``, and every mode in float64)."""
    if mode not in MODES:
        raise ValueError(f"invalid pfft mode {mode!r}, expected one of "
                         f"{MODES}")
    return mode if mode != "f32" and dtype == torch.float32 else None


def cols_fwd_plain(x0, x1, n, dtype=torch.float32, mode="f32"):
    """Pass 1: the axis-0 forward of ``x0 + i x1`` ``(P, H, W)`` into
    permuted rows, ``U`` ``(P, n, W)`` complex. ``"split"`` and
    ``"bf16"`` in float32 take the stage-B products as the tensor-core
    kernels do: since
    ``mf[k2][n1, k1] = W128^(n1 k1) Wn^(n1 k2)``, stage A in float32 ends
    with the twiddle ``mf[k2][n1, 0] = Wn^(n1 k2)`` on the rows of
    ``S_k2``, and each of its columns is a row times ``F = mf[0]``, the
    128-point DFT, for every ``k2``."""
    p_, h, w = x0.shape
    m = n // PFFT_LANE
    t = _plain_tables(m, dtype, x0.device)
    z = torch.complex(x0.to(dtype), x1.to(dtype))
    s = torch.einsum("qk,pqiw->pkiw", t["wf"][:h // PFFT_LANE],
                     z.reshape(p_, h // PFFT_LANE, PFFT_LANE, w))
    tc = _tc_mode(mode, dtype)
    if tc:
        f = tuple(part[:1].expand(m, -1, -1)
                  for part in _mode_tables(m, x0.device, tc)["mf"])
        # (P, m, W, 128) rows of (tw S)^T times F, back to (P, m, 128, W)
        s = s * t["mf"][:, :, :1]
        u = _tc_product(s.transpose(-1, -2), f).transpose(-1, -2)
        return u.reshape(p_, n, w)
    return torch.einsum("kij,pkiw->pkjw", t["mf"], s).reshape(p_, n, w)


def rows_combine_plain(u, a_re, a_im, b2_re, b2_im, conj_spec=False,
                       dtype=torch.float32, mode="f32"):
    """Pass 2: per row of ``U``, the lane forward ``Z``, then
    ``V1 = IFFT(A . Z)`` and ``V2 = FWDP(B2 . conj(Z))`` along the lanes,
    cropped to ``W`` columns: ``(P, n, W)`` complex each. ``"split"`` and
    ``"bf16"`` in float32 take the stage-B products as the tensor-core
    kernels do, with ``V2``'s inverse as ``conj((conj(B2) . Z) . mi)``."""
    p_, n, w = u.shape
    m, wb = n // PFFT_LANE, w // PFFT_LANE
    t = _plain_tables(m, dtype, u.device)
    tc = _tc_mode(mode, dtype)
    s = torch.einsum("qk,prqi->prki", t["wf"][:wb],
                     u.reshape(p_, n, wb, PFFT_LANE))
    sign = -1.0 if conj_spec else 1.0
    a = torch.complex(a_re.to(dtype), sign * a_im.to(dtype))
    b2 = torch.complex(b2_re.to(dtype), sign * b2_im.to(dtype))
    if tc:
        r = _mode_tables(m, u.device, tc)
        # per k2 block: (P, m, n, 128)
        z = _tc_product(s.transpose(1, 2), r["mf"])
        spec = (lambda x: x.reshape(p_, n, m, PFFT_LANE).transpose(1, 2))
        g1 = _tc_product(spec(a) * z, r["mi"]).transpose(1, 2)
        g2 = _tc_product(spec(b2).conj() * z, r["mi"]).conj().transpose(
            1, 2)
    else:
        z = torch.einsum("prki,kij->prkj", s, t["mf"]).reshape(p_, n, n)
        g1 = torch.einsum("prki,kij->prkj",
                          (a * z).reshape(p_, n, m, PFFT_LANE), t["mi"])
        g2 = torch.einsum("prki,kij->prkj",
                          (b2 * z.conj()).reshape(p_, n, m, PFFT_LANE),
                          t["mi"].conj())
    v1 = torch.einsum("ak,prkj->praj", t["wi"][:wb], g1)
    v2 = torch.einsum("ak,prkj->praj", t["wi"][:wb].conj(), g2)
    return v1.reshape(p_, n, w), v2.reshape(p_, n, w)


def cols_inv_plain(v1, v2, h, dtype=torch.float32, mode="f32"):
    """Pass 3: the axis-0 inverse of ``V1`` plus the permuted forward of
    ``V2``, rows cropped to ``h``: ``(y0, y1)``, the real and imaginary
    parts, ``(P, h, W)`` each. ``"split"`` and ``"bf16"`` in float32 take
    the products as the tensor-core kernels do: ``y0 = Re(sum_k2 wi mi^T
    (V1 + conj V2))`` and ``y1 = Im(sum_k2 wi mi^T (V1 - conj V2))``,
    each column of ``V1 +- conj V2`` a row times ``mi[k2]``."""
    p_, n, w = v1.shape
    m, hb = n // PFFT_LANE, h // PFFT_LANE
    t = _plain_tables(m, dtype, v1.device)
    tc = _tc_mode(mode, dtype)
    if tc:
        r = _mode_tables(m, v1.device, tc)["mi"]

        def inverse(x):  # (P, n, W) -> (P, m, W, 128) -> (P, h, W)
            g = _tc_product(x.reshape(p_, m, PFFT_LANE, w)
                            .transpose(-1, -2), r)
            return torch.einsum("ak,pkwj->pajw", t["wi"][:hb],
                                g).reshape(p_, h, w)

        v2c = v2.conj()
        return (inverse(v1 + v2c).real.contiguous(),
                inverse(v1 - v2c).imag.contiguous())
    g1 = torch.einsum("kij,pkiw->pkjw", t["mi"],
                      v1.reshape(p_, m, PFFT_LANE, w))
    g2 = torch.einsum("kij,pkiw->pkjw", t["mi"].conj(),
                      v2.reshape(p_, m, PFFT_LANE, w))
    y = (torch.einsum("ak,pkjw->pajw", t["wi"][:hb], g1)
         + torch.einsum("ak,pkjw->pajw", t["wi"][:hb].conj(), g2))
    y = y.reshape(p_, h, w)
    return y.real.contiguous(), y.imag.contiguous()


def conv_packed_pfft_plain(x0, x1, a_re, a_im, b2_re, b2_im, n,
                           conj_spec=False, dtype=torch.float32, mode="f32"):
    """The three passes in plain PyTorch, in ``dtype`` (float32 or
    float64); same contract as :func:`conv_packed_pfft` without the
    autograd rule. ``mode`` acts in float32 only (``"split"``, ``"bf16"``:
    the three passes as the tensor-core kernels compute them). Returns
    ``(y0, y1)`` in ``dtype``."""
    conv_packed_pfft_plain.calls += 1
    _check_images(x0, x1, n)
    u = cols_fwd_plain(x0, x1, n, dtype, mode)
    v1, v2 = rows_combine_plain(u, a_re, a_im, b2_re, b2_im, conj_spec,
                                dtype, mode)
    return cols_inv_plain(v1, v2, x0.shape[1], dtype, mode)


def _check_images(x0, x1, n):
    p_, h, w = x0.shape
    if h % PFFT_LANE or w % PFFT_LANE:
        raise ValueError(
            f"pfft images must be multiples of {PFFT_LANE}, got {(h, w)} "
            "(pad at the caller)"
        )
    if tuple(x1.shape) != (p_, h, w):
        raise ValueError(f"x1 has shape {tuple(x1.shape)}, expected "
                         f"{(p_, h, w)}")
    if int(n) % PFFT_LANE or int(n) < max(h, w):
        raise ValueError(f"pfft size {n} does not fit images of {(h, w)}")


# ----------------------------------------------------------------------
# CUDA kernels


def _library(name):
    """``csrc/<name>.cu`` (``pfft_conv_wg``) loaded, with its C functions'
    argument types: the three passes of the bf16 modes
    (``pfft_cols_fwd_wg``, ``pfft_rows_wg``, ``pfft_cols_inv_wg``: the
    tables of :func:`wg_stage_tables`, pass 1 also the twiddles, and the
    number of bf16 products a step) and in float32 (``pfft_cols_fwd_f32``,
    ``pfft_rows_f32``, ``pfft_cols_inv_f32``: the tables of
    :func:`wg_f32_tables`). Each function ends with the stream."""
    from ..utils.cuda_build import load_library

    lib = load_library(name)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # U, the four spectra, P, W, m, conj_spec, the tables, wf, wi, V1,
        # V2; the images, P, H, W, m, the tables, wf, U; V1, V2, P, H, W,
        # m, the tables, wi, y0, y1
        rows = [vp] * 5 + [ci] * 4 + [vp] * 5
        cols_fwd = [vp, vp, ci, ci, ci, ci, vp, vp, vp]
        cols_inv = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
        signatures = {
            # pass 1 of the bf16 modes also takes the twiddles (before U)
            "pfft_cols_fwd_wg": cols_fwd[:-1] + [vp, vp, ci, vp],
            "pfft_rows_wg": rows + [ci, vp],
            "pfft_cols_inv_wg": cols_inv + [ci, vp],
            "pfft_cols_fwd_f32": cols_fwd + [vp],
            "pfft_rows_f32": rows + [vp],
            "pfft_cols_inv_f32": cols_inv + [vp]}
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ci
        errors = getattr(lib, f"{name}_error_string")
        errors.argtypes = [ci]
        errors.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


WG_CHUNK = 32  # inputs k1 of a stage matrix a pipeline stage (wgmma)
WG_F32_CHUNK = 16  # the same, the float32 kernels


def _wg_tables(m, split, chunk):
    """``mf[k2]`` then ``mi[k2]`` (:func:`_stage_tables`, ``M[k1, b]``) as
    the ``wgmma`` kernels stream them, bfloat16 ``(2, m, 128 / chunk,
    -1)``: per ``k2`` and per chunk of ``chunk`` inputs ``k1`` one
    pipeline stage, the planes of ``split`` (the parts of the float32
    entries), each the real then the imaginary part of ``M^T`` (the
    products' A operand, ``[b][k1]``), in 8 x 8 core matrices of 16-byte
    rows, ``[row group][k8 block][row][k]`` (``2 chunk`` bytes between
    row groups, 128 between k8 blocks)."""
    t = _stage_tables(m)
    chunks = PFFT_LANE // chunk
    out = []
    for name in ("mf", "mi"):
        mat = np.swapaxes(t[name], -1, -2)  # [k2][b][k1]
        parts = torch.stack([torch.as_tensor(mat.real.astype(np.float32)),
                             torch.as_tensor(mat.imag.astype(np.float32))],
                            dim=1)  # [k2][part][b][k1]
        planes = torch.stack(split(parts), dim=1).to(torch.bfloat16)
        # [k2][s][part][8 rg + ri][chunk c + 8 kb + ki]
        # -> [k2][c][s][part][rg][kb][ri][ki]
        x = planes.reshape(m, -1, 2, 16, 8, chunks, chunk // 8, 8)
        out.append(x.permute(0, 5, 1, 2, 3, 6, 4, 7).reshape(m, chunks, -1))
    return torch.stack(out).contiguous()


def wg_stage_tables(m):
    """The ``"split"`` and ``"bf16"`` ``wgmma`` kernels' stage matrices
    (``csrc/pfft_conv_wg.cu``): :func:`_wg_tables`, bfloat16 ``(2, m, 4,
    16384)``, chunks of 32 inputs, the hi then the lo plane of
    :func:`bf16_split`, which the plain version takes from
    :func:`interleaved_stage_matrices`. Passes 2 and 3 stream each
    ``k2``'s table; pass 1 keeps ``mf[0]`` (``[0, 0]``, the 128-point
    DFT) in shared memory for every ``k2``."""
    return _wg_tables(m, bf16_split, WG_CHUNK)


def wg_f32_tables(m):
    """The float32 ``wgmma`` kernels' stage matrices
    (``csrc/pfft_conv_wg.cu``, passes 1 and 3 under ``"highest"``):
    :func:`_wg_tables`, bfloat16 ``(2, m, 8, 12288)``, chunks of 16
    inputs (24 KB stages), the hi, mid and lo planes of
    :func:`bf16_split3`."""
    return _wg_tables(m, bf16_split3, WG_F32_CHUNK)


class _DeviceTables(dict):
    """The stage tables of one size on one device, each built at its
    first use: ``wf``, ``wi`` and the twiddles ``tw[k2][n1] =
    mf[k2][n1, 0]`` (pass 1 of the bf16 modes) as interleaved complex
    float32, ``wg`` as :func:`wg_stage_tables` and ``wg3`` as
    :func:`wg_f32_tables`; a mode builds only those its kernels read."""

    _BUILDERS = {"wg": wg_stage_tables, "wg3": wg_f32_tables}

    def __init__(self, m, device):
        super().__init__()
        self.m, self.device = m, device

    def __missing__(self, name):
        if name in self._BUILDERS:
            table = self._BUILDERS[name](self.m).to(self.device)
        else:
            stage = _stage_tables(self.m)
            t = stage["mf"][:, :, 0] if name == "tw" else stage[name]
            table = torch.view_as_real(torch.as_tensor(
                t.astype(np.complex64), device=self.device)).contiguous()
        self[name] = table
        return table


_DEVICE_TABLES = {}


def _device_tables(m, device):
    """The :class:`_DeviceTables` of size ``m`` on ``device`` (one per
    size and device)."""
    key = (m, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = _DeviceTables(m, device)
    return _DEVICE_TABLES[key]


def _cuda_device(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {t.device}")
    return t.device


def _launch(library, fn, kernel, device, *args):
    lib = _library(library)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    _raise_on_error(getattr(lib, f"{library}_error_string"), code, kernel)


def _cols_fwd_args(x0, x1, n, name):
    device = _cuda_device(x0, name)
    _check_images(x0, x1, n)
    p_, h, w = x0.shape
    for label, t in (("x0", x0), ("x1", x1)):
        _check(t, label, torch.float32, (p_, h, w), device)
    m = int(n) // PFFT_LANE
    u = torch.empty((p_, int(n), w), dtype=torch.complex64, device=device)
    return device, p_, h, w, m, u


def pfft_cols_fwd_cuda(x0, x1, n):
    """Launch pass 1 in float32 (``"f32"``, ``csrc/pfft_conv_wg.cu``: six
    bf16 products of three-way splits a step) on ``x0``, ``x1`` ``(P, H,
    W)`` float32; returns ``U`` ``(P, n, W)`` complex64
    (:func:`cols_fwd_plain`)."""
    device, p_, h, w, m, u = _cols_fwd_args(x0, x1, n, "pfft_cols_fwd_cuda")
    tab = _device_tables(m, device)
    _launch("pfft_conv_wg", "pfft_cols_fwd_f32", "pfft_cols_fwd_f32_kernel",
            device, x0.data_ptr(), x1.data_ptr(), p_, h, w, m,
            tab["wg3"].data_ptr(), tab["wf"].data_ptr(), u.data_ptr())
    pfft_cols_fwd_cuda.launches += 1
    return u


def pfft_cols_fwd_tc_cuda(x0, x1, n):
    """Launch pass 1 on the tensor cores (``"split"``,
    ``csrc/pfft_conv_wg.cu``): same arguments and results as
    :func:`pfft_cols_fwd_cuda`, computed as :func:`cols_fwd_plain` with
    ``mode="split"``."""
    u = _cols_fwd_tc(x0, x1, n, "split", "pfft_cols_fwd_tc_cuda")
    pfft_cols_fwd_tc_cuda.launches += 1
    return u


def pfft_cols_fwd_bf16_cuda(x0, x1, n):
    """Launch pass 1 on the tensor cores in ``"bf16"`` mode (one product
    a step): computed as :func:`cols_fwd_plain` with ``mode="bf16"``."""
    u = _cols_fwd_tc(x0, x1, n, "bf16", "pfft_cols_fwd_bf16_cuda")
    pfft_cols_fwd_bf16_cuda.launches += 1
    return u


def _cols_fwd_tc(x0, x1, n, mode, name):
    device, p_, h, w, m, u = _cols_fwd_args(x0, x1, n, name)
    tab = _device_tables(m, device)
    _launch("pfft_conv_wg", "pfft_cols_fwd_wg", "pfft_cols_fwd_wg_kernel",
            device, x0.data_ptr(), x1.data_ptr(), p_, h, w, m,
            tab["wg"].data_ptr(), tab["wf"].data_ptr(),
            tab["tw"].data_ptr(), u.data_ptr(), TC_PRODUCTS[mode])
    return u


def _rows_args(u, planes, name):
    device = _cuda_device(u, name)
    p_, n, w = u.shape
    if n % PFFT_LANE or w % PFFT_LANE or w > n:
        raise ValueError(f"pfft rows pass: bad U shape {tuple(u.shape)}")
    _check(u, "U", torch.complex64, (p_, n, w), device)
    for label, t in zip(("a_re", "a_im", "b2_re", "b2_im"), planes):
        _check(t, label, torch.float32, (p_, n, n), device)
    return device, p_, n, w, n // PFFT_LANE


def _cols_inv_args(v1, v2, h, name):
    device = _cuda_device(v1, name)
    p_, n, w = v1.shape
    if h % PFFT_LANE or w % PFFT_LANE or max(h, w) > n or n % PFFT_LANE:
        raise ValueError(f"pfft inverse pass: bad shapes {tuple(v1.shape)}, "
                         f"h={h}")
    for label, t in (("V1", v1), ("V2", v2)):
        _check(t, label, torch.complex64, (p_, n, w), device)
    return device, p_, n, w, n // PFFT_LANE


def pfft_rows_combine_cuda(u, a_re, a_im, b2_re, b2_im, conj_spec=False):
    """Launch pass 2 in float32 (``"f32"``, ``csrc/pfft_conv_wg.cu``, as
    :func:`pfft_cols_fwd_cuda`) on ``U`` ``(P, n, W)`` complex64 and the
    spectra ``(P, n, n)`` float32; returns ``(V1, V2)``
    (:func:`rows_combine_plain`)."""
    planes = (a_re, a_im, b2_re, b2_im)
    device, p_, n, w, m = _rows_args(u, planes, "pfft_rows_combine_cuda")
    tab = _device_tables(m, device)
    v1 = torch.empty_like(u)
    v2 = torch.empty_like(u)
    _launch("pfft_conv_wg", "pfft_rows_f32", "pfft_rows_f32_kernel", device,
            u.data_ptr(), *(t.data_ptr() for t in planes), p_, w, m,
            int(bool(conj_spec)), tab["wg3"].data_ptr(),
            tab["wf"].data_ptr(), tab["wi"].data_ptr(), v1.data_ptr(),
            v2.data_ptr())
    pfft_rows_combine_cuda.launches += 1
    return v1, v2


def pfft_cols_inv_cuda(v1, v2, h):
    """Launch pass 3 in float32 (``"f32"``, ``csrc/pfft_conv_wg.cu``, as
    :func:`pfft_cols_fwd_cuda`) on ``V1``, ``V2`` ``(P, n, W)``
    complex64; returns ``(y0, y1)`` ``(P, h, W)`` float32
    (:func:`cols_inv_plain`)."""
    device, p_, n, w, m = _cols_inv_args(v1, v2, h, "pfft_cols_inv_cuda")
    tab = _device_tables(m, device)
    y0 = torch.empty((p_, h, w), dtype=torch.float32, device=device)
    y1 = torch.empty_like(y0)
    _launch("pfft_conv_wg", "pfft_cols_inv_f32", "pfft_cols_inv_f32_kernel",
            device, v1.data_ptr(), v2.data_ptr(), p_, h, w, m,
            tab["wg3"].data_ptr(), tab["wi"].data_ptr(), y0.data_ptr(),
            y1.data_ptr())
    pfft_cols_inv_cuda.launches += 1
    return y0, y1


def pfft_rows_combine_tc_cuda(u, a_re, a_im, b2_re, b2_im, conj_spec=False):
    """Launch pass 2 on the tensor cores (``"split"``,
    ``csrc/pfft_conv_wg.cu``): same arguments and results as
    :func:`pfft_rows_combine_cuda`, computed as
    :func:`rows_combine_plain` with ``mode="split"``."""
    out = _rows_tc(u, (a_re, a_im, b2_re, b2_im), conj_spec, "split",
                   "pfft_rows_combine_tc_cuda")
    pfft_rows_combine_tc_cuda.launches += 1
    return out


def pfft_rows_combine_bf16_cuda(u, a_re, a_im, b2_re, b2_im,
                                conj_spec=False):
    """Launch pass 2 on the tensor cores in ``"bf16"`` mode: computed as
    :func:`rows_combine_plain` with ``mode="bf16"``."""
    out = _rows_tc(u, (a_re, a_im, b2_re, b2_im), conj_spec, "bf16",
                   "pfft_rows_combine_bf16_cuda")
    pfft_rows_combine_bf16_cuda.launches += 1
    return out


def _rows_tc(u, planes, conj_spec, mode, name):
    device, p_, n, w, m = _rows_args(u, planes, name)
    tab = _device_tables(m, device)
    v1 = torch.empty_like(u)
    v2 = torch.empty_like(u)
    _launch("pfft_conv_wg", "pfft_rows_wg", "pfft_rows_wg_kernel", device,
            u.data_ptr(), *(t.data_ptr() for t in planes), p_, w, m,
            int(bool(conj_spec)), tab["wg"].data_ptr(), tab["wf"].data_ptr(),
            tab["wi"].data_ptr(), v1.data_ptr(), v2.data_ptr(),
            TC_PRODUCTS[mode])
    return v1, v2


def pfft_cols_inv_tc_cuda(v1, v2, h):
    """Launch pass 3 on the tensor cores (``"split"``,
    ``csrc/pfft_conv_wg.cu``): same arguments and results as
    :func:`pfft_cols_inv_cuda`, computed as :func:`cols_inv_plain`
    with ``mode="split"``."""
    out = _cols_inv_tc(v1, v2, h, "split", "pfft_cols_inv_tc_cuda")
    pfft_cols_inv_tc_cuda.launches += 1
    return out


def pfft_cols_inv_bf16_cuda(v1, v2, h):
    """Launch pass 3 on the tensor cores in ``"bf16"`` mode: computed as
    :func:`cols_inv_plain` with ``mode="bf16"``."""
    out = _cols_inv_tc(v1, v2, h, "bf16", "pfft_cols_inv_bf16_cuda")
    pfft_cols_inv_bf16_cuda.launches += 1
    return out


def _cols_inv_tc(v1, v2, h, mode, name):
    device, p_, n, w, m = _cols_inv_args(v1, v2, h, name)
    tab = _device_tables(m, device)
    y0 = torch.empty((p_, h, w), dtype=torch.float32, device=device)
    y1 = torch.empty_like(y0)
    _launch("pfft_conv_wg", "pfft_cols_inv_wg", "pfft_cols_inv_wg_kernel",
            device, v1.data_ptr(), v2.data_ptr(), p_, h, w, m,
            tab["wg"].data_ptr(), tab["wi"].data_ptr(), y0.data_ptr(),
            y1.data_ptr(), TC_PRODUCTS[mode])
    return y0, y1


# the three passes' kernels by mode
PASSES = {
    "f32": (pfft_cols_fwd_cuda, pfft_rows_combine_cuda, pfft_cols_inv_cuda),
    "split": (pfft_cols_fwd_tc_cuda, pfft_rows_combine_tc_cuda,
              pfft_cols_inv_tc_cuda),
    "bf16": (pfft_cols_fwd_bf16_cuda, pfft_rows_combine_bf16_cuda,
             pfft_cols_inv_bf16_cuda),
}


def pfft_conv_cuda(x0, x1, a_re, a_im, b2_re, b2_im, n, conj_spec=False,
                   mode="f32"):
    """The kernels of ``mode`` in turn; same contract as
    :func:`conv_packed_pfft_plain` in float32 and ``mode``: the three
    passes on the tensor cores, three bf16 products a step under
    ``"split"``, one under ``"bf16"``, six of three-way splits under
    ``"f32"``."""
    cols_fwd, rows, cols_inv = PASSES[_tc_mode(mode, torch.float32) or "f32"]
    u = cols_fwd(x0, x1, n)
    v1, v2 = rows(u, a_re, a_im, b2_re, b2_im, conj_spec)
    return cols_inv(v1, v2, x0.shape[1])


def reset_counters():
    """Set every launch and call count of this module to zero."""
    for fn in (pfft_cols_fwd_cuda, pfft_rows_combine_cuda,
               pfft_cols_inv_cuda, pfft_cols_fwd_tc_cuda,
               pfft_rows_combine_tc_cuda, pfft_cols_inv_tc_cuda,
               pfft_cols_fwd_bf16_cuda, pfft_rows_combine_bf16_cuda,
               pfft_cols_inv_bf16_cuda):
        fn.launches = 0
    conv_packed_pfft_plain.calls = 0


reset_counters()


# ----------------------------------------------------------------------
# dispatch and autograd


def _apply(x0, x1, planes, n, mode, conj_spec):
    if dispatch(x0) == "kernel":
        return pfft_conv_cuda(x0, x1, *planes, n, conj_spec, mode)
    return conv_packed_pfft_plain(x0, x1, *planes, n, conj_spec, x0.dtype,
                                  mode)


class _PfftConv(torch.autograd.Function):
    """The pipeline with frozen spectra. Its adjoint is the pipeline with
    ``conj_spec`` flipped, applied through this Function again, so that
    the gradient is itself differentiable."""

    @staticmethod
    def forward(ctx, x0, x1, a_re, a_im, b2_re, b2_im, n, mode, conj_spec):
        ctx.save_for_backward(a_re, a_im, b2_re, b2_im)
        ctx.n, ctx.mode, ctx.conj_spec = n, mode, conj_spec
        return _apply(x0.contiguous(), x1.contiguous(),
                      (a_re, a_im, b2_re, b2_im), n, mode, conj_spec)

    @staticmethod
    def backward(ctx, g0, g1):
        d0, d1 = _PfftConv.apply(g0, g1, *ctx.saved_tensors, ctx.n,
                                 ctx.mode, not ctx.conj_spec)
        return d0, d1, None, None, None, None, None, None, None


def conv_packed_pfft(x0, x1, a_re, a_im, b2_re, b2_im, n, mode="f32"):
    """Pair-packed linear convolution through the matrix DFT.

    Parameters
    ----------
    x0, x1 : float32 tensors ``(P, H, W)``
        The two real image batches of each pair; ``H`` and ``W``
        multiples of 128 (pad at the caller). On the CPU float64 works
        too (the plain version computes in the images' type).
    a_re, a_im, b2_re, b2_im : float32 tensors ``(P, n, n)``
        Permuted packed spectra (:func:`pfft_pair_spectra_device`).
    n : int
        Transform size, a multiple of 128, at least the linear
        convolution's.
    mode : {"f32", "split", "bf16"}
        The precision dial's mode (:func:`default_pfft_mode`).
        ``"split"`` runs the stage-B products as three bf16 products
        with float32 sums, ``"bf16"`` as one (the tensor-core kernels on
        a card); ``"f32"`` computes in full float32.

    Returns
    -------
    y0, y1 : float32 tensors ``(P, H, W)``
        ``x0 * k0`` and ``x1 * k1`` cropped to the input shape.
    """
    if mode not in MODES:
        raise ValueError(f"invalid pfft mode {mode!r}, expected one of "
                         f"{MODES}")
    return _PfftConv.apply(x0, x1, a_re, a_im, b2_re, b2_im, int(n), mode,
                           False)
