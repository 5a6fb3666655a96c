"""Patch-level GMM scoring: the scorer, its MAP gradient and Hessian action.

Counterpart of the JAX package's ``ops/gmm_pallas.py``. Rows are
normalised patches ``x (N, d)`` (already masked and mean-subtracted);
per row, over the K components,

    logit_k = -1/2 x^T A_k x + b_k . x + c_k
    values  = max_k logit_k (MAP) or logsumexp_k logit_k (marginalise)
    argmax  = the lowest index among equal maxima

and, for the MAP reduction with the argmax held piecewise constant,

    d values / d x = b_{k*} - A_{k*} x        (the unit gradient)
    its derivative along t = -A_{k*} t        (the Hessian action)

Each of the three has two implementations with one contract:

- a CUDA kernel written by hand for Hopper (``csrc/gmm_patch.cu``,
  whose header says what bounds each kernel and how it is built), run
  for a tensor on a CUDA card, for d = 64 (8x8 patches, both shipped
  GMMs; the JAX package's ``pallas_supported`` rule);
- a plain PyTorch version (``*_plain``), run for a tensor on the CPU
  for any d, and the reference the kernel is checked against on the
  card.

Nothing falls back from a kernel to its plain version
(``config.dispatch``). Each wrapper counts its launches
(``gmm_score_rows_cuda.launches``, ...), each plain version its calls.

Derivatives: :func:`gmm_score_patches` is a ``torch.autograd.Function``
whose backward is ``dvalues * unit`` with the unit gradient another
``autograd.Function``, and the unit gradient's backward is the Hessian
action. ``A_k`` is symmetric, so the Hessian action is both the JVP and
the VJP of the unit gradient, and a reverse-over-reverse probe (the flux
errors of ``TotalLoss.hessian_diagonals``) runs on the three kernels.
The Hessian action is linear and symmetric, so it is its own backward
and the MAP scorer is differentiable to any order. The marginalise
gradient (the JAX package's ``_unit_marg_kernel``) is not ported yet:
its backward raises.
"""

import ctypes

import torch

from ..config import dispatch
from .gmm_fused import (
    D,
    PLAIN_CHUNK,
    REC,
    _check,
    _raise_on_error,
    logit_chunks,
)

__all__ = [
    "gmm_hvp_map_cuda",
    "gmm_score_patches",
    "gmm_score_rows_cuda",
    "gmm_unit_map_cuda",
    "hvp_map_plain",
    "reset_counters",
    "score_rows_plain",
    "unit_map_plain",
]


# ----------------------------------------------------------------------
# plain PyTorch versions


def score_rows_plain(x, bufs, marginalize=False):
    """Plain version of the scorer: ``(values (N,), argmax (N,) int32)``."""
    score_rows_plain.calls += 1
    values, argmax = [x.new_empty(0)], [x.new_empty(0, dtype=torch.int32)]
    for logits in logit_chunks(x, bufs["aq"], bufs["bq"], bufs["const2"]):
        v, k = torch.max(logits, dim=1)
        if marginalize:
            v = torch.logsumexp(logits, dim=1)
        values.append(v)
        argmax.append(k.to(torch.int32))
    return torch.cat(values), torch.cat(argmax)


def _select_rows(x, argmax, bufs, with_b):
    """``b_{k*} - A_{k*} x`` (``with_b``) or ``-A_{k*} x``, in chunks."""
    a_full, b_rows = bufs["a_full"], bufs["b_rows"]
    out = [x.new_empty((0, x.shape[1]))]
    for start in range(0, x.shape[0], PLAIN_CHUNK):
        sl = slice(start, start + PLAIN_CHUNK)
        k = argmax[sl].long()
        ax = torch.einsum("nrc,nc->nr", a_full[k], x[sl])
        out.append(b_rows[k] - ax if with_b else -ax)
    return torch.cat(out)


def unit_map_plain(x, argmax, bufs):
    """Plain version of the MAP unit gradient ``b_{k*} - A_{k*} x``."""
    unit_map_plain.calls += 1
    return _select_rows(x, argmax, bufs, with_b=True)


def hvp_map_plain(t, argmax, bufs):
    """Plain version of the MAP Hessian action ``-A_{k*} t``."""
    hvp_map_plain.calls += 1
    return _select_rows(t, argmax, bufs, with_b=False)


# ----------------------------------------------------------------------
# CUDA kernels


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library("gmm_patch")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gmm_score_rows.argtypes = [vp, ci, vp, ci, ci, vp, vp, vp]
        lib.gmm_score_rows.restype = ci
        lib.gmm_unit_map.argtypes = [vp, vp, vp, vp, ci, vp, vp]
        lib.gmm_unit_map.restype = ci
        lib.gmm_hvp_map.argtypes = [vp, vp, vp, ci, vp, vp]
        lib.gmm_hvp_map.restype = ci
        lib.gmm_patch_error_string.argtypes = [ci]
        lib.gmm_patch_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_rows(x, name, argmax=None):
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {device}")
    n = x.shape[0]
    _check(x, "rows", torch.float32, (n, D), device)
    if argmax is not None:
        _check(argmax, "argmax", torch.int32, (n,), device)
    return device, n


def _launch(kernel, *args):
    lib = _library()
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, kernel)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args],
            stream,
        )
    _raise_on_error(lib.gmm_patch_error_string, code, kernel)


def gmm_score_rows_cuda(x, bufs, marginalize=False):
    """Launch the scorer on rows ``x (N, 64)`` float32 on a card.

    Same outputs as :func:`score_rows_plain`.
    """
    device, n = _check_rows(x, "gmm_score_rows_cuda")
    rec = bufs["rec"]
    k = rec.shape[0]
    _check(rec, "rec", torch.float32, (k, REC), device)
    values = torch.empty(n, dtype=torch.float32, device=device)
    argmax = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        _launch("gmm_score_rows", x, n, rec, k, int(bool(marginalize)),
                values, argmax)
        gmm_score_rows_cuda.launches += 1
    return values, argmax


def gmm_unit_map_cuda(x, argmax, bufs):
    """Launch the MAP unit gradient ``b_{k*} - A_{k*} x``; ``(N, 64)``."""
    device, n = _check_rows(x, "gmm_unit_map_cuda", argmax)
    a_full, b_rows = bufs["a_full"], bufs["b_rows"]
    k = a_full.shape[0]
    _check(a_full, "a_full", torch.float32, (k, D, D), device)
    _check(b_rows, "b_rows", torch.float32, (k, D), device)
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    if n:
        _launch("gmm_unit_map", x, argmax, a_full, b_rows, n, out)
        gmm_unit_map_cuda.launches += 1
    return out


def gmm_hvp_map_cuda(t, argmax, bufs):
    """Launch the MAP Hessian action ``-A_{k*} t``; ``(N, 64)``."""
    device, n = _check_rows(t, "gmm_hvp_map_cuda", argmax)
    a_full = bufs["a_full"]
    k = a_full.shape[0]
    _check(a_full, "a_full", torch.float32, (k, D, D), device)
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    if n:
        _launch("gmm_hvp_map", t, argmax, a_full, n, out)
        gmm_hvp_map_cuda.launches += 1
    return out


def reset_counters():
    """Set every launch and call count of this module to zero."""
    for fn in (gmm_score_rows_cuda, gmm_unit_map_cuda, gmm_hvp_map_cuda):
        fn.launches = 0
    for fn in (score_rows_plain, unit_map_plain, hvp_map_plain):
        fn.calls = 0


reset_counters()


# ----------------------------------------------------------------------
# dispatch and autograd


def _score(x, bufs, marginalize):
    if dispatch(x) == "kernel":
        return gmm_score_rows_cuda(x, bufs, marginalize)
    return score_rows_plain(x, bufs, marginalize)


def _unit(x, argmax, bufs):
    if dispatch(x) == "kernel":
        return gmm_unit_map_cuda(x, argmax, bufs)
    return unit_map_plain(x, argmax, bufs)


def _hvp(t, argmax, bufs):
    if dispatch(t) == "kernel":
        return gmm_hvp_map_cuda(t, argmax, bufs)
    return hvp_map_plain(t, argmax, bufs)


class _HvpMap(torch.autograd.Function):
    """MAP Hessian action ``-A_{k*} t``: linear in ``t`` and symmetric,
    so its backward is itself."""

    @staticmethod
    def forward(ctx, t, argmax, bufs):
        ctx.save_for_backward(argmax)
        ctx.bufs = bufs
        return _hvp(t, argmax, bufs)

    @staticmethod
    def backward(ctx, grad):
        (argmax,) = ctx.saved_tensors
        return _HvpMap.apply(grad.contiguous(), argmax, ctx.bufs), None, None


class _UnitMap(torch.autograd.Function):
    """MAP unit gradient; its backward is the Hessian action (A symmetric)."""

    @staticmethod
    def forward(ctx, x, argmax, bufs):
        ctx.save_for_backward(argmax)
        ctx.bufs = bufs
        return _unit(x, argmax, bufs)

    @staticmethod
    def backward(ctx, t):
        (argmax,) = ctx.saved_tensors
        return _HvpMap.apply(t.contiguous(), argmax, ctx.bufs), None, None


class _PatchScore(torch.autograd.Function):
    """Scorer; its backward is ``dvalues * unit``, itself differentiable."""

    @staticmethod
    def forward(ctx, x, bufs, marginalize):
        values, argmax = _score(x, bufs, marginalize)
        ctx.save_for_backward(x, argmax)
        ctx.bufs = bufs
        ctx.marginalize = marginalize
        ctx.mark_non_differentiable(argmax)
        return values, argmax

    @staticmethod
    def backward(ctx, dvalues, _dargmax):
        if ctx.marginalize:
            raise NotImplementedError(
                "the marginalise gradient of the patch scorer is not "
                "ported yet"
            )
        x, argmax = ctx.saved_tensors
        unit = _UnitMap.apply(x, argmax, ctx.bufs)
        return dvalues[:, None] * unit, None, None


def gmm_score_patches(x, bufs, marginalize=False):
    """GMM scores of normalised patch rows.

    Parameters
    ----------
    x : tensor ``(N, d)`` float32
        Masked, mean-subtracted patches.
    bufs : dict
        From ``ops.gmm_fused.kernel_buffers`` on ``x``'s device.
    marginalize : bool
        Logsumexp instead of max over the components (forward only: its
        gradient is not ported yet).

    Returns
    -------
    values : ``(N,)`` float32, differentiable twice with respect to ``x``
        (MAP)
    argmax : ``(N,)`` int32
    """
    if dispatch(x) == "kernel" and x.shape[1] != D:
        raise NotImplementedError(
            f"the patch scoring kernels take 8x8 patches (d = {D}), "
            f"got d = {x.shape[1]}"
        )
    return _PatchScore.apply(x.contiguous(), bufs, bool(marginalize))
