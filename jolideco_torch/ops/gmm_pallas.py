"""Patch-level GMM scoring: the scorer, its gradient and Hessian action.

Counterpart of the JAX package's ``ops/gmm_pallas.py``. Rows are
normalised patches ``x (N, d)`` (already masked and mean-subtracted);
per row, over the K components,

    logit_k = -1/2 x^T A_k x + b_k . x + c_k
    values  = max_k logit_k (MAP) or logsumexp_k logit_k (marginalise)
    argmax  = the lowest index among equal maxima

For the MAP reduction, with the argmax held piecewise constant,

    d values / d x = b_{k*} - A_{k*} x        (the unit gradient)
    its derivative along t = -A_{k*} t        (the Hessian action)

and for the marginalise reduction, with ``p = softmax(logits)`` (taken
against the forward's logsumexp and renormalised), ``r_k = b_k - A_k x``
and ``g_k = r_k . t``,

    d values / d x = sum_k p_k r_k
    its derivative along t = sum_k [dp_k b_k - A_k (p_k t + dp_k x)],
        dp_k = p_k (g_k - sum_j p_j g_j)

in two stages, ``(p, dp)`` and then the mixture, as in the JAX package.

The logits have the three modes of the fused scorer
(``ops.gmm_fused``), which the precision dial names (``config.gmm_mode``)
and the caller passes down: ``"f32"``, full float32; ``"split"``, the
JAX package's logits at precision HIGH (bf16 hi/lo pair products, three
products summed in float32); ``"bf16"``, its logits at precision DEFAULT
(the pair products and ``A`` rounded to bf16, one product summed in
float32). The mode reaches the scorer (MAP and logsumexp) and
the marginalise gradient and Hessian action, which recompute the logits
in the scorer's mode: they take its logsumexp as the stabiliser of
``exp(logit_k - lse)``, over logits of 1e5 to 1e8, so the lse must come
from logits of the same arithmetic. The mixtures, ``g_k`` and the
second stage of the Hessian action are float32 in either mode (the JAX
package splits ``p`` and ``A`` into bf16 hi and lo there, and computes
``g_k`` by a split cross form). The MAP derivatives read only the
argmax.

Each has two implementations with one contract:

- a CUDA kernel written by hand for Hopper, run for a tensor on a CUDA
  card, for d = 64 (8x8 patches, both shipped GMMs; the JAX package's
  ``pallas_supported`` rule): ``csrc/gmm_score_wg.cu``'s warpgroup core
  (``wgmma``) for the MAP scorer of the ``"split"`` and ``"bf16"``
  modes and, in every mode, the logsumexp scorer, the marginalise unit
  gradient and the first stage of its Hessian action, which recompute
  the scorer's logits by the same instance of the core;
  ``csrc/gmm_patch.cu`` for the float32 MAP scorer, the MAP unit
  gradient and Hessian action and the second stage of the marginalise
  Hessian action (the headers say what bounds each kernel and how it
  is built);
- a plain PyTorch version (``*_plain``), run for a tensor on the CPU
  for any d and in float32 or float64, and the reference the kernel is
  checked against on the card.

Nothing falls back from a kernel to its plain version
(``config.dispatch``). Each wrapper counts its launches
(``gmm_score_rows_cuda.launches``, ...), each plain version its calls.

Derivatives: :func:`gmm_score_patches` is a ``torch.autograd.Function``
whose backward is ``dvalues * unit`` with the unit gradient another
``autograd.Function``, and the unit gradient's backward is the Hessian
action. ``A_k`` is symmetric and so is the Hessian of a scalar, so the
Hessian action is both the JVP and the VJP of the unit gradient, and a
reverse-over-reverse probe (the flux errors of
``TotalLoss.hessian_diagonals``) runs on the kernels. The MAP Hessian
action is linear and symmetric, so it is its own backward and the MAP
scorer is differentiable to any order. The marginalise Hessian action
has no derivative in either package: its backward raises. The
marginalise unit gradient does not depend on the logsumexp it is given
(the weights are renormalised), so it passes no gradient to it, the JAX
package's rule.
"""

import ctypes

import torch

from ..config import dispatch
from .gmm_fused import (
    D,
    KP_WG,
    PLAIN_CHUNK,
    REC,
    _check,
    _check_mode,
    _raise_on_error,
    _scores,
    _wg_library,
    _wg_pairs,
    PLAIN_SCORES,
    PLAIN_UNITS,
    WG_PRODUCTS,
    WG_ROWS,
    logit_chunks,
    marg_unit_rows,
    mix_rows,
    softmax_chunks,
)

__all__ = [
    "gmm_hvp_map_cuda",
    "gmm_hvp_marg_mix_cuda",
    "gmm_hvp_marg_weights_bf16_cuda",
    "gmm_hvp_marg_weights_cuda",
    "gmm_hvp_marg_weights_tc_cuda",
    "gmm_score_patches",
    "gmm_score_rows_bf16_cuda",
    "gmm_score_rows_cuda",
    "gmm_score_rows_marg_bf16_cuda",
    "gmm_score_rows_marg_cuda",
    "gmm_score_rows_marg_tc_cuda",
    "gmm_score_rows_tc_cuda",
    "gmm_unit_map_cuda",
    "gmm_unit_marg_bf16_cuda",
    "gmm_unit_marg_cuda",
    "gmm_unit_marg_tc_cuda",
    "hvp_map_plain",
    "hvp_marg_mix_plain",
    "hvp_marg_plain",
    "hvp_marg_weights_bf16_plain",
    "hvp_marg_weights_plain",
    "hvp_marg_weights_split_plain",
    "reset_counters",
    "score_rows_plain",
    "unit_map_plain",
    "unit_marg_plain",
]


# ----------------------------------------------------------------------
# plain PyTorch versions


def score_rows_plain(x, bufs, marginalize=False):
    """Plain version of the scorer: ``(values (N,), argmax (N,) int32)``."""
    score_rows_plain.calls += 1
    chunks = logit_chunks(x, bufs["aq"], bufs["bq"], bufs["const2"])
    return _scores(x, chunks, marginalize)


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


def unit_marg_plain(x, lse, bufs):
    """Plain version of the marginalise unit gradient ``sum_k p_k r_k``."""
    unit_marg_plain.calls += 1
    return marg_unit_rows(x, lse, bufs)


def _marg_weights(x, t, lse, bufs, mode):
    """``(p, dp)``, each ``(K, N)``, the softmax over the logits of
    ``mode``, ``g`` in the rows' type."""
    aq, bq = bufs["aq"], bufs["bq"]
    n, d = x.shape
    ps, dps = [x.new_empty((0, aq.shape[1]))], [x.new_empty((0, aq.shape[1]))]
    for sl, p in softmax_chunks(x, lse, bufs, mode):
        xs, ts = x[sl], t[sl]
        # g_k = t . b_k - t^T A_k x, taken against g of the heaviest
        # component, so that a row whose weight sits on one component
        # gets dp = 0 exactly (the kernel's rule)
        cross = (ts[:, :, None] * xs[:, None, :]).reshape(len(xs), d * d)
        g = ts @ bq - cross @ aq
        g = g - g.gather(1, p.argmax(dim=1, keepdim=True))
        gbar = (p * g).sum(dim=1, keepdim=True)
        ps.append(p)
        dps.append(p * (g - gbar))
    return torch.cat(ps).T.contiguous(), torch.cat(dps).T.contiguous()


def hvp_marg_weights_plain(x, t, lse, bufs):
    """Plain version of the marginalise Hessian action's first stage:
    ``(p, dp)``, each ``(K, N)`` (component-major, the kernel's layout)."""
    hvp_marg_weights_plain.calls += 1
    return _marg_weights(x, t, lse, bufs, "f32")


def hvp_marg_weights_split_plain(x, t, lse, bufs):
    """:func:`hvp_marg_weights_plain` in the ``"split"`` mode: the softmax
    over the split logits against ``lse``, a logsumexp of the same logits
    (``score_split_marg_plain``), ``g`` as in the float32 version."""
    hvp_marg_weights_split_plain.calls += 1
    return _marg_weights(x, t, lse, bufs, "split")


def hvp_marg_weights_bf16_plain(x, t, lse, bufs):
    """:func:`hvp_marg_weights_plain` in the ``"bf16"`` mode: the softmax
    over the single-bf16 logits against ``lse``, a logsumexp of the same
    logits (``score_bf16_marg_plain``), ``g`` as in the float32 version
    (the JAX package computes ``g`` through the cross form at DEFAULT;
    the port keeps it in float32, as under ``"split"``)."""
    hvp_marg_weights_bf16_plain.calls += 1
    return _marg_weights(x, t, lse, bufs, "bf16")


# the first stage's plain versions by mode
PLAIN_WEIGHTS = {"f32": hvp_marg_weights_plain,
                 "split": hvp_marg_weights_split_plain,
                 "bf16": hvp_marg_weights_bf16_plain}


def hvp_marg_mix_plain(x, t, p, dp, bufs):
    """Plain version of the second stage:
    ``sum_k [dp_k b_k - A_k (p_k t + dp_k x)]`` per row, ``(N, d)``."""
    hvp_marg_mix_plain.calls += 1
    out = [x.new_empty((0, x.shape[1]))]
    for start in range(0, x.shape[0], PLAIN_CHUNK):
        sl = slice(start, start + PLAIN_CHUNK)
        ps, dps = p[:, sl].T, dp[:, sl].T
        out.append(dps @ bufs["b_rows"] - mix_rows(ps, t[sl], bufs)
                   - mix_rows(dps, x[sl], bufs))
    return torch.cat(out)


def hvp_marg_plain(t, x, lse, bufs, mode="f32"):
    """The marginalise Hessian action along ``t``: both plain stages, the
    first of ``mode``."""
    p, dp = PLAIN_WEIGHTS[mode](x, t, lse, bufs)
    return hvp_marg_mix_plain(x, t, p, dp, bufs)


# ----------------------------------------------------------------------
# CUDA kernels


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library("gmm_patch")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gmm_score_rows.argtypes = [vp, ci, vp, ci, vp, vp, vp]
        lib.gmm_score_rows.restype = ci
        lib.gmm_unit_map.argtypes = [vp, vp, vp, vp, ci, vp, vp]
        lib.gmm_unit_map.restype = ci
        lib.gmm_hvp_map.argtypes = [vp, vp, vp, ci, vp, vp]
        lib.gmm_hvp_map.restype = ci
        lib.gmm_hvp_marg_mix.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, vp,
                                         vp]
        lib.gmm_hvp_marg_mix.restype = ci
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


def _launch(kernel, *args, wg=False):
    """The C entry ``kernel`` of ``csrc/gmm_patch.cu`` (of
    ``csrc/gmm_score_wg.cu`` with ``wg``) on tensors' pointers and ints,
    on the current stream of the first argument's card."""
    lib = _wg_library() if wg else _library()
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, kernel)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args],
            stream,
        )
    _raise_on_error(lib.gmm_score_wg_error_string if wg
                    else lib.gmm_patch_error_string, code, kernel)


def _score_rows_wg(x, bufs, mode, name, marginalize=False):
    """The launch of K5 of ``mode`` on the warpgroup core
    (``csrc/gmm_score_wg.cu``, when there are rows): its MAP instance, or
    with ``marginalize`` its logsumexp one; values, argmax and whether it
    launched."""
    device, n = _check_rows(x, name)
    pairs, k = _wg_pairs(bufs, mode, device)
    values = torch.empty(n, dtype=torch.float32, device=device)
    argmax = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        _launch("gmm_score_wg_rows", x, n, pairs, bufs["lin_wg"], k,
                WG_PRODUCTS[mode], int(marginalize), values, argmax, wg=True)
    return values, argmax, bool(n)


def gmm_score_rows_cuda(x, bufs, marginalize=False):
    """Launch the ``"f32"`` scorer on rows ``x (N, 64)`` float32 on a
    card: the MAP scorer of ``csrc/gmm_patch.cu`` (counted here) or, with
    ``marginalize``, :func:`gmm_score_rows_marg_cuda`.

    Same outputs as :func:`score_rows_plain`.
    """
    if marginalize:
        return gmm_score_rows_marg_cuda(x, bufs)
    device, n = _check_rows(x, "gmm_score_rows_cuda")
    rec = bufs["rec"]
    k = rec.shape[0]
    _check(rec, "rec", torch.float32, (k, REC), device)
    values = torch.empty(n, dtype=torch.float32, device=device)
    argmax = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        _launch("gmm_score_rows", x, n, rec, k, values, argmax)
        gmm_score_rows_cuda.launches += 1
    return values, argmax


def gmm_score_rows_marg_cuda(x, bufs):
    """Launch the logsumexp instance of the ``"f32"`` scorer (K5 lse, the
    warpgroup core's six products of ``csrc/gmm_score_wg.cu``: K1 lse's
    logits under ``"highest"``) on rows ``x (N, 64)`` float32 on a card;
    same outputs as ``score_rows_plain(x, bufs, True)``. Its logsumexp is
    what :func:`gmm_unit_marg_cuda` and :func:`gmm_hvp_marg_weights_cuda`
    take: they recompute its logits bit for bit."""
    values, argmax, launched = _score_rows_wg(
        x, bufs, "f32", "gmm_score_rows_marg_cuda", True)
    gmm_score_rows_marg_cuda.launches += launched
    return values, argmax


def gmm_score_rows_tc_cuda(x, bufs):
    """Launch the MAP scorer of the ``"split"`` mode on the tensor cores
    (``csrc/gmm_score_wg.cu``, K1 split's logits) on rows ``x (N, 64)``
    float32 on a card; any number of components, in tiles of
    ``KP_WG``. Same outputs as ``score_split_plain``; the buffers are
    ``kernel_buffers``' ``pair_wg`` and ``lin_wg``."""
    values, argmax, launched = _score_rows_wg(x, bufs, "split",
                                              "gmm_score_rows_tc_cuda")
    gmm_score_rows_tc_cuda.launches += launched
    return values, argmax


def gmm_score_rows_marg_tc_cuda(x, bufs):
    """Launch the logsumexp instance of the ``"split"`` scorer (K5 lse
    split, ``csrc/gmm_score_wg.cu``); same outputs as
    ``score_split_marg_plain``. Its logsumexp is what
    :func:`gmm_unit_marg_tc_cuda` and
    :func:`gmm_hvp_marg_weights_tc_cuda` take: they recompute the same
    logits bit for bit, by the same instance of the core's main loop,
    and the split logits lie up to 6.4e-5 of their value (hundreds of
    units at the shipped GMMs' 1e5 to 1e8) from the float32 ones, so an
    lse of another arithmetic would overflow or underflow every
    weight."""
    values, argmax, launched = _score_rows_wg(
        x, bufs, "split", "gmm_score_rows_marg_tc_cuda", True)
    gmm_score_rows_marg_tc_cuda.launches += launched
    return values, argmax


def gmm_score_rows_bf16_cuda(x, bufs):
    """Launch the MAP scorer of the ``"bf16"`` mode on the tensor cores
    (K5 bf16, ``csrc/gmm_score_wg.cu``: K1 bf16's logits, one product a
    k16 step) on rows ``x (N, 64)`` float32 on a card. Same outputs as
    ``score_bf16_plain``."""
    values, argmax, launched = _score_rows_wg(x, bufs, "bf16",
                                              "gmm_score_rows_bf16_cuda")
    gmm_score_rows_bf16_cuda.launches += launched
    return values, argmax


def gmm_score_rows_marg_bf16_cuda(x, bufs):
    """Launch the logsumexp instance of the ``"bf16"`` scorer (K5 lse
    bf16); same outputs as ``score_bf16_marg_plain``. Its logsumexp is
    what :func:`gmm_unit_marg_bf16_cuda` and
    :func:`gmm_hvp_marg_weights_bf16_cuda` take, as under ``"split"``."""
    values, argmax, launched = _score_rows_wg(
        x, bufs, "bf16", "gmm_score_rows_marg_bf16_cuda", True)
    gmm_score_rows_marg_bf16_cuda.launches += launched
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


def _check_marg(x, lse, bufs, mode, name):
    """Checks a marginalise row kernel's rows, logsumexp and buffers of
    ``mode``; the device, the row count, the pair buffer, the component
    count, and the CTAs of the persistent launch (one an SM, at most one
    a tile of rows) with their slice each of the weights' scratch."""
    device, n = _check_rows(x, name)
    pairs, k = _wg_pairs(bufs, mode, device)
    _check(lse, "lse", torch.float32, (n,), device)
    _check(bufs["a_full"], "a_full", torch.float32, (k, D, D), device)
    _check(bufs["b_rows"], "b_rows", torch.float32, (k, D), device)
    ctas = min(-(-n // WG_ROWS),
               torch.cuda.get_device_properties(device).multi_processor_count)
    wts = torch.empty((max(ctas, 1), WG_ROWS, KP_WG), dtype=torch.float32,
                      device=device)
    return device, n, pairs, k, ctas, wts


def _unit_marg_wg(x, lse, bufs, mode, name):
    """K8 of ``mode`` on the warpgroup core: the unit rows and whether it
    launched."""
    device, n, pairs, k, ctas, wts = _check_marg(x, lse, bufs, mode, name)
    buf = torch.empty(n * (D + 1), dtype=torch.float32, device=device)
    out, wsum = buf[:n * D].view(n, D), buf[n * D:]
    if n:
        _launch("gmm_score_wg_unit", x, lse, n, pairs, bufs["lin_wg"],
                bufs["a_full"], bufs["b_rows"], k, WG_PRODUCTS[mode], wts,
                ctas, wsum, out, wg=True)
    return out, bool(n)


def _hvp_marg_weights_wg(x, t, lse, bufs, mode, name):
    """K9a of ``mode`` on the warpgroup core: p, dp and whether it
    launched."""
    device, n, pairs, k, ctas, wts = _check_marg(x, lse, bufs, mode, name)
    _check(t, "tangents", torch.float32, (n, D), device)
    p = torch.empty((k, n), dtype=torch.float32, device=device)
    dp = torch.empty((k, n), dtype=torch.float32, device=device)
    ref = torch.empty(2 * n, dtype=torch.float32, device=device)
    if n:
        _launch("gmm_score_wg_weights", x, t, lse, n, pairs, bufs["lin_wg"],
                bufs["a_full"], bufs["b_rows"], k, WG_PRODUCTS[mode], wts,
                ctas, ref, p, dp, wg=True)
    return p, dp, bool(n)


def gmm_unit_marg_cuda(x, lse, bufs):
    """Launch the marginalise unit gradient of the ``"f32"`` mode (K8:
    the six-product core of ``csrc/gmm_score_wg.cu``, the mixture in
    float32) on rows ``x (N, 64)`` with the logsumexp ``lse (N,)`` of
    :func:`gmm_score_rows_marg_cuda`, whose logits it recomputes bit for
    bit; ``(N, 64)``. Same contract as :func:`unit_marg_plain`."""
    out, launched = _unit_marg_wg(x, lse, bufs, "f32", "gmm_unit_marg_cuda")
    gmm_unit_marg_cuda.launches += launched
    return out


def gmm_hvp_marg_weights_cuda(x, t, lse, bufs):
    """Launch the first stage of the marginalise Hessian action of the
    ``"f32"`` mode (K9a, the core of :func:`gmm_unit_marg_cuda`, ``g`` in
    float32) with the logsumexp of :func:`gmm_score_rows_marg_cuda`:
    ``(p, dp)``, each ``(K, N)``. Same contract as
    :func:`hvp_marg_weights_plain`."""
    p, dp, launched = _hvp_marg_weights_wg(x, t, lse, bufs, "f32",
                                           "gmm_hvp_marg_weights_cuda")
    gmm_hvp_marg_weights_cuda.launches += launched
    return p, dp


def gmm_unit_marg_tc_cuda(x, lse, bufs):
    """Launch the marginalise unit gradient of the ``"split"`` mode (K8
    split: the logits on the tensor cores, the mixture in float32) on
    rows ``x (N, 64)`` with the logsumexp ``lse (N,)`` of
    :func:`gmm_score_rows_marg_tc_cuda`; ``(N, 64)``. Same contract as
    ``marg_unit_split_plain``."""
    out, launched = _unit_marg_wg(x, lse, bufs, "split",
                                  "gmm_unit_marg_tc_cuda")
    gmm_unit_marg_tc_cuda.launches += launched
    return out


def gmm_unit_marg_bf16_cuda(x, lse, bufs):
    """Launch the marginalise unit gradient of the ``"bf16"`` mode (K8
    bf16) with the logsumexp of :func:`gmm_score_rows_marg_bf16_cuda`;
    ``(N, 64)``. Same contract as ``marg_unit_bf16_plain``."""
    out, launched = _unit_marg_wg(x, lse, bufs, "bf16",
                                  "gmm_unit_marg_bf16_cuda")
    gmm_unit_marg_bf16_cuda.launches += launched
    return out


def gmm_hvp_marg_weights_tc_cuda(x, t, lse, bufs):
    """Launch the first stage of the marginalise Hessian action of the
    ``"split"`` mode (K9a split) with the logsumexp of
    :func:`gmm_score_rows_marg_tc_cuda`: ``(p, dp)``, each ``(K, N)``.
    Same contract as :func:`hvp_marg_weights_split_plain`."""
    p, dp, launched = _hvp_marg_weights_wg(x, t, lse, bufs, "split",
                                           "gmm_hvp_marg_weights_tc_cuda")
    gmm_hvp_marg_weights_tc_cuda.launches += launched
    return p, dp


def gmm_hvp_marg_weights_bf16_cuda(x, t, lse, bufs):
    """Launch the first stage of the marginalise Hessian action of the
    ``"bf16"`` mode (K9a bf16: single-bf16 logits, ``g`` in float32) with
    the logsumexp of :func:`gmm_score_rows_marg_bf16_cuda`: ``(p, dp)``,
    each ``(K, N)``. Same contract as
    :func:`hvp_marg_weights_bf16_plain`."""
    p, dp, launched = _hvp_marg_weights_wg(x, t, lse, bufs, "bf16",
                                           "gmm_hvp_marg_weights_bf16_cuda")
    gmm_hvp_marg_weights_bf16_cuda.launches += launched
    return p, dp


def gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs):
    """Launch the second stage of the marginalise Hessian action; ``(N, 64)``."""
    device, n = _check_rows(x, "gmm_hvp_marg_mix_cuda")
    _check(t, "tangents", torch.float32, (n, D), device)
    a_full, b_rows = bufs["a_full"], bufs["b_rows"]
    k = a_full.shape[0]
    _check(p, "p", torch.float32, (k, n), device)
    _check(dp, "dp", torch.float32, (k, n), device)
    _check(a_full, "a_full", torch.float32, (k, D, D), device)
    _check(b_rows, "b_rows", torch.float32, (k, D), device)
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    if n:
        _launch("gmm_hvp_marg_mix", x, t, p, dp, a_full, b_rows, n, k, out)
        gmm_hvp_marg_mix_cuda.launches += 1
    return out


def reset_counters():
    """Set every launch and call count of this module to zero."""
    for fn in (gmm_score_rows_cuda, gmm_score_rows_marg_cuda,
               gmm_score_rows_tc_cuda,
               gmm_score_rows_marg_tc_cuda, gmm_score_rows_bf16_cuda,
               gmm_score_rows_marg_bf16_cuda, gmm_unit_map_cuda,
               gmm_hvp_map_cuda, gmm_unit_marg_cuda, gmm_unit_marg_tc_cuda,
               gmm_unit_marg_bf16_cuda, gmm_hvp_marg_weights_cuda,
               gmm_hvp_marg_weights_tc_cuda, gmm_hvp_marg_weights_bf16_cuda,
               gmm_hvp_marg_mix_cuda):
        fn.launches = 0
    for fn in (score_rows_plain, unit_map_plain, hvp_map_plain,
               unit_marg_plain, hvp_marg_weights_plain,
               hvp_marg_weights_split_plain, hvp_marg_weights_bf16_plain,
               hvp_marg_mix_plain):
        fn.calls = 0


reset_counters()


# ----------------------------------------------------------------------
# dispatch and autograd


# the tensor-core kernels of the bf16 modes: the scorers by (mode,
# marginalize), the marginalise unit gradients and first Hessian stages
# by mode
_SCORES_TC = {
    ("split", False): gmm_score_rows_tc_cuda,
    ("split", True): gmm_score_rows_marg_tc_cuda,
    ("bf16", False): gmm_score_rows_bf16_cuda,
    ("bf16", True): gmm_score_rows_marg_bf16_cuda,
}
_UNITS_MARG = {"f32": gmm_unit_marg_cuda, "split": gmm_unit_marg_tc_cuda,
               "bf16": gmm_unit_marg_bf16_cuda}
_WEIGHTS_MARG = {"f32": gmm_hvp_marg_weights_cuda,
                 "split": gmm_hvp_marg_weights_tc_cuda,
                 "bf16": gmm_hvp_marg_weights_bf16_cuda}


def route(x):
    """``"kernel"`` for 8x8 patch rows on a card, ``"plain"`` otherwise.

    The kernels take d = 64. Rows of other patch sizes take the plain
    scorer on whatever device they lie, the card included, as the JAX
    package sends such a GMM to its XLA scorer (neither package has a
    kernel for them). The rule reads the rows' width, never a failure:
    an 8x8 row on a card always launches its kernel.
    """
    if dispatch(x) == "kernel" and x.shape[-1] == D:
        return "kernel"
    return "plain"


def _score(x, bufs, marginalize, mode):
    if mode == "f32":
        score = (gmm_score_rows_cuda if route(x) == "kernel"
                 else score_rows_plain)
        return score(x, bufs, marginalize)
    score = (_SCORES_TC if route(x) == "kernel"
             else PLAIN_SCORES)[mode, marginalize]
    return score(x, bufs)


def _unit(x, argmax, bufs):
    if route(x) == "kernel":
        return gmm_unit_map_cuda(x, argmax, bufs)
    return unit_map_plain(x, argmax, bufs)


def _hvp(t, argmax, bufs):
    if route(t) == "kernel":
        return gmm_hvp_map_cuda(t, argmax, bufs)
    return hvp_map_plain(t, argmax, bufs)


def _unit_marg(x, lse, bufs, mode):
    if route(x) == "kernel":
        unit = _UNITS_MARG[mode]
    else:
        unit = unit_marg_plain if mode == "f32" else PLAIN_UNITS[mode]
    return unit(x, lse, bufs)


def _hvp_marg(t, x, lse, bufs, mode):
    if route(t) == "kernel":
        p, dp = _WEIGHTS_MARG[mode](x, t, lse, bufs)
        return gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs)
    return hvp_marg_plain(t, x, lse, bufs, mode)


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


class _HvpMarg(torch.autograd.Function):
    """Marginalise Hessian action along ``t`` at ``x``, the first stage's
    logits of ``mode``. Neither package has its derivative (a third order
    of the score), so its backward raises rather than let one come out as
    zero."""

    @staticmethod
    def forward(ctx, t, x, lse, bufs, mode):
        return _hvp_marg(t, x, lse, bufs, mode)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "the marginalised GMM score has no third derivative: the "
            "marginalise Hessian action is not differentiable"
        )


class _UnitMarg(torch.autograd.Function):
    """Marginalise unit gradient, the softmax over the logits of ``mode``
    (the scorer's, whose logsumexp ``lse`` is); its backward is the
    Hessian action in the same mode (the Hessian of a scalar is
    symmetric). No gradient reaches ``lse``: the renormalised weights do
    not depend on it."""

    @staticmethod
    def forward(ctx, x, lse, bufs, mode):
        ctx.save_for_backward(x, lse)
        ctx.bufs = bufs
        ctx.mode = mode
        return _unit_marg(x, lse, bufs, mode)

    @staticmethod
    def backward(ctx, t):
        x, lse = ctx.saved_tensors
        hvp = _HvpMarg.apply(t.contiguous(), x, lse, ctx.bufs, ctx.mode)
        return hvp, None, None, None


class _PatchScore(torch.autograd.Function):
    """Scorer; its backward is ``dvalues * unit``, itself differentiable."""

    @staticmethod
    def forward(ctx, x, bufs, marginalize, mode):
        values, argmax = _score(x, bufs, marginalize, mode)
        # the marginalise unit gradient takes the logsumexp (the values),
        # the MAP one the argmax
        ctx.save_for_backward(x, values if marginalize else argmax)
        ctx.bufs = bufs
        ctx.marginalize = marginalize
        ctx.mode = mode
        ctx.mark_non_differentiable(argmax)
        return values, argmax

    @staticmethod
    def backward(ctx, dvalues, _dargmax):
        x, selector = ctx.saved_tensors
        if ctx.marginalize:
            unit = _UnitMarg.apply(x, selector.detach(), ctx.bufs, ctx.mode)
        else:
            unit = _UnitMap.apply(x, selector, ctx.bufs)
        return dvalues[:, None] * unit, None, None, None


def gmm_score_patches(x, bufs, marginalize=False, mode="f32"):
    """GMM scores of normalised patch rows.

    Parameters
    ----------
    x : tensor ``(N, d)`` float32
        Masked, mean-subtracted patches.
    bufs : dict
        From ``ops.gmm_fused.kernel_buffers`` on ``x``'s device.
    marginalize : bool
        Logsumexp instead of max over the components.
    mode : ``"f32"``, ``"split"`` or ``"bf16"``
        The logits of the scorer and, marginalising, of its gradient and
        Hessian action, which the forward's mode fixes
        (``config.gmm_mode()`` names the dial's). Patches other than 8x8,
        for which ``kernel_buffers`` makes no bf16 buffers, take ``"f32"``
        in every mode, and the plain scorer on every device
        (:func:`route`).

    Returns
    -------
    values : ``(N,)`` float32, differentiable twice with respect to ``x``
    argmax : ``(N,)`` int32
    """
    _check_mode(mode)
    if x.shape[1] != D:
        mode = "f32"
    return _PatchScore.apply(x.contiguous(), bufs, bool(marginalize), mode)
