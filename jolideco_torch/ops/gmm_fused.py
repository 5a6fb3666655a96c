"""Fused patch extraction + GMM scoring, forward and backward.

Counterpart of the JAX package's ``ops/gmm_fused.py``. One pass takes an
image to per-patch GMM scores:

    image -> offset-group patches -> zero-flux mask -> mean subtraction
          -> logits -1/2 x^T A_k x + b_k . x + c_k
          -> max / argmax (MAP) or logsumexp (marginalise)

and the backward takes the per-patch cotangents back to the image:
``dv (b_{k*} - A_{k*} x)`` (MAP) or ``dv sum_k p_k (b_k - A_k x)``
with ``p`` the softmax of the logits, recomputed from the saved patches
(marginalise), then the transpose of the mean subtraction and the mask,
and back to image layout per offset group.

Each direction has two implementations with one contract:

- a CUDA kernel written by hand for Hopper (``csrc/gmm_fused.cu`` and
  ``csrc/gmm_fused_tc.cu``, whose headers say what bounds them and how
  they are built), run for a tensor on a CUDA card;
- a plain PyTorch version (``*_plain``), run for a tensor on the CPU,
  and the reference the kernel is checked against on the card.

The logits have three modes, which the precision dial names
(``config.gmm_mode``) and the caller passes down: ``"f32"``, full
float32; ``"split"``, the JAX package's logits at precision HIGH: the
quadratic form as a product of the pair products ``x_a x_b`` (``a <=
b``) with ``A`` (off-diagonals doubled), both split into bf16 hi and lo
parts, three products hi.hi + hi.lo + lo.hi summed in float32, and
``b . x`` in float32; and ``"bf16"``, its logits at precision DEFAULT
(what the TPU's matrix unit does with float32 operands): the same
operands rounded to bf16, one product hi.hi summed in float32, ``b . x``
in float32. The two bf16 modes' kernels run on the tensor cores
(``csrc/gmm_fused_tc.cu``, one code with three products or one), their
plain versions as float32 matmuls of the bf16-valued parts. The mode
reaches both forwards (maximum and
logsumexp) and the marginalise backward, which recomputes the logits
in the mode of the forward that saved their logsumexp: with logits of
1e5 to 1e8, the softmax weights are only right against an lse of the
same arithmetic. The mixture ``sum_k p_k (b_k - A_k x)`` and the MAP
backward, which reads no logit, are float32 in either mode.

The rule is ``config.dispatch``: nothing falls back from the kernel to
the plain version. Each wrapper keeps a plain integer count of its
launches (``gmm_fused_fwd_cuda.launches``, ...), so a run can show that
it went through the kernels, and each plain version a count of its
calls.

Patch order is group-major and row-major over each group's grid, as
the JAX package's ``gmm_score_fused_image`` returns it. The JAX
function enumerates grids padded to its TPU tiling; this one enumerates
every group on the common ``(H // 8, W // 8)`` grid. Patches outside the
image come back ``valid == False`` in both, so ``values[valid]`` line
up one to one. The TPU's layout tricks (one-hot permutation matmuls,
bf16 splits, strip folding, 1024-lane chunks) are not part of the
contract and are not ported.
"""

import ctypes

import numpy as np
import torch

from ..config import dispatch
from .linalg import bf16_round, bf16_split

__all__ = [
    "fused_patch_count",
    "fused_supported",
    "bf16_logit_chunks",
    "gmm_fused_bwd_cuda",
    "gmm_fused_bwd_marg_bf16_cuda",
    "gmm_fused_bwd_marg_cuda",
    "gmm_fused_bwd_marg_tc_cuda",
    "gmm_fused_fwd_bf16_cuda",
    "gmm_fused_fwd_cuda",
    "gmm_fused_fwd_marg_bf16_cuda",
    "gmm_fused_fwd_marg_cuda",
    "gmm_fused_fwd_marg_tc_cuda",
    "gmm_fused_fwd_tc_cuda",
    "fused_backward_marg_plain",
    "fused_backward_plain",
    "fused_forward_plain",
    "gmm_score_fused_image",
    "gmm_score_fused_partial_sum",
    "kernel_buffers",
    "logit_chunks",
    "marg_unit_bf16_plain",
    "marg_unit_rows",
    "marg_unit_split_plain",
    "mix_rows",
    "mode_logit_chunks",
    "reset_counters",
    "score_bf16_marg_plain",
    "score_bf16_plain",
    "score_plain",
    "score_split_marg_plain",
    "score_split_plain",
    "softmax_chunks",
    "split_logit_chunks",
]

PATCH = 8
D = PATCH * PATCH
# float32s per component record of the forward kernel: the row-padded
# upper triangle of A_k (see csrc/gmm_fused.cu), b_k, c_k and padding
SYM = 2176
REC = SYM + D + 4
# patch rows per chunk of the plain versions' (n, 4096) outer products:
# 64 MB of float32 per chunk
PLAIN_CHUNK = 4096
# the "split" mode's pair products x_a x_b, a <= b, row-major over a
PAIR_A, PAIR_B = np.triu_indices(D)
PAIRS = len(PAIR_A)
# the tensor-core kernel (csrc/gmm_fused_tc.cu): components in tiles of
# KP_TC (the last padded), pairs in chunks of TC_CHUNK
KP_TC = 208
TC_CHUNK = 32
MODES = ("f32", "split", "bf16")
# bf16 products per k16 step of the tensor-core kernels, by mode
TC_PRODUCTS = {"split": 3, "bf16": 1}


def fused_supported(image_shape, patch_shape, stride, n_features):
    """Whether the fused image-level scorer applies.

    8x8 patches (d = 64), a stride dividing 8 and an image of at least
    one patch. The JAX package also asks for an image at least 128 px
    wide, a threshold of the TPU's 128-lane tiling; the CUDA kernel
    takes any width.
    """
    h, w = image_shape[-2:]
    p = patch_shape[0]
    return (
        p == PATCH
        and patch_shape[1] == p
        and n_features == D
        and p % stride == 0
        and w >= p
        and h >= p
    )


def _offsets(stride):
    return [(a, b) for a in range(0, PATCH, stride)
            for b in range(0, PATCH, stride)]


def fused_patch_count(image_shape, stride):
    """Patch count ``G * (H // 8) * (W // 8)`` of the enumeration."""
    h, w = image_shape[-2:]
    return len(_offsets(stride)) * (h // PATCH) * (w // PATCH)


def _sym_rows(a_quad):
    """Row-padded upper triangles ``(K, SYM)`` of symmetric ``A_k``.

    Row ``r`` holds columns ``r & ~3 .. 63``: zero left of the diagonal,
    ``A_rr`` on it and ``A_rc + A_cr`` right of it, so that
    ``x^T A x = sum_r x_r sum_c U_rc x_c``. Summed in float64.
    """
    k = a_quad.shape[0]
    out = np.zeros((k, SYM), np.float64)
    off = 0
    for r in range(D):
        c0 = r & ~3
        row = np.zeros((k, D - c0))
        row[:, r - c0] = a_quad[:, r, r]
        row[:, r - c0 + 1:] = a_quad[:, r, r + 1:] + a_quad[:, r + 1:, r]
        out[:, off:off + D - c0] = row
        off += D - c0
    assert off == SYM
    return out


def _pair_rows(a_quad):
    """``(PAIRS, K)`` pair-major ``A``: ``A_aa`` for the pair ``(a, a)``,
    ``A_ab + A_ba`` for ``(a, b)``, ``a < b``, so that ``x^T A x =
    sum_p (x_a x_b)_p U_p``. Summed in float64."""
    sym = a_quad[:, PAIR_A, PAIR_B] + a_quad[:, PAIR_B, PAIR_A]
    sym[:, PAIR_A == PAIR_B] *= 0.5
    return np.ascontiguousarray(sym.T)


def _split_buffers(a_quad, bq, const2):
    """The buffers of the ``"split"`` and ``"bf16"`` modes.

    ``pair_hi``, ``pair_lo (PAIRS, K)``: the bf16 hi/lo split of the
    pair-major ``A`` (float32 holding bf16 values), for the plain
    versions; ``pair_hi`` alone is the ``"bf16"`` mode's operand, bf16
    of the JAX package's float32 ``A`` (doubled off the diagonal, which
    bf16 does exactly).
    For the tensor-core kernels, whose blocks take the components in
    ``T = ceil(K / KP_TC)`` tiles: ``pair_tc`` bf16 ``(T, PAIRS /
    TC_CHUNK, 2, KP_TC, TC_CHUNK)``, the same parts tile by tile and
    chunk by chunk (hi then lo, each component's pairs of the chunk
    contiguous, the last tile padded with zero components; the
    ``"bf16"`` kernels read the hi half of each chunk), and ``bc (T,
    d + 1, KP_TC)`` float32, ``b`` component-minor with ``c`` as its
    last row.
    """
    pair = torch.as_tensor(_pair_rows(a_quad).astype(np.float32))
    hi, lo = bf16_split(pair)
    d, k = bq.shape
    tiles = -(-k // KP_TC)
    parts = torch.zeros((2, tiles * KP_TC, PAIRS))
    parts[0, :k], parts[1, :k] = hi.T, lo.T
    pair_tc = (
        parts.reshape(2, tiles, KP_TC, PAIRS // TC_CHUNK, TC_CHUNK)
        .permute(1, 3, 0, 2, 4).contiguous().to(torch.bfloat16)
    )
    bc = torch.zeros((d + 1, tiles * KP_TC))
    bc[:d, :k] = torch.as_tensor(bq)
    bc[d, :k] = torch.as_tensor(const2)
    bc = bc.reshape(d + 1, tiles, KP_TC).permute(1, 0, 2).contiguous()
    return {"pair_hi": hi, "pair_lo": lo, "pair_tc": pair_tc, "bc": bc}


def kernel_buffers(packed, device):
    """Device tensors for both implementations from ``pack_gmm_buffers``.

    ``aq (d*d, K)``, ``bq (d, K)``, ``const2 (K,)`` feed the plain
    scorers; ``a_full (K, d, d)``, ``b_rows (K, d)`` the backwards and
    Hessian actions, plain and CUDA. For 8x8 patches also ``rec (K, REC)``
    for the CUDA scorers (``csrc/gmm_logits.cuh``), ``a_bwd (K, d, d)``
    and ``b_bwd (K, d)`` for the MAP backward kernel: ``A`` less its
    column means, transposed (``[c][r]``), and ``b`` less its mean, so
    that ``dv (b_bwd - a_bwd^T x)`` is ``u - mean(u)``, and the
    buffers of the ``"split"`` and ``"bf16"`` modes
    (:func:`_split_buffers`). ``a_full`` is symmetric bit for bit (the
    packing forms it as ``P diag(w) P^T``), which the pair form's
    doubled off-diagonals rely on.
    """
    aq = np.asarray(packed["aq"], np.float32)
    bq = np.asarray(packed["bq"], np.float32)
    const2 = np.asarray(packed["const2"], np.float32).reshape(-1)
    d, k = bq.shape
    arrays = {"aq": aq, "bq": bq, "const2": const2,
              "a_full": aq.T.reshape(k, d, d), "b_rows": bq.T}
    if d == D:
        a_quad = np.asarray(packed["a_quad"], np.float64)
        rec = np.zeros((k, REC), np.float32)
        rec[:, :SYM] = _sym_rows(a_quad)
        rec[:, SYM:SYM + D] = bq.T
        rec[:, SYM + D] = const2
        arrays["rec"] = rec
        a64 = aq.T.reshape(k, d, d).astype(np.float64)
        arrays["a_bwd"] = (a64 - a64.mean(axis=1, keepdims=True)).transpose(
            0, 2, 1).astype(np.float32)
        b64 = bq.T.astype(np.float64)
        arrays["b_bwd"] = (b64 - b64.mean(axis=1, keepdims=True)).astype(
            np.float32)
    out = {name: torch.as_tensor(np.ascontiguousarray(a))
           for name, a in arrays.items()}
    if d == D:
        out.update(_split_buffers(a_quad, bq, const2))
    return {name: t.to(device) for name, t in out.items()}


# ----------------------------------------------------------------------
# plain PyTorch versions


def _group_slices(image, stride):
    """Zero-padded image and the per-group grid masks ``(G, ny, nx)``."""
    h, w = image.shape
    ny, nx = h // PATCH, w // PATCH
    padded = torch.nn.functional.pad(image, (0, PATCH, 0, PATCH))
    masks = []
    for a, b in _offsets(stride):
        rows = torch.arange(ny, device=image.device) < (h - a) // PATCH
        cols = torch.arange(nx, device=image.device) < (w - b) // PATCH
        masks.append(rows[:, None] & cols[None, :])
    return padded, torch.stack(masks)


def logit_chunks(xtn, aq, bq, const2):
    """GMM logits ``(rows, K)`` of normalised patches ``(n, d)``, chunk by chunk.

    The quadratic form runs as a ``(rows, d*d) @ (d*d, K)`` matmul over
    chunks of ``PLAIN_CHUNK`` rows, so that memory stays bounded.
    """
    d = xtn.shape[1]
    for start in range(0, xtn.shape[0], PLAIN_CHUNK):
        x = xtn[start:start + PLAIN_CHUNK]
        u = (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], d * d)
        yield -0.5 * (u @ aq) + x @ bq + const2


def mode_logit_chunks(x, bufs, mode):
    """The logit chunks of ``mode``: :func:`logit_chunks`,
    :func:`split_logit_chunks` or :func:`bf16_logit_chunks`."""
    if mode == "split":
        return split_logit_chunks(x, bufs)
    if mode == "bf16":
        return bf16_logit_chunks(x, bufs)
    return logit_chunks(x, bufs["aq"], bufs["bq"], bufs["const2"])


def softmax_chunks(x, lse, bufs, mode="f32"):
    """Per chunk of rows, ``(slice, p)`` with ``p (rows, K)`` the softmax
    ``exp(logit - lse)`` renormalised against the recomputed logits (the
    JAX package's rule: the result does not depend on the lse's
    rounding), the logits of ``mode`` (:func:`mode_logit_chunks`)."""
    chunks = mode_logit_chunks(x, bufs, mode)
    for start, logits in zip(range(0, x.shape[0], PLAIN_CHUNK), chunks):
        sl = slice(start, start + PLAIN_CHUNK)
        p = torch.exp(logits - lse[sl, None])
        yield sl, p / p.sum(dim=1, keepdim=True)


def mix_rows(w, x, bufs):
    """``sum_k w_k A_k x`` per row for weights ``w (rows, K)``: ``(rows, d)``."""
    k, d = bufs["b_rows"].shape
    a_mix = (w @ bufs["a_full"].reshape(k, d * d)).reshape(-1, d, d)
    return torch.bmm(a_mix, x[:, :, None])[:, :, 0]


def marg_unit_rows(x, lse, bufs, mode="f32"):
    """Marginalise unit gradient ``sum_k p_k (b_k - A_k x)`` of rows ``x``,
    the softmax over the logits of ``mode``, the mixture in the rows'
    type."""
    out = [x.new_empty((0, x.shape[1]))]
    for sl, p in softmax_chunks(x, lse, bufs, mode):
        out.append(p @ bufs["b_rows"] - mix_rows(p, x[sl], bufs))
    return torch.cat(out)


def marg_unit_split_plain(x, lse, bufs):
    """:func:`marg_unit_rows` in the ``"split"`` mode: the softmax over
    the split logits against ``lse``, a logsumexp of the same logits
    (:func:`score_split_marg_plain`), then the float32 mixture."""
    marg_unit_split_plain.calls += 1
    return marg_unit_rows(x, lse, bufs, "split")


def marg_unit_bf16_plain(x, lse, bufs):
    """:func:`marg_unit_rows` in the ``"bf16"`` mode: the softmax over
    the single-bf16 logits against ``lse``, a logsumexp of the same
    logits (:func:`score_bf16_marg_plain`), then the float32 mixture."""
    marg_unit_bf16_plain.calls += 1
    return marg_unit_rows(x, lse, bufs, "bf16")


def _scores(x, chunks, marginalize):
    """Values and argmax of rows ``x (n, d)`` from their logit chunks
    ``(rows, K)``: the maximum or the logsumexp, and the lowest index
    among equal maxima (``torch.max`` returns the first)."""
    values, argmax = [x.new_empty(0)], [x.new_empty(0, dtype=torch.int32)]
    for logits in chunks:
        v, k = torch.max(logits, dim=1)
        if marginalize:
            v = torch.logsumexp(logits, dim=1)
        values.append(v)
        argmax.append(k.to(torch.int32))
    return torch.cat(values), torch.cat(argmax)


def split_logit_chunks(xtn, bufs):
    """The ``"split"`` mode's logits ``(rows, K)`` of normalised patches
    ``(n, d)``, chunk by chunk: the pair products and the pair-major
    ``A`` split into bf16 hi and lo, three float32 matmuls of the
    bf16-valued parts (``hi.hi + hi.lo + lo.hi``; TF32 stays off, as
    ``config`` pins it), and ``b . x`` in float32."""
    a_hi, a_lo = bufs["pair_hi"], bufs["pair_lo"]
    pa = torch.as_tensor(PAIR_A, device=xtn.device)
    pb = torch.as_tensor(PAIR_B, device=xtn.device)
    for start in range(0, xtn.shape[0], PLAIN_CHUNK):
        x = xtn[start:start + PLAIN_CHUNK]
        u_hi, u_lo = bf16_split(x[:, pa] * x[:, pb])
        q = (u_hi @ a_hi + u_hi @ a_lo) + u_lo @ a_hi
        yield -0.5 * q + x @ bufs["bq"] + bufs["const2"]


def bf16_logit_chunks(xtn, bufs):
    """The ``"bf16"`` mode's logits ``(rows, K)`` of normalised patches
    ``(n, d)``, chunk by chunk: the JAX package's logits at precision
    DEFAULT on the TPU, whose matrix unit rounds each float32 operand to
    bf16 (round to nearest even), multiplies exactly and sums in float32.
    The pair products ``x_a x_b`` (formed in float32) and the pair-major
    ``A`` (``pair_hi``) rounded to bf16, one float32 matmul of the
    bf16-valued operands (TF32 stays off, as ``config`` pins it), and
    ``b . x`` in float32 (the JAX package's HIGHEST). Off the diagonal the
    pair form holds ``A_ab + A_ba = 2 A_ab`` (``A`` is symmetric bit for
    bit, and bf16 doubles exactly), so each pair's product is the sum of
    the JAX package's two products ``u_ab A_ab`` and ``u_ba A_ba``."""
    a_hi = bufs["pair_hi"]
    pa = torch.as_tensor(PAIR_A, device=xtn.device)
    pb = torch.as_tensor(PAIR_B, device=xtn.device)
    for start in range(0, xtn.shape[0], PLAIN_CHUNK):
        x = xtn[start:start + PLAIN_CHUNK]
        u_hi = bf16_round(x[:, pa] * x[:, pb])
        yield -0.5 * (u_hi @ a_hi) + x @ bufs["bq"] + bufs["const2"]


def score_bf16_plain(xtn, bufs):
    """MAP scores of normalised patches ``(n, d)`` in the ``"bf16"``
    mode: values and argmax (the lowest index among equal maxima)."""
    score_bf16_plain.calls += 1
    return _scores(xtn, bf16_logit_chunks(xtn, bufs), False)


def score_bf16_marg_plain(xtn, bufs):
    """Marginalise scores of normalised patches ``(n, d)`` in the
    ``"bf16"`` mode: the logsumexp of the single-bf16 logits, and their
    argmax (the lowest index among equal maxima)."""
    score_bf16_marg_plain.calls += 1
    return _scores(xtn, bf16_logit_chunks(xtn, bufs), True)


def score_split_plain(xtn, bufs):
    """MAP scores of normalised patches ``(n, d)`` in the ``"split"``
    mode: values and argmax (the lowest index among equal maxima)."""
    score_split_plain.calls += 1
    return _scores(xtn, split_logit_chunks(xtn, bufs), False)


def score_split_marg_plain(xtn, bufs):
    """Marginalise scores of normalised patches ``(n, d)`` in the
    ``"split"`` mode: the logsumexp of the split logits, and their
    argmax (the lowest index among equal maxima)."""
    score_split_marg_plain.calls += 1
    return _scores(xtn, split_logit_chunks(xtn, bufs), True)


def score_plain(xtn, aq, bq, const2, marginalize=False):
    """Scores of normalised patches ``(n, d)``: values and argmax.

    Values are the maximum (MAP) or the logsumexp (marginalise) over the
    components; argmax is the lowest index among equal maxima
    (``torch.max`` returns the first).
    """
    score_plain.calls += 1
    return _scores(xtn, logit_chunks(xtn, aq, bq, const2), marginalize)


def fused_forward_plain(image, bufs, stride, sentinel, marginalize=False,
                        mode="f32"):
    """Plain version of the forward kernels.

    Returns ``(values (N,), argmax (N,) int32, valid (N,) float32,
    xtn (N, 64))`` with ``xtn`` the masked, mean-subtracted patches and
    ``values`` the maximum (MAP) or logsumexp (``marginalize``) of the
    logits, in full float32 (``mode="f32"``) or the logits of the
    ``"split"`` or ``"bf16"`` mode (:func:`split_logit_chunks`,
    :func:`bf16_logit_chunks`).
    """
    _check_mode(mode)
    fused_forward_plain.calls += 1
    h, w = image.shape
    ny, nx = h // PATCH, w // PATCH
    padded, masks = _group_slices(image, stride)
    groups = []
    for a, b in _offsets(stride):
        sl = padded[a:a + PATCH * ny, b:b + PATCH * nx]
        groups.append(
            sl.reshape(ny, PATCH, nx, PATCH).permute(0, 2, 1, 3)
            .reshape(ny * nx, D)
        )
    patches = torch.cat(groups)
    valid = masks.reshape(-1) & torch.all(patches > sentinel, dim=1)
    x = torch.where(valid[:, None], patches, torch.zeros_like(patches))
    xtn = x - x.mean(dim=1, keepdim=True)
    if mode == "f32":
        values, argmax = score_plain(xtn, bufs["aq"], bufs["bq"],
                                     bufs["const2"], marginalize)
    else:
        values, argmax = PLAIN_SCORES[mode, marginalize](xtn, bufs)
    return values, argmax, valid.to(image.dtype), xtn


def fused_backward_plain(xtn, argmax, valid, dvalues, bufs, image_shape,
                         stride):
    """Plain version of the MAP backward kernel: the image gradient ``(H, W)``."""
    fused_backward_plain.calls += 1
    a_full, b_rows = bufs["a_full"], bufs["b_rows"]
    units = []
    for start in range(0, xtn.shape[0], PLAIN_CHUNK):
        sl = slice(start, start + PLAIN_CHUNK)
        k = argmax[sl].long()
        ax = torch.einsum("nrc,nc->nr", a_full[k], xtn[sl])
        units.append(dvalues[sl, None] * (b_rows[k] - ax))
    return _patches_to_image(torch.cat(units), valid, image_shape, stride)


def fused_backward_marg_plain(xtn, lse, valid, dvalues, bufs, image_shape,
                              stride, mode="f32"):
    """Plain version of the marginalise backward kernels: the image
    gradient ``(H, W)`` from the saved patches and the forward's
    logsumexp ``lse``, whose logits (``mode``) the softmax recomputes."""
    _check_mode(mode)
    fused_backward_marg_plain.calls += 1
    unit = (marg_unit_rows(xtn, lse, bufs) if mode == "f32"
            else PLAIN_UNITS[mode](xtn, lse, bufs))
    u = dvalues[:, None] * unit
    return _patches_to_image(u, valid, image_shape, stride)


# the plain scorers of the bf16 modes by (mode, marginalize), and their
# marginalise unit gradients by mode
PLAIN_SCORES = {
    ("split", False): score_split_plain,
    ("split", True): score_split_marg_plain,
    ("bf16", False): score_bf16_plain,
    ("bf16", True): score_bf16_marg_plain,
}
PLAIN_UNITS = {"split": marg_unit_split_plain, "bf16": marg_unit_bf16_plain}


def _patches_to_image(u, valid, image_shape, stride):
    """Both backwards' epilogue: the transpose of the mean subtraction and
    the mask, then each offset group's patches back into the image."""
    u = (u - u.mean(dim=1, keepdim=True)) * valid[:, None]

    h, w = image_shape
    ny, nx = h // PATCH, w // PATCH
    out = torch.zeros((h + PATCH, w + PATCH), dtype=u.dtype, device=u.device)
    per_group = ny * nx
    for g, (a, b) in enumerate(_offsets(stride)):
        block = (
            u[g * per_group:(g + 1) * per_group]
            .reshape(ny, nx, PATCH, PATCH).permute(0, 2, 1, 3)
            .reshape(PATCH * ny, PATCH * nx)
        )
        out[a:a + PATCH * ny, b:b + PATCH * nx] += block
    return out[:h, :w]


# ----------------------------------------------------------------------
# CUDA kernels


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"invalid fused-scorer mode {mode!r}")


def _tc_library():
    from ..utils.cuda_build import load_library

    lib = load_library("gmm_fused_tc")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gmm_fused_fwd_tc.argtypes = [vp, ci, ci, ci, ci, ci, cf, vp, vp,
                                         ci, ci, ci, vp, vp, vp, vp, vp]
        lib.gmm_fused_fwd_tc.restype = ci
        lib.gmm_fused_bwd_marg_tc.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                              ci, ci, ci, ci, ci, ci, ci, vp,
                                              vp]
        lib.gmm_fused_bwd_marg_tc.restype = ci
        lib.gmm_score_rows_tc.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp, vp,
                                          vp]
        lib.gmm_score_rows_tc.restype = ci
        lib.gmm_unit_marg_tc.argtypes = [vp, vp, ci, vp, vp, vp, vp, ci, ci,
                                         vp, vp]
        lib.gmm_unit_marg_tc.restype = ci
        lib.gmm_hvp_marg_weights_tc.argtypes = [vp, vp, vp, ci, vp, vp, vp,
                                                vp, ci, ci, vp, vp, vp]
        lib.gmm_hvp_marg_weights_tc.restype = ci
        lib.gmm_fused_tc_error_string.argtypes = [ci]
        lib.gmm_fused_tc_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library("gmm_fused")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gmm_fused_fwd.argtypes = [vp, ci, ci, ci, ci, ci, cf, vp, ci,
                                      ci, vp, vp, vp, vp, vp]
        lib.gmm_fused_fwd.restype = ci
        lib.gmm_fused_bwd.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                      ci, ci, vp, vp, vp]
        lib.gmm_fused_bwd.restype = ci
        lib.gmm_fused_bwd_marg.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, ci, vp, vp]
        lib.gmm_fused_bwd_marg.restype = ci
        lib.gmm_fused_error_string.argtypes = [ci]
        lib.gmm_fused_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(error_string, code, kernel):
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")


def _check_geometry(image, stride):
    h, w = image.shape
    if PATCH % stride != 0 or h < PATCH or w < PATCH:
        raise ValueError(
            f"fused kernels need stride | 8 and an image of at least 8x8, "
            f"got stride {stride} and shape {(h, w)}"
        )


def gmm_fused_fwd_cuda(image, bufs, stride, sentinel):
    """Launch the MAP forward kernel on ``image (H, W)`` float32 on a card.

    Same outputs as :func:`fused_forward_plain`.
    """
    out = _launch_forward(image, bufs, stride, sentinel, False)
    gmm_fused_fwd_cuda.launches += 1
    return out


def gmm_fused_fwd_marg_cuda(image, bufs, stride, sentinel):
    """Launch the marginalise (logsumexp) forward kernel; same outputs as
    :func:`fused_forward_plain` with ``marginalize=True``."""
    out = _launch_forward(image, bufs, stride, sentinel, True)
    gmm_fused_fwd_marg_cuda.launches += 1
    return out


def gmm_fused_fwd_tc_cuda(image, bufs, stride, sentinel):
    """Launch the MAP forward kernel of the ``"split"`` mode on the
    tensor cores (``csrc/gmm_fused_tc.cu``); same outputs as
    :func:`fused_forward_plain` with ``mode="split"``. Any number of
    components, in tiles of ``KP_TC``."""
    out = _launch_forward_tc(image, bufs, stride, sentinel, False, "split")
    gmm_fused_fwd_tc_cuda.launches += 1
    return out


def gmm_fused_fwd_marg_tc_cuda(image, bufs, stride, sentinel):
    """Launch the marginalise (logsumexp) forward kernel of the
    ``"split"`` mode on the tensor cores; same outputs as
    :func:`fused_forward_plain` with ``marginalize=True, mode="split"``."""
    out = _launch_forward_tc(image, bufs, stride, sentinel, True, "split")
    gmm_fused_fwd_marg_tc_cuda.launches += 1
    return out


def gmm_fused_fwd_bf16_cuda(image, bufs, stride, sentinel):
    """Launch the MAP forward kernel of the ``"bf16"`` mode on the tensor
    cores (``csrc/gmm_fused_tc.cu``, one product a k16 step); same
    outputs as :func:`fused_forward_plain` with ``mode="bf16"``."""
    out = _launch_forward_tc(image, bufs, stride, sentinel, False, "bf16")
    gmm_fused_fwd_bf16_cuda.launches += 1
    return out


def gmm_fused_fwd_marg_bf16_cuda(image, bufs, stride, sentinel):
    """Launch the marginalise (logsumexp) forward kernel of the
    ``"bf16"`` mode on the tensor cores; same outputs as
    :func:`fused_forward_plain` with ``marginalize=True, mode="bf16"``."""
    out = _launch_forward_tc(image, bufs, stride, sentinel, True, "bf16")
    gmm_fused_fwd_marg_bf16_cuda.launches += 1
    return out


def _split_tiles(bufs, device):
    """Checks the tensor-core kernels' buffers (both modes read
    ``pair_tc``: ``"bf16"`` its hi planes); the component count."""
    k = bufs["rec"].shape[0]
    tiles = -(-k // KP_TC)
    _check(bufs["pair_tc"], "pair_tc", torch.bfloat16,
           (tiles, PAIRS // TC_CHUNK, 2, KP_TC, TC_CHUNK), device)
    _check(bufs["bc"], "bc", torch.float32, (tiles, D + 1, KP_TC), device)
    return k


def _launch_forward_tc(image, bufs, stride, sentinel, marginalize, mode):
    values, argmax, valid, xtn = _forward_outputs(image, stride)
    device = image.device
    h, w = image.shape
    k = _split_tiles(bufs, device)
    lib = _tc_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_fwd_tc(
            image.data_ptr(), h, w, int(stride), h // PATCH, w // PATCH,
            float(sentinel), bufs["pair_tc"].data_ptr(),
            bufs["bc"].data_ptr(), k, int(bool(marginalize)),
            TC_PRODUCTS[mode], values.data_ptr(), argmax.data_ptr(),
            valid.data_ptr(), xtn.data_ptr(), stream,
        )
    _raise_on_error(lib.gmm_fused_tc_error_string, code, "gmm_fused_fwd_tc")
    return values, argmax, valid, xtn


def _forward_outputs(image, stride):
    """Checks a forward kernel's image; its four empty outputs."""
    device = image.device
    if device.type != "cuda":
        raise ValueError(f"the forward kernel needs a CUDA tensor, got {device}")
    _check_geometry(image, stride)
    h, w = image.shape
    n = fused_patch_count((h, w), stride)
    _check(image, "image", torch.float32, (h, w), device)
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.float32, device=device),
            torch.empty((n, D), dtype=torch.float32, device=device))


def _launch_forward(image, bufs, stride, sentinel, marginalize):
    values, argmax, valid, xtn = _forward_outputs(image, stride)
    device = image.device
    h, w = image.shape
    ny, nx = h // PATCH, w // PATCH
    rec = bufs["rec"]
    k = rec.shape[0]
    _check(rec, "rec", torch.float32, (k, REC), device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_fwd(
            image.data_ptr(), h, w, int(stride), ny, nx,
            float(sentinel), rec.data_ptr(), k, int(bool(marginalize)),
            values.data_ptr(),
            argmax.data_ptr(), valid.data_ptr(), xtn.data_ptr(), stream,
        )
    _raise_on_error(lib.gmm_fused_error_string, code, "gmm_fused_fwd")
    return values, argmax, valid, xtn


def gmm_fused_bwd_cuda(xtn, argmax, valid, dvalues, bufs, image_shape,
                       stride):
    """Launch the backward kernel; returns the image gradient ``(H, W)``.

    Two launches of one C entry point (``csrc/gmm_fused.cu``): the
    patches' ``u`` rows into a scratch ``(N, 64)``, then their
    overlap-add, group by group in order, into the gradient. Scratch and
    gradient share one allocation; nothing is read back to the host and
    the result is the same bits every run.
    """
    device = xtn.device
    if device.type != "cuda":
        raise ValueError(f"gmm_fused_bwd_cuda needs a CUDA tensor, got {device}")
    h, w = image_shape
    ny, nx = h // PATCH, w // PATCH
    n_groups = len(_offsets(stride))
    n = n_groups * ny * nx
    a_bwd, b_bwd = bufs["a_bwd"], bufs["b_bwd"]
    k = a_bwd.shape[0]
    _check(xtn, "xtn", torch.float32, (n, D), device)
    _check(argmax, "argmax", torch.int32, (n,), device)
    _check(valid, "valid", torch.float32, (n,), device)
    _check(dvalues, "dvalues", torch.float32, (n,), device)
    _check(a_bwd, "a_bwd", torch.float32, (k, D, D), device)
    _check(b_bwd, "b_bwd", torch.float32, (k, D), device)

    buf = torch.empty(n * D + h * w, dtype=torch.float32, device=device)
    units, grad = buf[:n * D], buf[n * D:].view(h, w)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_bwd(
            xtn.data_ptr(), argmax.data_ptr(), valid.data_ptr(),
            dvalues.data_ptr(), a_bwd.data_ptr(), b_bwd.data_ptr(),
            h, w, int(stride), ny, nx, units.data_ptr(), grad.data_ptr(),
            stream,
        )
    _raise_on_error(lib.gmm_fused_error_string, code, "gmm_fused_bwd")
    gmm_fused_bwd_cuda.launches += 1
    return grad


def _backward_marg_inputs(xtn, lse, valid, dvalues, bufs, image_shape,
                          stride, kernel):
    """Checks a marginalise backward kernel's inputs; its zero-filled
    planes, one per offset group, and the component count."""
    device = xtn.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} needs a CUDA tensor, got {device}")
    h, w = image_shape
    n_groups = len(_offsets(stride))
    n = n_groups * (h // PATCH) * (w // PATCH)
    k = bufs["a_full"].shape[0]
    _check(xtn, "xtn", torch.float32, (n, D), device)
    for name, t in (("lse", lse), ("valid", valid), ("dvalues", dvalues)):
        _check(t, name, torch.float32, (n,), device)
    _check(bufs["a_full"], "a_full", torch.float32, (k, D, D), device)
    planes = torch.zeros((n_groups, h, w), dtype=torch.float32, device=device)
    return planes, k


def gmm_fused_bwd_marg_cuda(xtn, lse, valid, dvalues, bufs, image_shape,
                            stride):
    """Launch the marginalise backward kernel; returns the image gradient
    ``(H, W)``. Same contract as :func:`fused_backward_marg_plain`; the
    planes are those of :func:`gmm_fused_bwd_cuda`."""
    planes, k = _backward_marg_inputs(xtn, lse, valid, dvalues, bufs,
                                      image_shape, stride,
                                      "gmm_fused_bwd_marg_cuda")
    device = xtn.device
    h, w = image_shape
    rec, a_full = bufs["rec"], bufs["a_full"]
    _check(rec, "rec", torch.float32, (k, REC), device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_bwd_marg(
            xtn.data_ptr(), lse.data_ptr(), valid.data_ptr(),
            dvalues.data_ptr(), rec.data_ptr(), a_full.data_ptr(),
            h, w, int(stride), h // PATCH, w // PATCH, k, planes.data_ptr(),
            stream,
        )
    _raise_on_error(lib.gmm_fused_error_string, code, "gmm_fused_bwd_marg")
    gmm_fused_bwd_marg_cuda.launches += 1
    return planes.sum(dim=0)


def gmm_fused_bwd_marg_tc_cuda(xtn, lse, valid, dvalues, bufs, image_shape,
                               stride):
    """Launch the marginalise backward kernel of the ``"split"`` mode
    (``csrc/gmm_fused_tc.cu``): its logits on the tensor cores, by the
    code of :func:`gmm_fused_fwd_marg_tc_cuda`, whose logsumexp ``lse``
    must be; returns the image gradient ``(H, W)``. Same contract as
    :func:`fused_backward_marg_plain` with ``mode="split"``."""
    grad = _launch_backward_marg_tc(xtn, lse, valid, dvalues, bufs,
                                    image_shape, stride, "split",
                                    "gmm_fused_bwd_marg_tc_cuda")
    gmm_fused_bwd_marg_tc_cuda.launches += 1
    return grad


def gmm_fused_bwd_marg_bf16_cuda(xtn, lse, valid, dvalues, bufs,
                                 image_shape, stride):
    """Launch the marginalise backward kernel of the ``"bf16"`` mode: its
    logits by the code of :func:`gmm_fused_fwd_marg_bf16_cuda`, whose
    logsumexp ``lse`` must be. Same contract as
    :func:`fused_backward_marg_plain` with ``mode="bf16"``."""
    grad = _launch_backward_marg_tc(xtn, lse, valid, dvalues, bufs,
                                    image_shape, stride, "bf16",
                                    "gmm_fused_bwd_marg_bf16_cuda")
    gmm_fused_bwd_marg_bf16_cuda.launches += 1
    return grad


def _launch_backward_marg_tc(xtn, lse, valid, dvalues, bufs, image_shape,
                             stride, mode, name):
    planes, k = _backward_marg_inputs(xtn, lse, valid, dvalues, bufs,
                                      image_shape, stride, name)
    device = xtn.device
    h, w = image_shape
    _split_tiles(bufs, device)
    _check(bufs["b_rows"], "b_rows", torch.float32, (k, D), device)
    lib = _tc_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_bwd_marg_tc(
            xtn.data_ptr(), lse.data_ptr(), valid.data_ptr(),
            dvalues.data_ptr(), bufs["pair_tc"].data_ptr(),
            bufs["bc"].data_ptr(), bufs["a_full"].data_ptr(),
            bufs["b_rows"].data_ptr(), h, w, int(stride), h // PATCH,
            w // PATCH, k, TC_PRODUCTS[mode], planes.data_ptr(), stream,
        )
    _raise_on_error(lib.gmm_fused_tc_error_string, code,
                    "gmm_fused_bwd_marg_tc")
    return planes.sum(dim=0)


def reset_counters():
    """Set every launch and call count of this module to zero."""
    for fn in (gmm_fused_fwd_cuda, gmm_fused_fwd_marg_cuda,
               gmm_fused_fwd_tc_cuda, gmm_fused_fwd_marg_tc_cuda,
               gmm_fused_fwd_bf16_cuda, gmm_fused_fwd_marg_bf16_cuda,
               gmm_fused_bwd_cuda, gmm_fused_bwd_marg_cuda,
               gmm_fused_bwd_marg_tc_cuda, gmm_fused_bwd_marg_bf16_cuda):
        fn.launches = 0
    for fn in (fused_forward_plain, fused_backward_plain,
               fused_backward_marg_plain, score_plain, score_split_plain,
               score_split_marg_plain, marg_unit_split_plain,
               score_bf16_plain, score_bf16_marg_plain,
               marg_unit_bf16_plain):
        fn.calls = 0


reset_counters()


# ----------------------------------------------------------------------
# dispatch and autograd


# the forward kernels by (marginalize, mode)
_FORWARDS = {
    (False, "f32"): gmm_fused_fwd_cuda,
    (False, "split"): gmm_fused_fwd_tc_cuda,
    (True, "f32"): gmm_fused_fwd_marg_cuda,
    (True, "split"): gmm_fused_fwd_marg_tc_cuda,
    (False, "bf16"): gmm_fused_fwd_bf16_cuda,
    (True, "bf16"): gmm_fused_fwd_marg_bf16_cuda,
}
# the marginalise backward kernels by mode
_BACKWARDS_MARG = {
    "f32": gmm_fused_bwd_marg_cuda,
    "split": gmm_fused_bwd_marg_tc_cuda,
    "bf16": gmm_fused_bwd_marg_bf16_cuda,
}


def _forward(image, bufs, stride, sentinel, marginalize, mode):
    if dispatch(image) == "kernel":
        launch = _FORWARDS[marginalize, mode]
        return launch(image, bufs, stride, sentinel)
    return fused_forward_plain(image, bufs, stride, sentinel, marginalize,
                               mode)


def _backward(xtn, argmax, valid, dvalues, bufs, image_shape, stride):
    if dispatch(xtn) == "kernel":
        return gmm_fused_bwd_cuda(xtn, argmax, valid, dvalues, bufs,
                                  image_shape, stride)
    return fused_backward_plain(xtn, argmax, valid, dvalues, bufs,
                                image_shape, stride)


def _backward_marg(xtn, lse, valid, dvalues, bufs, image_shape, stride,
                   mode):
    if dispatch(xtn) == "kernel":
        return _BACKWARDS_MARG[mode](xtn, lse, valid, dvalues, bufs,
                                     image_shape, stride)
    return fused_backward_marg_plain(xtn, lse, valid, dvalues, bufs,
                                     image_shape, stride, mode)


class _FusedScore(torch.autograd.Function):
    """Forward kernel; its backward is the MAP or the marginalise backward
    kernel.

    The backward kernels' output carries no graph, so a backward that
    builds one (``create_graph=True``, the first half of a second
    derivative) raises instead of letting the second derivative come out
    as zero. ``once_differentiable`` would not do: it only marks outputs
    when the incoming cotangent itself requires grad, and the prior's
    cotangent is a constant. Second order takes the patch-level scorer
    (``ops.gmm_pallas``) under ``config.force_fused("off")``.
    """

    @staticmethod
    def forward(ctx, image, bufs, stride, sentinel, marginalize, mode):
        values, argmax, valid, xtn = _forward(image, bufs, stride, sentinel,
                                              marginalize, mode)
        # the marginalise backward recomputes the softmax against the
        # forward's logsumexp (the values), in the forward's mode: the
        # dial may change before the backward runs; the MAP one needs
        # the argmax
        ctx.save_for_backward(xtn, values if marginalize else argmax, valid)
        ctx.bufs = bufs
        ctx.stride = stride
        ctx.marginalize = marginalize
        ctx.mode = mode
        ctx.image_shape = tuple(image.shape)
        ctx.mark_non_differentiable(argmax, valid)
        return values, argmax, valid

    @staticmethod
    def backward(ctx, dvalues, _dargmax, _dvalid):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the fused GMM scorer has no second derivative: evaluate "
                "the prior under jolideco_torch.config.force_fused('off') "
                "(TotalLoss.hessian_diagonals does)"
            )
        xtn, selector, valid = ctx.saved_tensors
        args = (xtn, selector, valid, dvalues.contiguous(), ctx.bufs,
                ctx.image_shape, ctx.stride)
        dimage = (_backward_marg(*args, ctx.mode) if ctx.marginalize
                  else _backward(*args))
        return dimage, None, None, None, None, None


def gmm_score_fused_image(normed, patch_shape, stride, bufs, sentinel,
                          marginalize=False, mode="f32"):
    """Score all overlapping patches of ``normed``: the maximum over the
    components (MAP) or their logsumexp (``marginalize``).

    Parameters
    ----------
    normed : tensor ``(..., H, W)`` float32
    patch_shape : tuple of int
    stride : int
    bufs : dict
        From :func:`kernel_buffers` on ``normed``'s device.
    sentinel : float
        Patches with a pixel at or below it are invalid.
    marginalize : bool
        Logsumexp instead of the maximum; the backward then mixes the
        components' gradients by their softmax weights.
    mode : ``"f32"``, ``"split"`` or ``"bf16"``
        The logits of the forward and of the marginalise backward
        (``config.gmm_mode()`` names the dial's).

    Returns
    -------
    values : ``(N,)`` float32, differentiable with respect to ``normed``
    argmax : ``(N,)`` int32
    valid : ``(N,)`` bool
    """
    h, w = normed.shape[-2:]
    if not fused_supported(normed.shape, patch_shape, stride, D):
        raise ValueError("fused scorer does not support this shape")
    _check_mode(mode)
    image = normed.reshape(h, w).contiguous()
    values, argmax, valid = _FusedScore.apply(
        image, bufs, int(stride), float(sentinel), bool(marginalize), mode)
    return values, argmax, valid > 0.5


def gmm_score_fused_partial_sum(normed, patch_shape, stride, bufs, sentinel,
                                n_shards, shard_index, marginalize=False,
                                mode="f32"):
    """Partial ``sum(values[valid])`` over one shard's strip block.

    The enumeration's ``H // 8`` grid rows split into ``n_shards``
    contiguous blocks whose sizes differ by at most one
    (``parallel.mesh.block``) and only block
    ``shard_index`` is scored: the kernels (or their plain versions) of
    :func:`gmm_score_fused_image` run on the image rows of the block and
    the 8 rows below it, and the extra grid row that those 8 rows add is
    dropped from the sum (it is the next block's). Every patch of the
    block lies inside those rows, and a patch runs out of the image in
    the block exactly where it does in the whole image, so the edge mask
    marks the same patches. Summed over the shards, values and gradients
    equal those of the whole image up to float32 summation order: each
    patch belongs to exactly one shard, and a shard with no grid row
    (more shards than rows) gives zero without a launch.

    Counterpart of the JAX package's
    ``ops.gmm_fused.gmm_score_fused_partial_sum``, which splits its
    folded virtual strips instead and pads their count to a multiple of
    the shards; blocks of grid rows are the port's own layout.
    """
    h, w = normed.shape[-2:]
    if not fused_supported(normed.shape, patch_shape, stride, D):
        raise ValueError("fused scorer does not support this shape")
    n_shards, shard_index = int(n_shards), int(shard_index)
    if n_shards < 1 or not 0 <= shard_index < n_shards:
        raise ValueError(
            f"shard_index {shard_index} is not one of {n_shards} shards")
    from ..parallel.mesh import block

    image = normed.reshape(h, w)
    rows = block(h // PATCH, n_shards, shard_index)
    i0, i1 = rows.start, rows.stop
    if i1 == i0:
        return image.sum() * 0.0
    strips = image[PATCH * i0:min(h, PATCH * (i1 + 1))]
    values, _, valid = gmm_score_fused_image(
        strips, patch_shape, stride, bufs, sentinel, marginalize=marginalize,
        mode=mode)
    values = torch.where(valid, values, torch.zeros_like(values))
    grid = values.reshape(len(_offsets(stride)), strips.shape[0] // PATCH,
                          -1)
    return grid[:, :i1 - i0].sum()
