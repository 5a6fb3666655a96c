"""Fused patch extraction + GMM MAP scoring, forward and backward.

Counterpart of the JAX package's ``ops/gmm_fused.py``. One pass takes an
image to per-patch GMM scores:

    image -> offset-group patches -> zero-flux mask -> mean subtraction
          -> logits -1/2 x^T A_k x + b_k . x + c_k -> max / argmax (MAP)

and the backward takes the per-patch cotangents back to the image:
``dv (b_{k*} - A_{k*} x)``, the transpose of the mean subtraction and
the mask, then back to image layout per offset group.

Each direction has two implementations with one contract:

- a CUDA kernel written by hand for Hopper (``csrc/gmm_fused.cu``,
  whose header says what bounds it and how it is built), run for a
  tensor on a CUDA card;
- a plain PyTorch version (``*_plain``), run for a tensor on the CPU,
  and the reference the kernel is checked against on the card.

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
contract and are not ported. Only the MAP (max) reduction is ported;
the marginalise backward is still to come.
"""

import ctypes

import numpy as np
import torch

from ..config import dispatch

__all__ = [
    "fused_patch_count",
    "fused_supported",
    "gmm_fused_bwd_cuda",
    "gmm_fused_fwd_cuda",
    "fused_backward_plain",
    "fused_forward_plain",
    "gmm_score_fused_image",
    "kernel_buffers",
    "reset_counters",
    "score_plain",
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


def kernel_buffers(packed, device):
    """Device tensors for both implementations from ``pack_gmm_buffers``.

    ``aq (d*d, K)``, ``bq (d, K)``, ``const2 (K,)`` feed the plain
    scorer. For 8x8 patches also ``rec (K, REC)`` for the CUDA forward and
    ``a_full (K, 64, 64)``, ``b_rows (K, 64)`` for both backwards.
    """
    aq = np.asarray(packed["aq"], np.float32)
    bq = np.asarray(packed["bq"], np.float32)
    const2 = np.asarray(packed["const2"], np.float32).reshape(-1)
    arrays = {"aq": aq, "bq": bq, "const2": const2}
    d, k = bq.shape
    if d == D:
        rec = np.zeros((k, REC), np.float32)
        rec[:, :SYM] = _sym_rows(np.asarray(packed["a_quad"], np.float64))
        rec[:, SYM:SYM + D] = bq.T
        rec[:, SYM + D] = const2
        arrays.update(rec=rec, a_full=aq.T.reshape(k, D, D), b_rows=bq.T)
    return {
        name: torch.as_tensor(np.ascontiguousarray(a)).to(device)
        for name, a in arrays.items()
    }


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


def score_plain(xtn, aq, bq, const2):
    """MAP scores of normalised patches ``(n, d)``: values and argmax.

    The quadratic form runs as a chunked ``(n, d*d) @ (d*d, K)`` matmul
    so that memory stays bounded; argmax is the lowest index among equal
    maxima (``torch.max`` returns the first). Differentiable through
    torch autograd.
    """
    score_plain.calls += 1
    values, argmax = [], []
    d = xtn.shape[1]
    for start in range(0, xtn.shape[0], PLAIN_CHUNK):
        x = xtn[start:start + PLAIN_CHUNK]
        u = (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], d * d)
        logits = -0.5 * (u @ aq) + x @ bq + const2
        v, k = torch.max(logits, dim=1)
        values.append(v)
        argmax.append(k.to(torch.int32))
    return torch.cat(values), torch.cat(argmax)


def fused_forward_plain(image, bufs, stride, sentinel):
    """Plain version of the forward kernel.

    Returns ``(values (N,), argmax (N,) int32, valid (N,) float32,
    xtn (N, 64))`` with ``xtn`` the masked, mean-subtracted patches.
    """
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
    values, argmax = score_plain(xtn, bufs["aq"], bufs["bq"], bufs["const2"])
    return values, argmax, valid.to(torch.float32), xtn


def fused_backward_plain(xtn, argmax, valid, dvalues, bufs, image_shape,
                         stride):
    """Plain version of the backward kernel: the image gradient ``(H, W)``."""
    fused_backward_plain.calls += 1
    a_full, b_rows = bufs["a_full"], bufs["b_rows"]
    units = []
    for start in range(0, xtn.shape[0], PLAIN_CHUNK):
        sl = slice(start, start + PLAIN_CHUNK)
        k = argmax[sl].long()
        ax = torch.einsum("nrc,nc->nr", a_full[k], xtn[sl])
        units.append(dvalues[sl, None] * (b_rows[k] - ax))
    u = torch.cat(units)
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


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library("gmm_fused")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gmm_fused_fwd.argtypes = [vp, ci, ci, ci, ci, ci, cf, vp, ci,
                                      vp, vp, vp, vp, vp]
        lib.gmm_fused_fwd.restype = ci
        lib.gmm_fused_bwd.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                      ci, ci, vp, vp]
        lib.gmm_fused_bwd.restype = ci
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


def _raise_on_error(lib, code, kernel):
    if code != 0:
        msg = lib.gmm_fused_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")


def _check_geometry(image, stride):
    h, w = image.shape
    if PATCH % stride != 0 or h < PATCH or w < PATCH:
        raise ValueError(
            f"fused kernels need stride | 8 and an image of at least 8x8, "
            f"got stride {stride} and shape {(h, w)}"
        )


def gmm_fused_fwd_cuda(image, bufs, stride, sentinel):
    """Launch the forward kernel on ``image (H, W)`` float32 on a card.

    Same outputs as :func:`fused_forward_plain`.
    """
    device = image.device
    if device.type != "cuda":
        raise ValueError(f"gmm_fused_fwd_cuda needs a CUDA tensor, got {device}")
    _check_geometry(image, stride)
    h, w = image.shape
    ny, nx = h // PATCH, w // PATCH
    n = fused_patch_count((h, w), stride)
    rec = bufs["rec"]
    k = rec.shape[0]
    _check(image, "image", torch.float32, (h, w), device)
    _check(rec, "rec", torch.float32, (k, REC), device)

    values = torch.empty(n, dtype=torch.float32, device=device)
    argmax = torch.empty(n, dtype=torch.int32, device=device)
    valid = torch.empty(n, dtype=torch.float32, device=device)
    xtn = torch.empty((n, D), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_fwd(
            image.data_ptr(), h, w, int(stride), ny, nx,
            float(sentinel), rec.data_ptr(), k, values.data_ptr(),
            argmax.data_ptr(), valid.data_ptr(), xtn.data_ptr(), stream,
        )
    _raise_on_error(lib, code, "gmm_fused_fwd")
    gmm_fused_fwd_cuda.launches += 1
    return values, argmax, valid, xtn


def gmm_fused_bwd_cuda(xtn, argmax, valid, dvalues, bufs, image_shape,
                       stride):
    """Launch the backward kernel; returns the image gradient ``(H, W)``.

    The kernel writes each offset group into its own zero-filled
    ``(H, W)`` plane (plain stores, deterministic); the planes are
    summed here.
    """
    device = xtn.device
    if device.type != "cuda":
        raise ValueError(f"gmm_fused_bwd_cuda needs a CUDA tensor, got {device}")
    h, w = image_shape
    ny, nx = h // PATCH, w // PATCH
    n_groups = len(_offsets(stride))
    n = n_groups * ny * nx
    a_full, b_rows = bufs["a_full"], bufs["b_rows"]
    k = a_full.shape[0]
    _check(xtn, "xtn", torch.float32, (n, D), device)
    _check(argmax, "argmax", torch.int32, (n,), device)
    _check(valid, "valid", torch.float32, (n,), device)
    _check(dvalues, "dvalues", torch.float32, (n,), device)
    _check(a_full, "a_full", torch.float32, (k, D, D), device)
    _check(b_rows, "b_rows", torch.float32, (k, D), device)

    planes = torch.zeros((n_groups, h, w), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gmm_fused_bwd(
            xtn.data_ptr(), argmax.data_ptr(), valid.data_ptr(),
            dvalues.data_ptr(), a_full.data_ptr(), b_rows.data_ptr(),
            h, w, int(stride), ny, nx, planes.data_ptr(), stream,
        )
    _raise_on_error(lib, code, "gmm_fused_bwd")
    gmm_fused_bwd_cuda.launches += 1
    return planes.sum(dim=0)


def reset_counters():
    """Set every launch and call count of this module to zero."""
    for fn in (gmm_fused_fwd_cuda, gmm_fused_bwd_cuda, fused_forward_plain,
               fused_backward_plain, score_plain):
        if hasattr(fn, "launches"):
            fn.launches = 0
        else:
            fn.calls = 0


gmm_fused_fwd_cuda.launches = 0
gmm_fused_bwd_cuda.launches = 0
fused_forward_plain.calls = 0
fused_backward_plain.calls = 0
score_plain.calls = 0


# ----------------------------------------------------------------------
# dispatch and autograd


def _forward(image, bufs, stride, sentinel):
    if dispatch(image) == "kernel":
        return gmm_fused_fwd_cuda(image, bufs, stride, sentinel)
    return fused_forward_plain(image, bufs, stride, sentinel)


def _backward(xtn, argmax, valid, dvalues, bufs, image_shape, stride):
    if dispatch(xtn) == "kernel":
        return gmm_fused_bwd_cuda(xtn, argmax, valid, dvalues, bufs,
                                  image_shape, stride)
    return fused_backward_plain(xtn, argmax, valid, dvalues, bufs,
                                image_shape, stride)


class _FusedScore(torch.autograd.Function):
    """Forward kernel; its backward is the backward kernel."""

    @staticmethod
    def forward(ctx, image, bufs, stride, sentinel):
        values, argmax, valid, xtn = _forward(image, bufs, stride, sentinel)
        ctx.save_for_backward(xtn, argmax, valid)
        ctx.bufs = bufs
        ctx.stride = stride
        ctx.image_shape = tuple(image.shape)
        ctx.mark_non_differentiable(argmax, valid)
        return values, argmax, valid

    @staticmethod
    def backward(ctx, dvalues, _dargmax, _dvalid):
        xtn, argmax, valid = ctx.saved_tensors
        dimage = _backward(xtn, argmax, valid, dvalues.contiguous(),
                           ctx.bufs, ctx.image_shape, ctx.stride)
        return dimage, None, None, None


def gmm_score_fused_image(normed, patch_shape, stride, bufs, sentinel):
    """Score all overlapping patches of ``normed`` (MAP max over K).

    Parameters
    ----------
    normed : tensor ``(..., H, W)`` float32
    patch_shape : tuple of int
    stride : int
    bufs : dict
        From :func:`kernel_buffers` on ``normed``'s device.
    sentinel : float
        Patches with a pixel at or below it are invalid.

    Returns
    -------
    values : ``(N,)`` float32, differentiable with respect to ``normed``
    argmax : ``(N,)`` int32
    valid : ``(N,)`` bool
    """
    h, w = normed.shape[-2:]
    if not fused_supported(normed.shape, patch_shape, stride, D):
        raise ValueError("fused scorer does not support this shape")
    image = normed.reshape(h, w).contiguous()
    values, argmax, valid = _FusedScore.apply(image, bufs, int(stride),
                                              float(sentinel))
    return values, argmax, valid > 0.5
