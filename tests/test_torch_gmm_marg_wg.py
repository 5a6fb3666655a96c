"""K1 and K4 of every mode as the warpgroup core computes them.

``csrc/gmm_score_wg.cu`` runs the fused branch's kernels of every mode of
the precision dial on one core: K1's MAP forward, its logsumexp forward
and K4 (the marginalise backward, which recomputes K1 lse's logits by the
same instance of the core on the saved patches). ``"split"`` and
``"bf16"`` form per row ``x`` the pair products ``u = x_a x_b`` (``a <=
b``), split into bf16 hi and lo (``"split"``) or rounded to bf16
(``"bf16"``), and multiply them with the pair-major ``A``'s parts from
``pair_wg``: a chunk of 32 pairs (two k16 steps) a group, ``lo.hi, hi.lo,
hi.hi`` a step (``hi.hi`` alone for ``"bf16"``), into fresh float32 sums
that are added to the running sum, which starts at ``-2 c``; ``-2 b . x``
runs first, in four k16 steps of the six products of three-way splits.
``"f32"`` is ``tests/test_torch_gmm_marg_f32.py``'s six-product core; its
MAP instance (K1 under ``"highest"``) takes the maximum and the lowest
index among equal maxima of the same logits. This file writes that
arithmetic out in PyTorch from the kernels' own buffers (``pair_wg`` and
``lin_wg`` read back through the descriptors' address map,
``test_torch_gmm_fused_split.wg_parts``), holds it against the plain
versions, float64 and the JAX package's kernels in interpret mode (its
patch-level kernel on the rows the plain forward extracts: its fused
image scorer takes images at least 128 wide), and checks the wrappers'
routing. Tolerances, each with its reason:

- the logsumexp of ``"split"`` and ``"bf16"``: rtol 1e-5 of the plain
  version of its mode, which sums the same bf16 products in another
  float32 order, the argmax identical; against the
  float64 logsumexp (of the float32 buffers under ``"split"``, of the
  same bf16-rounded operands under ``"bf16"``) ``chip_smoke.py`` phase
  2's anchored bar (twice the plain version's error, plus 1e-6 of the
  max-abs);
- K4 of those modes fed that logsumexp: the image gradient against the
  float64 pipeline within phase 2's bar (the plain pipeline's error
  times ``2 split_lse_ratio`` under ``"split"``, ``MARG_SPLIT_FACTOR``
  under ``"bf16"``, plus 1e-6 of the max-abs);
- against the JAX package at HIGH: the logsumexp's error against float64
  at most twice the JAX kernel's plus 1e-6 of the max-abs
  (``tests/test_torch_gmm_fused_marg_split.py``'s bar), the gradient
  within 1e-4 of its max-abs (the JAX backward mixes with bf16 hi/lo
  pairs); at DEFAULT (float32 on the CPU) the JAX package's own bar for
  the mode, or the rounding single bf16 operands may cause
  (``tests/test_torch_default_dial.py``), the gradient within 2e-2;
- K1 MAP under ``"highest"``: values rtol 1e-5 of the float32 plain
  version's and of the JAX kernel's at HIGHEST (float32 sums in other
  orders), the anchored bar against float64, the argmax identical to
  both.
"""

import functools

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp
from jax import lax

import chip_smoke as cs
from jolideco_torch.ops import gmm_fused as gf
from jolideco_torch.ops.linalg import bf16_round, bf16_split, bf16_split3
from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from jolideco_tpu.priors import GaussianMixtureModel as JGMM
from test_torch_default_dial import (
    JAX_TOL,
    assert_values_near_jax,
    bf16_logits64,
)
from test_torch_gmm_fused_split import wg_parts
from test_torch_gmm_marg_f32 import (
    CASES,
    SENTINEL,
    anchored,
    fake_card,
    logits_as_the_kernel,
    make_image,
    six,
    spd_arrays,
)

torch.set_num_threads(1)
PRECISIONS = {"f32": lax.Precision.HIGHEST, "split": lax.Precision.HIGH,
              "bf16": lax.Precision.DEFAULT}
# the logsumexp against the plain version of its mode: the same bf16
# products summed in another float32 order
PLAIN_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def gmm_pair(name):
    """The JAX package's GMM and the port's buffers on the CPU:
    ``astro-snr-v1`` (one-hot weights) or a random SPD GMM of K = 256
    (mixed weights, two tiles of 200 components)."""
    if name.startswith("spd"):
        means, covariances, weights = spd_arrays(int(name[4:]))
        return (JGMM.from_numpy(means=means, covariances=covariances,
                                weights=weights),
                gmm_from_arrays(means, covariances, weights,
                                None).kernel_buffers("cpu"))
    return (JGMM.from_registry(name),
            TGMM.from_registry(name).kernel_buffers("cpu"))


@functools.lru_cache(maxsize=None)
def plain_case(name, shape, stride, mode, marginalize):
    """The plain forward of ``mode`` on the seeded image: values,
    argmax, valid, xtn."""
    _, bufs = gmm_pair(name)
    return gf.fused_forward_plain(make_image(shape), bufs, stride, SENTINEL,
                                  marginalize, mode=mode)


@functools.lru_cache(maxsize=None)
def jax_case(name, shape, stride, mode, marginalize):
    """The JAX package's patch-level kernels (interpreted) at the mode's
    precision on the plain forward's rows: values, argmax and, when
    marginalising, the gradient of ``sum(dv * values)`` with respect to
    the rows."""
    gmm_j, _ = gmm_pair(name)
    vp, _, valp, xp = plain_case(name, shape, stride, mode, marginalize)
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def score(x):
        return gmm_score_pallas(x, *args, True, precision=PRECISIONS[mode],
                                marginalize=marginalize)

    rows = jnp.asarray(xp.numpy())
    values, argmax = (torch.as_tensor(np.array(a)) for a in score(rows))
    if not marginalize:
        return values, argmax, None
    dv = jnp.asarray(cotangents(valp).numpy())
    grad = jax.grad(lambda x: jnp.sum(dv * score(x)[0]))(rows)
    return values, argmax, torch.as_tensor(np.array(grad))


def cotangents(valid):
    """Seeded cotangents of the patches' values, zero where invalid."""
    return torch.as_tensor(np.random.RandomState(2).randn(len(valid)),
                           dtype=torch.float32) * valid


def logits_wg(x, bufs, products):
    """The logits ``(n, K)`` of rows ``x (n, 64)`` as the ``"split"``
    (``products`` 3) or ``"bf16"`` (1) core computes them: the running
    float32 sum from ``-2 c``, then ``-2 b . x`` in four k16 steps of six
    products (:func:`six`), then per chunk of 32 pairs its two k16 steps'
    products (``lo.hi``, ``hi.lo``, ``hi.hi`` a step, or ``hi.hi``) into a
    fresh float32 sum added to the running one; times ``-1/2``."""
    k = bufs["b_rows"].shape[0]
    parts, b3, c = (torch.as_tensor(np.ascontiguousarray(a))
                    for a in wg_parts(bufs))
    a_hi, a_lo = parts[0].T, parts[1].T
    lin3 = [b3[i].T for i in range(3)]
    acc = (-2.0 * c).expand(x.shape[0], -1)
    xp = bf16_split3(x)
    for s in range(gf.D // 16):
        acc = acc + six(xp, lin3, 16 * s)
    u = x[:, gf.PAIR_A] * x[:, gf.PAIR_B]
    u_hi, u_lo = bf16_split(u) if products == 3 else (bf16_round(u), None)
    for chunk in range(gf.WG_CHUNKS):
        t = None
        for step in (2 * chunk, 2 * chunk + 1):
            sl = slice(16 * step, 16 * step + 16)
            terms = ([u_lo[:, sl] @ a_hi[sl], u_hi[:, sl] @ a_lo[sl],
                      u_hi[:, sl] @ a_hi[sl]] if products == 3
                     else [u_hi[:, sl] @ a_hi[sl]])
            for term in terms:
                t = term if t is None else t + term
        acc = acc + t
    return (-0.5 * acc)[:, :k]


def k4_from_logits(logits, xtn, lse, valid, dv, bufs, shape, stride):
    """K4 as the kernel computes it from its recomputed ``logits``: the
    weights ``exp(logit - lse)`` (0 for an invalid patch), ``g = sum_k
    w_k (b_k - A_k x)`` in float32, ``u = dv g / sum w``, then the mean
    subtracted and the overlap-add."""
    live = valid > 0.5
    w = torch.exp(logits - lse[:, None])
    w = torch.where(live[:, None], w, torch.zeros_like(w))
    g = w @ bufs["b_rows"] - gf.mix_rows(w, xtn, bufs)
    u = dv[:, None] * g / w.sum(dim=1, keepdim=True)
    u = torch.where(live[:, None], u, torch.zeros_like(u))
    return gf._patches_to_image(u, valid, shape, stride)


def float64_pipeline(xp, valp, dv, bufs, shape, stride, mode):
    """The float64 logsumexp and image gradient of rows ``xp``: the
    logits of the float32 buffers (``"split"``), or the exact sums of the
    same bf16-rounded operands (``"bf16"``, ``chip_smoke.bf16_reference``)."""
    if mode == "bf16":
        ref = cs.bf16_reference(torch, xp, bufs)
        grad = gf._patches_to_image(ref["unit"] * dv.double()[:, None],
                                    valp.double(), shape, stride)
        return ref["lse"], grad
    b64 = {name: t.double() for name, t in bufs.items()}
    x64 = xp.double()
    lse64, _ = gf.score_plain(x64, b64["aq"], b64["bq"], b64["const2"], True)
    grad = gf.fused_backward_marg_plain(x64, lse64, valp.double(),
                                        dv.double(), b64, shape, stride)
    return lse64, grad


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("shape,stride", CASES)
@pytest.mark.parametrize("name", ["astro-snr-v1", "spd-256"])
def test_split_and_bf16_cores_match_float64_and_jax(name, shape, stride,
                                                    mode):
    """K1 lse and K4 of ``"split"`` and ``"bf16"`` as the core computes
    them against the plain versions of the mode, the float64 pipeline and
    the JAX package's kernels at HIGH or DEFAULT."""
    _, bufs = gmm_pair(name)
    vp, ap, valp, xp = plain_case(name, shape, stride, mode, True)
    m = valp > 0.5
    assert 0 < int(m.sum()) < len(m)
    logits = logits_wg(xp, bufs, gf.TC_PRODUCTS[mode])
    lse = torch.logsumexp(logits, dim=1)
    argmax = torch.max(logits, dim=1).indices.to(torch.int32)
    assert_allclose(lse[m].numpy(), vp[m].numpy(), rtol=PLAIN_RTOL)
    assert_array_equal(argmax[m].numpy(), ap[m].numpy())

    dv = cotangents(valp)
    lse64, g64 = float64_pipeline(xp, valp, dv, bufs, shape, stride, mode)
    anchored(lse[m], vp[m], lse64[m])
    grad = k4_from_logits(logits, xp, lse, valp, dv, bufs, shape, stride)
    g32 = gf.fused_backward_marg_plain(xp, vp, valp, dv, bufs, shape, stride,
                                       mode)
    errs = {key: float((v[m].double() - lse64[m]).abs().max())
            for key, v in (("tc", lse), ("split_plain", vp))}
    factor = (cs.MARG_SPLIT_FACTOR if mode == "bf16"
              else cs.MARG_ERR_FACTOR * cs.split_lse_ratio(errs))
    err = float((grad.double() - g64).abs().max())
    err32 = float((g32.double() - g64).abs().max())
    scale = float(g64.abs().max())
    assert err <= factor * err32 + cs.MARG_ERR_FLOOR * scale, (err, err32)

    vj, aj, rows_j = jax_case(name, shape, stride, mode, True)
    grad_j = gf._patches_to_image(rows_j, valp, shape, stride)
    if mode == "split":
        err_j = float((vj[m].double() - lse64[m]).abs().max())
        assert errs["tc"] <= 2 * err_j + 1e-6 * float(lse64[m].abs().max())
        tol = 1e-4
    else:
        _, size = bf16_logits64(xp[m], bufs)
        rounding = size.gather(1, argmax[m].long()[:, None])[:, 0].numpy()
        assert_values_near_jax(lse[m].numpy(), argmax[m].numpy(),
                               vj[m].numpy(), aj[m].numpy(), rounding)
        tol = JAX_TOL
    assert_allclose(grad.numpy(), grad_j.numpy(), rtol=0,
                    atol=tol * float(grad_j.abs().max()))


@pytest.mark.parametrize("shape,stride", CASES)
@pytest.mark.parametrize("name", ["astro-snr-v1", "spd-256"])
def test_six_product_map_matches_float64_and_jax(name, shape, stride):
    """K1 MAP under ``"highest"`` as the six-product core computes it
    (the maximum and argmax of ``logits_as_the_kernel``'s logits)
    against the float32 plain version, float64 and the JAX package's
    HIGHEST kernel."""
    _, bufs = gmm_pair(name)
    vp, ap, valp, xp = plain_case(name, shape, stride, "f32", False)
    m = valp > 0.5
    values, argmax = torch.max(logits_as_the_kernel(xp, bufs), dim=1)
    argmax = argmax.to(torch.int32)
    b64 = {key: t.double() for key, t in bufs.items()}
    v64, a64 = gf.score_plain(xp.double(), b64["aq"], b64["bq"],
                              b64["const2"])
    anchored(values[m], vp[m], v64[m])
    vj, aj, _ = jax_case(name, shape, stride, "f32", False)
    for want in (vp, vj):
        assert_allclose(values[m].numpy(), want[m].numpy(), rtol=1e-5)
    for want in (ap, aj, a64):
        assert_array_equal(argmax[m].numpy(), want[m].numpy())


def test_highest_map_routes_to_the_six_product_core(monkeypatch):
    """On a card, K1 MAP under ``"f32"`` launches ``gmm_score_wg_image``
    with six products, ``pair_wg3`` and ``lin_wg``, and counts it
    (:func:`fake_card`)."""
    calls = fake_card(monkeypatch)
    bufs = TGMM.from_registry("astro-snr-v1").kernel_buffers("cpu")
    gf.reset_counters()
    gf.gmm_score_fused_image(make_image((24, 40)), (8, 8), 8, bufs, SENTINEL,
                             mode="f32")
    assert [c[:2] for c in calls] == [("gmm_score_wg", "gmm_score_wg_image")]
    assert calls[0][2][1:11] == (24, 40, 8, 3, 5, SENTINEL,
                                 bufs["pair_wg3"].data_ptr(),
                                 bufs["lin_wg"].data_ptr(), 200, 6)
    assert gf.gmm_fused_fwd_cuda.launches == 1
    assert gf.fused_forward_plain.calls == 0


@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_split_and_bf16_marginalise_route_to_the_warpgroup_kernels(
        monkeypatch, mode):
    """On a card, ``"split"`` and ``"bf16"`` marginalise through
    ``gmm_score_wg``'s entries with three or one products and
    ``pair_wg``: K1 lse on the image, then K4 on K1's patches, logsumexp
    and validity, one CTA a tile of 128 rows up to the SMs; each wrapper
    counts its launch."""
    calls = fake_card(monkeypatch)
    bufs = TGMM.from_registry("astro-snr-v1").kernel_buffers("cpu")
    gf.reset_counters()
    x = make_image((24, 40)).requires_grad_(True)
    values, _, valid = gf.gmm_score_fused_image(
        x, (8, 8), 8, bufs, SENTINEL, marginalize=True, mode=mode)
    torch.where(valid, values, torch.zeros_like(values)).sum().backward()
    assert [c[:2] for c in calls] == [
        ("gmm_score_wg", "gmm_score_wg_image_lse"),
        ("gmm_score_wg", "gmm_score_wg_mix")]
    fwd, bwd = (c[2] for c in calls)
    products = gf.TC_PRODUCTS[mode]
    assert fwd[7:11] == (bufs["pair_wg"].data_ptr(),
                         bufs["lin_wg"].data_ptr(), 200, products)
    assert (bwd[0], bwd[1], bwd[2]) == (fwd[14], fwd[11], fwd[13])
    assert bwd[4:8] == tuple(bufs[key].data_ptr() for key in (
        "pair_wg", "lin_wg", "a_full", "b_rows"))
    assert bwd[8:15] == (24, 40, 8, 3, 5, 200, products)
    assert bwd[16] == 1  # 15 patches: one tile of rows
    fwd_name, bwd_name = cs.MARG_KERNELS[mode]
    for name in (fwd_name, bwd_name):
        assert getattr(gf, name + "_cuda").launches == 1
    assert gf.fused_forward_plain.calls == 0
    assert gf.fused_backward_marg_plain.calls == 0


def test_split_marginalise_raises_where_a_launch_fails(monkeypatch):
    """A kernel that reports an error raises: nothing falls back to the
    plain versions."""
    fake_card(monkeypatch, code=1)
    bufs = TGMM.from_registry("astro-snr-v1").kernel_buffers("cpu")
    gf.reset_counters()
    with pytest.raises(RuntimeError, match="gmm_score_wg_image_lse"):
        gf.gmm_score_fused_image(make_image((24, 40)), (8, 8), 8, bufs,
                                 SENTINEL, marginalize=True, mode="split")
    assert gf.fused_forward_plain.calls == 0
