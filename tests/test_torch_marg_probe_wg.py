"""K5 lse, K8 and K9a of every mode as the warpgroup core computes them.

The marginalised flux-error probe scores its rows with K5's logsumexp,
then takes the unit gradient (K8) and the first stage of the Hessian
action (K9a) against that logsumexp. On the card the three are one
instance of ``csrc/gmm_score_wg.cu``'s core a mode (six, three or one
bf16 products a k16 step: ``"f32"``, ``"split"``, ``"bf16"``) on the
same rows, only their epilogues differ, so K8 and K9a recompute the
logits K5 lse summed bit for bit. This file writes that arithmetic out
in PyTorch from the kernels' own buffers: the logits as
``tests/test_torch_gmm_marg_f32.py`` (``"f32"``) and
``tests/test_torch_gmm_marg_wg.py`` (the bf16 modes) write them; the
weights ``w = exp(logit - lse)``; K8's ``sum_k w_k (b_k - A_k x) / sum_k
w_k`` in float32; K9a's ``g_k = t . (b_k - A_k x)`` in float32, taken
against the heaviest component's ``g`` (the first of equal weights),
``p = w / sum w`` and ``dp = p (g - g_ref - gbar)``, 0 where ``w`` is 0.
It holds them against the plain versions of the mode, against float64
and against the JAX package's gradient and Hessian action in interpret
mode, and checks the wrappers' routing. Rows: the probe's rows of a
random 32 x 48 image (96 grouped patches, mean-subtracted, two zeroed
as masked patches). GMMs: ``astro-snr-v1`` (one-hot weights), random
SPD GMMs of K = 13 (mixed weights) and K = 256 (mixed, two of the
core's tiles of 200 components). Tolerances, each with its reason:

- K5 lse: rtol 1e-5 of the plain version of its mode (the same products
  summed in another float32 order), argmax identical; against float64
  ``chip_smoke.py`` phase 2's anchored bar (twice the plain version's
  error plus 1e-6 of the max-abs);
- K8, K9a's p and dp and K9b on K9a's weights, fed K5 lse's logsumexp,
  against the float64 pipeline (the exact logits of the float32 buffers,
  or under ``"bf16"`` the exact sums of the same bf16-rounded operands,
  ``chip_smoke.bf16_reference``): within the mode's factor times the
  plain pipeline's error plus 1e-6 of the max-abs (``"f32"``: phase 2's
  factor 2; the bf16 modes: ``chip_smoke.MARG_SPLIT_FACTOR``, the bar of
  ``chip_smoke.probe_split_compare``), an entry of dp also within its
  own float32 rounding (``chip_smoke.dp_rounding``);
- on a row whose weight sits on one component p is exactly 1 there and
  dp exactly 0 (the kernels' rule);
- against the JAX package's patch-level kernels in interpret mode (the
  gradient of ``sum(values)`` and its JVP along a random tangent) at
  HIGHEST and HIGH: 1e-4 of their max-abs (``tests/test_torch_marginalise.py``'s
  and ``tests/test_torch_marg_probe_split.py``'s bar; the JAX kernels
  mix with bf16 hi/lo parts); at DEFAULT, which JAX runs in float32 on
  the CPU: ``tests/test_torch_default_dial.py``'s ``JAX_TOL``. The JAX
  reference runs for the mixed K = 13 GMM only, where p and dp are not
  one-hot (about 7 s a precision).
"""

import contextlib
import functools
import types

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import chip_smoke as cs
from jolideco_torch.ops import gmm_fused as gf
from jolideco_torch.ops import gmm_pallas as gp
from jolideco_torch.ops.patches import view_as_overlapping_patches_grouped
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from test_torch_default_dial import JAX_TOL
from test_torch_gmm_marg_f32 import FakeLibrary, logits_as_the_kernel
from test_torch_gmm_marg_wg import (
    PLAIN_RTOL,
    PRECISIONS,
    gmm_pair,
    logits_wg,
)

torch.set_num_threads(1)
NAMES = ["astro-snr-v1", "spd-13", "spd-256"]
# the factor on the plain pipeline's error against float64, by mode
FACTORS = {"f32": cs.MARG_ERR_FACTOR, "split": cs.MARG_SPLIT_FACTOR,
           "bf16": cs.MARG_SPLIT_FACTOR}
# the plain versions of each mode: K5 lse, K8, K9a
PLAIN = {
    "f32": (lambda x, b: gp.score_rows_plain(x, b, True),
            gp.unit_marg_plain, gp.hvp_marg_weights_plain),
    "split": (gf.score_split_marg_plain, gf.marg_unit_split_plain,
              gp.hvp_marg_weights_split_plain),
    "bf16": (gf.score_bf16_marg_plain, gf.marg_unit_bf16_plain,
             gp.hvp_marg_weights_bf16_plain),
}


@functools.lru_cache(maxsize=None)
def probe_rows():
    """The probe's rows of a random 32 x 48 image (96 grouped patches,
    mean-subtracted; rows 0 and 61 zeroed as masked patches) and a
    seeded tangent."""
    img = np.random.RandomState(3).uniform(0.1, 2.0, (32, 48))
    patches = view_as_overlapping_patches_grouped(
        torch.as_tensor(img, dtype=torch.float32), (8, 8), 4)
    x = patches - patches.mean(dim=1, keepdim=True)
    x[::61] = 0.0
    t = torch.as_tensor(np.random.RandomState(5).randn(*x.shape),
                        dtype=torch.float32)
    return x.contiguous(), t


def core_logits(x, bufs, mode):
    """The logits ``(n, K)`` of rows ``x`` as the core of ``mode``
    computes them."""
    if mode == "f32":
        return logits_as_the_kernel(x, bufs)
    return logits_wg(x, bufs, gf.TC_PRODUCTS[mode])


def k8_as_the_kernel(x, lse, bufs, logits):
    """K8 from the core's ``logits`` and K5 lse's ``lse``: ``g = sum_k
    w_k (b_k - A_k x)`` in float32, times ``1 / sum w``."""
    w = torch.exp(logits - lse[:, None])
    g = w @ bufs["b_rows"] - gf.mix_rows(w, x, bufs)
    return g * (1.0 / w.sum(dim=1, keepdim=True))


def k9a_as_the_kernel(x, t, lse, bufs, logits):
    """K9a from the core's ``logits`` and K5 lse's ``lse``: ``g_k = t .
    (b_k - A_k x)`` in float32, against the heaviest component's (the
    first of equal weights); ``p = w / sum w``, ``dp = p (g - g_ref -
    gbar)`` with ``gbar = sum_k p_k (g_k - g_ref)`` over the nonzero
    weights, 0 where ``w`` is 0; ``(K, N)`` each."""
    w = torch.exp(logits - lse[:, None])
    ax = torch.einsum("krc,nc->nkr", bufs["a_full"], x)
    g = ((bufs["b_rows"][None] - ax) * t[:, None, :]).sum(dim=2)
    g_ref = g.gather(1, w.argmax(dim=1, keepdim=True))
    live = w != 0
    inv = 1.0 / w.sum(dim=1, keepdim=True)
    gbar = torch.where(live, w * (g - g_ref), 0.0).sum(dim=1,
                                                        keepdim=True) * inv
    p = w * inv
    dp = torch.where(live, p * ((g - g_ref) - gbar), 0.0)
    return p.T.contiguous(), dp.T.contiguous()


def core_probe(name, mode):
    """K5 lse, K8 and K9a of ``mode`` as the core computes them on the
    probe's rows: lse, argmax, unit, p, dp."""
    _, bufs = gmm_pair(name)
    x, t = probe_rows()
    logits = core_logits(x, bufs, mode)
    lse = torch.logsumexp(logits, dim=1)
    argmax = torch.max(logits, dim=1).indices.to(torch.int32)
    unit = k8_as_the_kernel(x, lse, bufs, logits)
    p, dp = k9a_as_the_kernel(x, t, lse, bufs, logits)
    return lse, argmax, unit, p, dp


def float64_pipeline(x, t, bufs, mode):
    """The float64 probe of rows ``x`` along ``t``: lse, unit, p, dp."""
    if mode == "bf16":
        ref = cs.bf16_reference(torch, x, bufs, t)
        return ref["lse"], ref["unit"], ref["p"], ref["dp"]
    b64 = {key: v.double() for key, v in bufs.items()}
    x64, t64 = x.double(), t.double()
    lse64, _ = gp.score_rows_plain(x64, b64, True)
    p64, dp64 = gp.hvp_marg_weights_plain(x64, t64, lse64, b64)
    return lse64, gp.unit_marg_plain(x64, lse64, b64), p64, dp64


@pytest.mark.parametrize("mode", gf.MODES)
@pytest.mark.parametrize("name", NAMES)
def test_probe_core_matches_plain_and_float64(name, mode):
    """K5 lse, K8, K9a and K9b on K9a's weights as the core of ``mode``
    computes them, against the plain versions of the mode and float64;
    one-hot rows give p = 1 and dp = 0 exactly."""
    _, bufs = gmm_pair(name)
    x, t = probe_rows()
    lse, argmax, unit, p, dp = core_probe(name, mode)
    score, unit_plain, weights_plain = PLAIN[mode]
    lse_p, argmax_p = score(x, bufs)
    assert_allclose(lse.numpy(), lse_p.numpy(), rtol=PLAIN_RTOL)
    assert_array_equal(argmax.numpy(), argmax_p.numpy())
    p_p, dp_p = weights_plain(x, t, lse_p, bufs)
    plain = {"unit": unit_plain(x, lse_p, bufs), "p": p_p, "dp": dp_p,
             "hvp": gp.hvp_marg_mix_plain(x, t, p_p, dp_p, bufs)}
    got = {"unit": unit, "p": p, "dp": dp,
           "hvp": gp.hvp_marg_mix_plain(x, t, p, dp, bufs)}

    lse64, unit64, p64, dp64 = float64_pipeline(x, t, bufs, mode)
    b64 = {key: v.double() for key, v in bufs.items()}
    ref = {"unit": unit64, "p": p64, "dp": dp64,
           "hvp": gp.hvp_marg_mix_plain(x.double(), t.double(), p64, dp64,
                                        b64)}
    err = float((lse.double() - lse64).abs().max())
    err32 = float((lse_p.double() - lse64).abs().max())
    assert err <= 2.0 * err32 + 1e-6 * float(lse64.abs().max()), (err, err32)
    floor, _ = cs.dp_rounding(torch, x.double(), b64, p64, dp64)
    for key, want in ref.items():
        diff = (got[key].double() - want).abs()
        if key == "dp":
            diff = torch.where(diff <= floor, 0.0, diff)
        err32 = float((plain[key].double() - want).abs().max())
        limit = (FACTORS[mode] * err32
                 + cs.MARG_ERR_FLOOR * float(want.abs().max()))
        assert float(diff.max()) <= limit, (key, float(diff.max()), limit)

    one_hot = (p != 0).sum(dim=0) == 1
    if name == "astro-snr-v1":
        assert int(one_hot.sum()) >= 0.9 * len(x)
    else:
        # the mixture runs: most rows weigh several components
        assert int(one_hot.sum()) < 0.5 * len(x)
    rows = one_hot.nonzero()[:, 0]
    assert bool((p[argmax[rows].long(), rows] == 1.0).all())
    assert bool((dp[:, one_hot] == 0).all())
    assert_allclose(p.sum(dim=0).numpy(), 1.0, rtol=1e-6)


def test_wide_gmm_wins_in_both_tiles():
    """Under the K = 256 GMM both of the core's tiles of 200 components
    hold rows' heaviest components (the carry across tiles runs)."""
    _, argmax, _, p, _ = core_probe("spd-256", "split")
    assert 0 < int((argmax >= gf.KP_WG).sum()) < len(argmax)
    assert bool((p[gf.KP_WG:] > 0).any() and (p[:gf.KP_WG] > 0).any())


@functools.lru_cache(maxsize=None)
def jax_probe(name, mode):
    """The JAX package's gradient of ``sum(values)`` and its JVP along the
    tangent, its patch-level kernels in interpret mode at the mode's
    precision (one trace for both)."""
    gmm_j, _ = gmm_pair(name)
    x, t = probe_rows()
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def total(v):
        return jnp.sum(gmm_score_pallas(v, *args, True, PRECISIONS[mode],
                                        True)[0])

    grad, hvp = jax.jvp(jax.grad(total), (jnp.asarray(x.numpy()),),
                        (jnp.asarray(t.numpy()),))
    return np.asarray(grad), np.asarray(hvp)


@pytest.mark.parametrize("mode", gf.MODES)
def test_probe_core_matches_jax(mode):
    """The gradient (K8, fed K5 lse) and the Hessian action (K9b on
    K9a's weights) as the core of ``mode`` computes them, against the
    JAX package's kernels at HIGHEST, HIGH or DEFAULT, where the weights
    are mixed (K = 13)."""
    _, bufs = gmm_pair("spd-13")
    x, t = probe_rows()
    _, _, unit, p, dp = core_probe("spd-13", mode)
    hvp = gp.hvp_marg_mix_plain(x, t, p, dp, bufs)
    grad_j, hvp_j = jax_probe("spd-13", mode)
    tol = JAX_TOL if mode == "bf16" else 1e-4
    for got, want in ((unit.numpy(), grad_j), (hvp.numpy(), hvp_j)):
        assert_allclose(got, want, rtol=0,
                        atol=tol * float(np.abs(want).max()))


def fake_card(monkeypatch, code=0):
    """Recorded stand-ins for ``gmm_pallas``' kernel libraries, the
    dispatch and the wrappers' CUDA checks lifted, so that a CPU tensor
    stands for a card's (132 SMs); returns the list the calls go to."""
    calls = []
    monkeypatch.setattr(gp, "_wg_library",
                        lambda: FakeLibrary("gmm_score_wg", calls, code))
    monkeypatch.setattr(gp, "_library",
                        lambda: FakeLibrary("gmm_patch", calls, code))
    monkeypatch.setattr(gp, "dispatch", lambda t: "kernel")
    monkeypatch.setattr(gp, "_check_rows",
                        lambda x, name, argmax=None: (x.device, x.shape[0]))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


def probe_through_autograd(bufs, mode, n=300):
    """The marginalised patch scorer's gradient and Hessian action on
    ``n`` zero rows, as the probe runs them (autograd's rules)."""
    x = torch.zeros((n, 64), requires_grad=True)
    values, _ = gp.gmm_score_patches(x, bufs, True, mode)
    (grad,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    torch.autograd.grad(grad, x, grad_outputs=torch.ones_like(grad))


@pytest.mark.parametrize("mode", gf.MODES)
def test_probe_routes_to_the_warpgroup_core(monkeypatch, mode):
    """On a card the marginalised probe of every mode launches
    ``gmm_score_wg``'s entries with the mode's products and pair buffer
    (``pair_wg3`` under ``"f32"``, ``pair_wg`` otherwise) and ``lin_wg``:
    K5's logsumexp instance, K8 and K9a on the same rows and that
    logsumexp, one CTA a tile of 128 rows up to the SMs, then K9b of
    ``gmm_patch``; each wrapper counts its launch, no plain version
    runs."""
    calls = fake_card(monkeypatch)
    bufs = gmm_pair("astro-snr-v1")[1]
    gp.reset_counters()
    gf.reset_counters()
    probe_through_autograd(bufs, mode)
    assert [c[:2] for c in calls] == [
        ("gmm_score_wg", "gmm_score_wg_rows"),
        ("gmm_score_wg", "gmm_score_wg_unit"),
        ("gmm_score_wg", "gmm_score_wg_weights"),
        ("gmm_patch", "gmm_hvp_marg_mix")]
    (score, unit, weights, _) = (c[2] for c in calls)
    pairs = bufs["pair_wg3" if mode == "f32" else "pair_wg"].data_ptr()
    products = gf.WG_PRODUCTS[mode]
    model = (pairs, bufs["lin_wg"].data_ptr(), bufs["a_full"].data_ptr(),
             bufs["b_rows"].data_ptr())
    assert score[1:7] == (300, pairs, bufs["lin_wg"].data_ptr(), 200,
                          products, 1)
    lse = score[7]
    assert unit[1:3] == (lse, 300) and unit[0] == score[0]
    assert unit[3:9] == (*model, 200, products)
    assert unit[10] == 3  # 300 rows: three tiles of 128, three CTAs
    assert weights[2:4] == (lse, 300) and weights[0] == score[0]
    assert weights[4:10] == (*model, 200, products)
    assert weights[11] == 3
    names = cs.MARG_PROBE_KERNELS[mode]
    for fn in (gp.gmm_score_rows_cuda, gp.gmm_score_rows_marg_cuda,
               gp.gmm_score_rows_marg_tc_cuda,
               gp.gmm_score_rows_marg_bf16_cuda, gp.gmm_unit_marg_cuda,
               gp.gmm_unit_marg_tc_cuda, gp.gmm_unit_marg_bf16_cuda,
               gp.gmm_hvp_marg_weights_cuda,
               gp.gmm_hvp_marg_weights_tc_cuda,
               gp.gmm_hvp_marg_weights_bf16_cuda):
        assert fn.launches == int(fn.__name__[:-len("_cuda")] in names)
    assert gp.gmm_hvp_marg_mix_cuda.launches == 1
    assert sum(fn.calls for fn in (
        gp.score_rows_plain, gp.unit_marg_plain, gp.hvp_marg_weights_plain,
        gp.hvp_marg_weights_split_plain, gp.hvp_marg_weights_bf16_plain,
        gp.hvp_marg_mix_plain, gf.score_split_marg_plain,
        gf.score_bf16_marg_plain, gf.marg_unit_split_plain,
        gf.marg_unit_bf16_plain)) == 0


@pytest.mark.parametrize("entry", ["gmm_score_wg_rows", "gmm_score_wg_unit",
                                   "gmm_score_wg_weights"])
def test_probe_raises_where_a_launch_fails(monkeypatch, entry):
    """A kernel of the core that reports an error raises, naming its
    entry: nothing falls back to the plain versions."""
    calls = fake_card(monkeypatch)
    failing = FakeLibrary("gmm_score_wg", calls, code=1)
    working = FakeLibrary("gmm_score_wg", calls)
    monkeypatch.setattr(gp, "_wg_library", lambda: types.SimpleNamespace(
        **{name: getattr(failing if name == entry else working, name)
           for name in ("gmm_score_wg_rows", "gmm_score_wg_unit",
                        "gmm_score_wg_weights",
                        "gmm_score_wg_error_string")}))
    bufs = gmm_pair("astro-snr-v1")[1]
    gp.reset_counters()
    with pytest.raises(RuntimeError, match=entry):
        probe_through_autograd(bufs, "split")
    assert gp.hvp_marg_weights_split_plain.calls == 0
    assert gf.marg_unit_split_plain.calls == 0
