"""The precision dial's ``"default"`` setting: the ``"bf16"`` mode.

Under ``"default"`` the JAX package computes the GMM logits and the
matrix-DFT convolution's stage-B products at ``Precision.DEFAULT``. On a
TPU that rounds each float32 operand to bf16 (round to nearest even),
multiplies exactly and sums in float32. The port's ``"bf16"`` plain
versions (the references of the card's one-product tensor-core kernels)
compute exactly that: the pair products ``x_a x_b`` (formed in float32)
and the pair-major ``A`` rounded to bf16, one product, ``b . x`` in
float32; K3's interleaved rows and stage matrices rounded to bf16, one
product.

JAX on the CPU runs ``Precision.DEFAULT`` as full float32 (an 8 x 8
product of entries 1 + 2^-12 gives 8.0039 there, bf16 gives 8.0), so the
GMM half cannot be held bit-close to the JAX package here. The JAX
package's K3 in ``"bf16"`` mode casts its operands itself and does round
on the CPU. Tolerances, each with its reason:

- (a) each bf16 plain GMM function against float64 sums of the same
  bf16-rounded operands (what the TPU's DEFAULT computes, up to its
  float32 sums): scores rtol 1e-5 (1.3e-6 measured), argmax the float64
  argmax wherever the top two differ by more than 1e-5 of the value;
  gradients, p and the Hessian action within 1e-5 of their max-abs, dp
  within that or within what the logits' float32 rounding moves it by
  (``chip_smoke.dp_rounding``);
- (b) the same functions against the JAX package's Pallas kernels in
  interpret mode at ``Precision.DEFAULT`` (float32 here): its own bar for
  that mode, rtol and atol 2e-2 (``tests/test_gmm_fused.py``), or, for a
  value beyond it, within the rounding that single bf16 operands may
  cause, ``2^-8`` of half the sum of the products' magnitudes (under
  ``builtin-8x8-v1``, 11 of 1,012 patches of a uniform image lie up to
  3.7e-2 from float32, all within it); MAP argmax flips on at most 2% of
  the patches (the JAX package documents about 0.5% on the TPU; none
  measured here); gradients and Hessian actions within 2e-2 of their
  max-abs;
- (c) K3's bf16 plain pipeline and the JAX package's ``"bf16"`` kernels
  against float64: the port's error at most twice the JAX package's
  (which also rounds Karatsuba's ``re + im`` sums) and at most 1.3e-2 of
  the max-abs (the JAX package's documented error for the mode);
- (d) a small ``MAPDeconvolver`` run under ``"default"``, fft and pfft,
  against the JAX package's under ``"default"``; see that test for why
  its bar is the JAX package's own ``"default"``-to-``"high"`` distance
  of the pfft run;
- (e) ``kernel_buffers``' ``A`` is symmetric bit for bit, and the bf16
  planes are exactly ``bf16`` of the JAX package's operand.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp
from jax import lax

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch import config
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.ops import gmm_pallas as tp
from jolideco_torch.ops import pallas_fft as pf
from jolideco_torch.ops.linalg import bf16_round
from jolideco_torch.utils.bench_data import make_datasets
from jolideco_tpu.config import force_pallas
from jolideco_tpu.config import set_gmm_precision as j_set_gmm_precision
from jolideco_tpu.ops import pallas_fft as jpf
from jolideco_tpu.ops.gmm_fused import _padded_dims, gmm_score_fused_image
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from jolideco_tpu.priors.patches.core import ZERO_FLUX_SENTINEL

torch.set_num_threads(1)
STRIDE = 4
GMM_NAMES = ["builtin-8x8-v1", "astro-snr-v1"]
PLAIN_RTOL = 1e-5
JAX_TOL = 2e-2
JAX_FLIPS = 2e-2
PFFT_BF16_SHARE = 1.3e-2
EPOCHS = 5


@pytest.fixture(scope="module", params=GMM_NAMES)
def gmms(request):
    return (jj.GaussianMixtureModel.from_registry(request.param),
            jt.GaussianMixtureModel.from_registry(request.param))


def make_image(shape=(128, 128), seed=7):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:8, :16] = 2.0 * ZERO_FLUX_SENTINEL
    return img


@pytest.fixture(scope="module")
def rows():
    """The probe's rows of a random 32 x 48 image: its 96 grouped
    patches, mean-subtracted; rows 0 and 61 zeroed as masked patches."""
    from jolideco_torch.ops.patches import (
        view_as_overlapping_patches_grouped,
    )

    img = np.random.RandomState(3).uniform(0.1, 2.0, (32, 48))
    patches = view_as_overlapping_patches_grouped(
        torch.as_tensor(img, dtype=torch.float32), (8, 8), 4)
    x = patches - patches.mean(dim=1, keepdim=True)
    x[::61] = 0.0
    return x.contiguous()


def bf16_logits64(x, bufs):
    """Float64 sums of the ``"bf16"`` mode's operands of float32 rows
    ``x``: the pair products rounded to bf16 (from float32), ``pair_hi``,
    and ``b . x + c``; and the half sums of the products' magnitudes."""
    pa = torch.as_tensor(tf.PAIR_A)
    pb = torch.as_tensor(tf.PAIR_B)
    u = bf16_round(x[:, pa] * x[:, pb]).double()
    a = bufs["pair_hi"].double()
    x64 = x.double()
    logits = (-0.5 * (u @ a) + x64 @ bufs["bq"].double()
              + bufs["const2"].double())
    return logits, 0.5 * (u.abs() @ a.abs())


def assert_scores_match_float64(values, argmax, logits, marginalize):
    want = (torch.logsumexp(logits, dim=1) if marginalize
            else logits.max(dim=1).values)
    rel = ((values.double() - want).abs() / want.abs()).max()
    assert float(rel) <= PLAIN_RTOL, float(rel)
    top2 = logits.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > PLAIN_RTOL * want.abs()
    assert float(decided.double().mean()) > 0.9
    assert_array_equal(argmax[decided].numpy(),
                       logits.argmax(dim=1)[decided].numpy())


def assert_near_float64(got, want):
    scale = float(want.abs().max())
    assert scale > 0
    assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                    atol=PLAIN_RTOL * scale)


def marg64(x, logits, bufs, t=None):
    """The float64 unit gradient (and with ``t`` the weights ``p``, ``dp``
    and the Hessian action) of the marginalised score on ``logits``."""
    b64 = {name: v.double() for name, v in bufs.items()}
    x64 = x.double()
    p = torch.softmax(logits, dim=1)
    unit = p @ b64["b_rows"] - tf.mix_rows(p, x64, b64)
    if t is None:
        return unit
    t64 = t.double()
    cross = (t64[:, :, None] * x64[:, None, :]).reshape(len(x64), -1)
    g = t64 @ b64["bq"] - cross @ b64["aq"]
    # against the heaviest component's g, as the port (and the kernels)
    # take it: on a row whose weight is 1 - 3e-14, 1 - p_ref in float64
    # is 0.4% off, and so would dp_ref be
    g = g - g.gather(1, p.argmax(dim=1, keepdim=True))
    dp = p * (g - (p * g).sum(dim=1, keepdim=True))
    hvp = tp.hvp_marg_mix_plain(x64, t64, p.T.contiguous(),
                                dp.T.contiguous(), b64)
    return unit, p.T, dp.T, hvp


# ----------------------------------------------------------------------
# (a) the bf16 plain versions against float64 of their own operands


@pytest.mark.parametrize("marginalize", [False, True])
def test_bf16_fused_forward_matches_float64_of_its_operands(gmms,
                                                             marginalize):
    _, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    tf.reset_counters()
    values, argmax, valid, xtn = tf.fused_forward_plain(
        torch.as_tensor(make_image()), bufs, STRIDE, ZERO_FLUX_SENTINEL,
        marginalize, mode="bf16")
    assert tf.PLAIN_SCORES["bf16", marginalize].calls == 1
    assert tf.score_plain.calls == tf.score_split_plain.calls == 0
    m = valid > 0.5
    logits, _ = bf16_logits64(xtn[m], bufs)
    assert_scores_match_float64(values[m], argmax[m], logits, marginalize)


def test_bf16_fused_backward_marg_matches_float64(gmms):
    _, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    image = torch.as_tensor(make_image(seed=11))
    lse, _, valid, xtn = tf.fused_forward_plain(
        image, bufs, STRIDE, ZERO_FLUX_SENTINEL, True, mode="bf16")
    dv = torch.as_tensor(np.random.RandomState(2).randn(len(lse)),
                         dtype=torch.float32) * valid
    tf.reset_counters()
    grad = tf.fused_backward_marg_plain(xtn, lse, valid, dv, bufs,
                                        image.shape, STRIDE, mode="bf16")
    assert tf.marg_unit_bf16_plain.calls == 1
    assert tf.marg_unit_split_plain.calls == 0
    logits, _ = bf16_logits64(xtn, bufs)
    unit = marg64(xtn, logits, bufs) * dv.double()[:, None]
    want = tf._patches_to_image(unit, valid.double(), tuple(image.shape),
                                STRIDE)
    assert_near_float64(grad, want)


@pytest.mark.parametrize("marginalize", [False, True])
def test_bf16_row_scorers_match_float64_of_their_operands(gmms, rows,
                                                          marginalize):
    _, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    tf.reset_counters()
    tp.reset_counters()
    values, argmax = tp.gmm_score_patches(rows, bufs, marginalize, "bf16")
    assert tf.PLAIN_SCORES["bf16", marginalize].calls == 1
    assert tp.score_rows_plain.calls == 0
    live = rows.abs().sum(dim=1) > 0
    logits, _ = bf16_logits64(rows[live], bufs)
    assert_scores_match_float64(values[live], argmax[live], logits,
                                marginalize)


def test_bf16_unit_and_weights_match_float64(gmms, rows):
    """K8 bf16's and K9a bf16's plain versions (and K9b on their weights)
    against the float64 pipeline of the same logits; ``g`` is float32 in
    the port (ROADMAP section 3), float64 here."""
    _, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    t = torch.as_tensor(np.random.RandomState(5).randn(*rows.shape),
                        dtype=torch.float32)
    lse, _ = tf.score_bf16_marg_plain(rows, bufs)
    tp.reset_counters()
    unit = tf.marg_unit_bf16_plain(rows, lse, bufs)
    p, dp = tp.hvp_marg_weights_bf16_plain(rows, t, lse, bufs)
    hvp = tp.hvp_marg_mix_plain(rows, t, p, dp, bufs)
    assert tp.hvp_marg_weights_bf16_plain.calls == 1
    assert tp.hvp_marg_weights_split_plain.calls == 0
    logits, _ = bf16_logits64(rows, bufs)
    unit64, p64, dp64, hvp64 = marg64(rows, logits, bufs, t)
    assert_near_float64(unit, unit64)
    assert_near_float64(p, p64)
    assert_near_float64(hvp, hvp64)
    # dp is 0 on the one-hot rows (the kernels' rule); where a weight is
    # shared, within 1e-5 of its max-abs or within what the float32
    # rounding of the logits moves it by (chip_smoke.dp_rounding: a
    # weight p_k = exp(logit_k - lse) of logits near 1e5 moves by
    # exp(+-2 d) with d a float32 spacing of the row's largest logit)
    one_hot = (p > 0).sum(dim=0) == 1
    assert int(one_hot.sum()) >= 0.9 * rows.shape[0]
    assert bool((dp[:, one_hot] == 0).all())
    big = torch.where(p64.T > 0, logits.abs(),
                      torch.zeros_like(logits)).amax(dim=1)
    d = 2.0 ** -23 * big
    rounding = torch.expm1(2 * d) * (dp64.abs() + torch.exp(2 * d) * p64
                                     * dp64.abs().sum(dim=0))
    err = (dp.double() - dp64).abs()
    assert bool((err <= PLAIN_RTOL * float(dp64.abs().max())
                 + rounding).all())


# ----------------------------------------------------------------------
# (b) against the JAX package's kernels at Precision.DEFAULT (float32
# on the CPU)


def jax_fused(gmm_j, img, marginalize):
    """The JAX fused kernel at DEFAULT, cropped to the port's grid."""
    values, argmax, valid = gmm_score_fused_image(
        jnp.asarray(img), (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
        interpret=True, precision=lax.Precision.DEFAULT,
        marginalize=marginalize)
    h, w = img.shape
    hp, wp, _ = _padded_dims(h, w)
    g = (8 // STRIDE) ** 2

    def crop(a):
        grid = np.asarray(a).reshape(g, hp // 8, wp // 8)
        return grid[:, :h // 8, :w // 8].reshape(-1)

    return crop(values), crop(argmax), crop(valid)


def assert_values_near_jax(v_t, a_t, v_j, a_j, rounding):
    """The JAX package's bar for DEFAULT, or for a value beyond it the
    rounding single bf16 operands may cause; argmax flips at most
    ``JAX_FLIPS`` of the rows."""
    err = np.abs(v_t - v_j)
    beyond = err > JAX_TOL + JAX_TOL * np.abs(v_j)
    assert beyond.mean() <= JAX_FLIPS
    assert bool((err[beyond] <= 2.0 ** -8 * rounding[beyond]
                 + 1e-5 * np.abs(v_j[beyond])).all())
    assert (a_t != a_j).mean() <= JAX_FLIPS


@pytest.mark.parametrize("marginalize", [False, True])
def test_bf16_fused_forward_against_jax_default(gmms, marginalize):
    gmm_j, gmm_t = gmms
    img = make_image()
    v_j, a_j, valid_j = jax_fused(gmm_j, img, marginalize)
    bufs = gmm_t.kernel_buffers("cpu")
    v_t, a_t, valid_t, xtn = tf.fused_forward_plain(
        torch.as_tensor(img), bufs, STRIDE, ZERO_FLUX_SENTINEL, marginalize,
        mode="bf16")
    m = valid_t.numpy() > 0.5
    assert_array_equal(m, valid_j)
    _, size = bf16_logits64(xtn[m], bufs)
    rounding = size.gather(1, a_t[m].long()[:, None])[:, 0].numpy()
    assert_values_near_jax(v_t.numpy()[m], a_t.numpy()[m], v_j[m], a_j[m],
                           rounding)


def test_bf16_fused_gradient_against_jax_default(gmms):
    """The marginalised fused scorer's image gradient (K4 bf16's plain
    version through the autograd rule) against ``jax.grad`` of the JAX
    fused kernel at DEFAULT."""
    gmm_j, gmm_t = gmms
    img = make_image(seed=11)

    def scalar_j(x):
        values, _, valid = gmm_score_fused_image(
            x, (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
            interpret=True, precision=lax.Precision.DEFAULT, marginalize=True)
        return jnp.sum(jnp.where(valid, values, 0.0))

    grad_j = np.asarray(jax.grad(scalar_j)(jnp.asarray(img)))
    x = torch.as_tensor(img).requires_grad_(True)
    tf.reset_counters()
    values, _, valid = tf.gmm_score_fused_image(
        x, (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"), ZERO_FLUX_SENTINEL,
        marginalize=True, mode="bf16")
    torch.where(valid, values, torch.zeros_like(values)).sum().backward()
    assert (tf.score_bf16_marg_plain.calls,
            tf.marg_unit_bf16_plain.calls) == (1, 1)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=JAX_TOL * float(np.abs(grad_j).max()))


@pytest.mark.parametrize("marginalize", [False, True])
def test_bf16_row_scorers_against_jax_default(gmms, rows, marginalize):
    gmm_j, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    v_j, a_j = gmm_score_pallas(
        jnp.asarray(rows.numpy()), gmm_j.packed,
        gmm_j.means_precisions_cholesky, gmm_j.precisions_cholesky,
        gmm_j.pixel_weights, True, lax.Precision.DEFAULT, marginalize)
    v_t, a_t = tp.gmm_score_patches(rows, bufs, marginalize, "bf16")
    _, size = bf16_logits64(rows, bufs)
    rounding = size.gather(1, a_t.long()[:, None])[:, 0].numpy()
    assert_values_near_jax(v_t.numpy(), a_t.numpy(), np.asarray(v_j),
                           np.asarray(a_j), rounding)


def test_bf16_probe_gradient_and_hvp_against_jax_default(gmms, rows):
    """K5 lse, K8 and K9a (then K9b) in ``"bf16"`` mode, as the probe runs
    them through the autograd rules, against the JAX kernels' gradient
    and Hessian action at DEFAULT."""
    gmm_j, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    t = np.random.RandomState(5).randn(*rows.shape).astype(np.float32)
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def total(v):
        return jnp.sum(gmm_score_pallas(v, *args, True,
                                        lax.Precision.DEFAULT, True)[0])

    grad = jax.grad(total)
    x_j = jnp.asarray(rows.numpy())
    _, hvp_j = jax.jvp(grad, (x_j,), (jnp.asarray(t),))
    grad_j, hvp_j = np.asarray(grad(x_j)), np.asarray(hvp_j)

    tf.reset_counters()
    tp.reset_counters()
    x = rows.clone().requires_grad_(True)
    values, _ = tp.gmm_score_patches(x, bufs, True, "bf16")
    (grad_t,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    (hvp_t,) = torch.autograd.grad(grad_t, x, grad_outputs=torch.as_tensor(t))
    assert (tf.score_bf16_marg_plain.calls, tf.marg_unit_bf16_plain.calls,
            tp.hvp_marg_weights_bf16_plain.calls) == (1, 1, 1)
    assert (tf.score_split_marg_plain.calls, tp.score_rows_plain.calls,
            tp.hvp_marg_weights_split_plain.calls) == (0, 0, 0)
    for got, want in ((grad_t.detach().numpy(), grad_j),
                      (hvp_t.numpy(), hvp_j)):
        assert_allclose(got, want, rtol=0,
                        atol=JAX_TOL * float(np.abs(want).max()))


# ----------------------------------------------------------------------
# (c) K3's bf16 mode


@pytest.mark.parametrize("p_,h,w,k", [(2, 128, 128, 9), (1, 128, 256, 9),
                                      (2, 256, 256, 33)])
def test_bf16_pfft_plain_against_jax_bf16(p_, h, w, k):
    from test_torch_pfft_split import setup

    x0, x1, n, spectra = setup(0, p_, h, w, k)
    j0, j1 = jpf.conv_packed_pfft(jnp.asarray(x0), jnp.asarray(x1),
                                  *map(jnp.asarray, spectra), n, "bf16",
                                  True)
    xs = [torch.as_tensor(v) for v in (x0, x1)]
    planes = list(map(torch.as_tensor, spectra))
    pf.reset_counters()
    y = pf.conv_packed_pfft(*xs, *planes, n, mode="bf16")
    assert pf.conv_packed_pfft_plain.calls == 1
    y64 = pf.conv_packed_pfft_plain(*(v.double() for v in xs), *planes, n,
                                    dtype=torch.float64)
    ys = pf.conv_packed_pfft_plain(*xs, *planes, n, mode="split")
    scale = max(float(t.abs().max()) for t in y64)

    def err(got):
        return max(float((torch.as_tensor(np.array(a)).double() - b)
                         .abs().max()) for a, b in zip(got, y64))

    err_t, err_j, err_s = err(y), err((j0, j1)), err(ys)
    assert err_t <= 2.0 * err_j, (err_t, err_j)
    assert err_t <= PFFT_BF16_SHARE * scale
    # the mode is honoured: one product is far further off than three
    assert err_t >= 10.0 * err_s


def test_bf16_pfft_passes_take_the_hi_planes():
    """Each pass in ``"bf16"`` mode is ``bf16(x) . bf16(R)`` with float32
    sums: pass 2 of a random ``U`` against the float64 product of the
    same rounded operands, within float32's summation error."""
    m, w = 2, 128
    n = 128 * m
    rng = np.random.default_rng(1)
    u = torch.complex(*(torch.as_tensor(rng.standard_normal((1, n, w)),
                                        dtype=torch.float32)
                        for _ in range(2)))
    r = pf._mode_tables(m, torch.device("cpu"), "bf16")["mf"]
    assert len(r) == 1
    hi, _ = pf._split_tables(m, torch.device("cpu"))["mf"]
    assert torch.equal(r[0], hi)
    x = u.reshape(1, m, 128, w)[:, :, :, :128].transpose(-1, -2)
    got = pf._tc_product(x, r)
    xr = bf16_round(torch.view_as_real(x.contiguous()).reshape(
        1, m, 128, 256)).double()
    want = torch.view_as_complex((xr @ r[0].double()).reshape(
        1, m, 128, 128, 2))
    assert_allclose(got.numpy(), want.numpy(), rtol=0,
                    atol=1e-5 * float(want.abs().max()))


# ----------------------------------------------------------------------
# (d) the deconvolver under "default"


def run_deconvolver(pkg, datasets, dial, conv_mode):
    """``EPOCHS`` joint Adam steps at lr 0.1 from a flat start under
    ``astro-snr-v1`` (stride 4, no cycle spin) and the dial ``dial``; the
    final flux. The JAX package runs its Pallas kernels in the
    interpreter."""
    gmm = pkg.GaussianMixtureModel.from_registry("astro-snr-v1")
    prior = pkg.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False)
    comp = pkg.SpatialFluxComponent.from_numpy(
        np.ones((128, 128), np.float32), prior=prior)
    if pkg is jj:
        j_set_gmm_precision(dial)
        try:
            deco = jj.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                                     update_strategy="joint", trace_every=0,
                                     display_progress=False, seed=0,
                                     conv_mode=conv_mode)
            with force_pallas("interpret"):
                result = deco.run(datasets, components=comp)
            return result.components["flux"].flux_upsampled_numpy
        finally:
            j_set_gmm_precision("high")
    config.set_gmm_precision(dial)
    try:
        deco = jt.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                                 update_strategy="joint", trace_every=0,
                                 seed=0, device="cpu", conv_mode=conv_mode)
        return deco.run(datasets, components=comp).flux_upsampled_total
    finally:
        config.set_gmm_precision("high")


@pytest.fixture(scope="module")
def dial_runs():
    """Both packages under ``"default"`` and ``"high"``, fft and pfft, on
    ``chip_smoke.py``'s small data (4 x 128², 9² PSFs); the port's plain
    calls of its ``"default"`` fft run."""
    datasets = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    runs = {}
    for conv in ("fft", "pfft"):
        for dial in ("default", "high"):
            runs["j", dial, conv] = run_deconvolver(jj, datasets, dial, conv)
            tf.reset_counters()
            runs["t", dial, conv] = run_deconvolver(jt, datasets, dial, conv)
            runs["calls", dial, conv] = {
                m: tf.PLAIN_SCORES[m, False].calls for m in ("split", "bf16")}
    return runs


@pytest.mark.parametrize("conv_mode", ["fft", "pfft"])
def test_map_deconvolver_default_dial_against_jax(dial_runs, conv_mode):
    """The port's ``"default"`` run (single-bf16 logits; K3 in ``"bf16"``
    under pfft) against the JAX package's ``"default"`` run with its
    Pallas kernels in the interpreter, ``diff_t``, held to twice
    ``diff_j``, the JAX package's own ``"default"``-to-``"high"``
    distance on the pfft run, as a share of the max-abs.

    The MAP gradient reads the logits through the argmax, and Adam's
    first steps, ``-lr g / (|g| + eps)``, turn a flip into a full step,
    so the dial moves this fit by a large share of its flux. On the CPU
    the JAX package's fft run is the same under both settings (diff 0:
    its DEFAULT logits are float32 here), so only its pfft run, whose K3
    rounds to bf16 on the CPU too, measures how far the dial's bf16
    rounding moves this fit: 0.24 of the max-abs after 5 steps
    (measured), against 0.13 (fft) and 0.17 (pfft) for the port's
    ``"default"`` run from the JAX package's. The port's ``"high"`` runs
    stay within 4e-3 of the JAX package's (``tests/test_torch_pfft_path.py``
    and ``test_torch_gmm_fused_split.py`` hold them closer at 20 steps),
    and its ``"default"`` run must take the bf16 plain scorer each step
    and move off its ``"high"`` run."""
    r = dial_runs
    scale = float(np.abs(r["j", "high", conv_mode]).max())

    def dist(a, b):
        return float(np.abs(r[a] - r[b]).max()) / scale

    diff_j = dist(("j", "default", "pfft"), ("j", "high", "pfft"))
    diff_t = dist(("t", "default", conv_mode), ("j", "default", conv_mode))
    assert diff_j > 0
    assert diff_t <= 2.0 * diff_j, (diff_t, diff_j)
    assert dist(("t", "high", conv_mode), ("j", "high", conv_mode)) <= 4e-3
    assert dist(("t", "default", conv_mode), ("t", "high", conv_mode)) > 0
    assert r["calls", "default", conv_mode] == {"split": 0,
                                                "bf16": EPOCHS}
    assert r["calls", "high", conv_mode] == {"split": EPOCHS, "bf16": 0}
    flux = r["t", "default", conv_mode]
    assert np.isfinite(flux).all() and (flux > 0).all()


# ----------------------------------------------------------------------
# (e) the buffers, the dial and the wrappers


@pytest.mark.parametrize("name", ["builtin-8x8-v1", "astro-snr-v1",
                                  "wide-256"])
def test_kernel_buffers_a_is_symmetric_and_bf16_planes_exact(name):
    """The pair form doubles ``A``'s off-diagonals: that is the JAX
    package's two products only if ``A`` is symmetric bit for bit, which
    ``kernel_buffers`` gives (the float64 product it is cut from is not),
    and bf16 doubles exactly. So ``pair_hi`` is bf16 of the JAX package's
    float32 ``A`` (doubled off the diagonal), and the tensor-core
    kernels' hi planes are ``pair_hi``."""
    if name == "wide-256":
        from chip_smoke import wide_gmm

        gmm = wide_gmm()
    else:
        gmm = jt.GaussianMixtureModel.from_registry(name)
    bufs = gmm.kernel_buffers("cpu")
    a_full = bufs["a_full"]
    assert torch.equal(a_full, a_full.transpose(1, 2))
    k = a_full.shape[0]
    assert torch.equal(a_full, torch.as_tensor(gmm.packed["aq"]).T.reshape(
        k, 64, 64))
    diag = torch.as_tensor(tf.PAIR_A == tf.PAIR_B)[:, None]
    a_pair = a_full[:, tf.PAIR_A, tf.PAIR_B].T
    want = torch.where(diag, bf16_round(a_pair), 2.0 * bf16_round(a_pair))
    assert torch.equal(bufs["pair_hi"], want)
    from test_torch_gmm_fused_split import wg_parts

    hi = torch.as_tensor(wg_parts(bufs)[0][0])
    assert torch.equal(hi[:k], bufs["pair_hi"].T)
    assert not hi[k:].any()


def test_default_dial_names_bf16():
    saved = config.gmm_precision()
    try:
        config.set_gmm_precision("default")
        assert config.gmm_mode() == config.pfft_mode() == "bf16"
        config.set_gmm_precision("high")
        assert config.gmm_mode() == config.pfft_mode() == "split"
        config.set_gmm_precision("highest")
        assert config.gmm_mode() == config.pfft_mode() == "f32"
    finally:
        config.set_gmm_precision(saved)


def test_bf16_wrappers_refuse_cpu_tensors(rows):
    """Every ``"bf16"`` kernel's wrapper launches on a card or raises: a
    CPU tensor takes the plain versions only through the dispatch."""
    bufs = jt.GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers("cpu")
    lse = torch.zeros(len(rows))
    image = torch.as_tensor(make_image((16, 128)))
    n = tf.fused_patch_count(image.shape, STRIDE)
    flat = torch.zeros(n)
    u = torch.zeros((1, 256, 128), dtype=torch.complex64)
    x0 = torch.zeros((1, 128, 128))
    spec = [torch.zeros((1, 256, 256))] * 4
    calls = [
        lambda: tf.gmm_fused_fwd_bf16_cuda(image, bufs, STRIDE,
                                           ZERO_FLUX_SENTINEL),
        lambda: tf.gmm_fused_fwd_marg_bf16_cuda(image, bufs, STRIDE,
                                                ZERO_FLUX_SENTINEL),
        lambda: tf.gmm_fused_bwd_marg_bf16_cuda(
            torch.zeros((n, 64)), flat, flat, flat, bufs, image.shape,
            STRIDE),
        lambda: tp.gmm_score_rows_bf16_cuda(rows, bufs),
        lambda: tp.gmm_score_rows_marg_bf16_cuda(rows, bufs),
        lambda: tp.gmm_unit_marg_bf16_cuda(rows, lse, bufs),
        lambda: tp.gmm_hvp_marg_weights_bf16_cuda(rows, rows, lse, bufs),
        lambda: pf.pfft_cols_fwd_bf16_cuda(x0, x0, 256),
        lambda: pf.pfft_rows_combine_bf16_cuda(u, *spec),
        lambda: pf.pfft_cols_inv_bf16_cuda(u, u, 128),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
