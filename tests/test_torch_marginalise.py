"""The marginalised GMM prior of the port against ``jolideco_tpu``.

``GMMPatchPrior(marginalize=True)`` scores each patch by the logsumexp
of its component logits. The port runs the plain versions of its
kernels (CPU tensors); the JAX side runs as its own tests run it: the
fused scorer and the patch-level scorer in interpret mode at
``precision=HIGHEST``, and the prior and the deconvolver under
``force_pallas("interpret")``, so that they reach those kernels. Their
default CPU dispatch (the XLA scan scorer) is not the reference here:
its marginalise backward takes ``exp(logit - lse)`` without
renormalising, with logits recomputed in another float32 order than the
forward's lse, and for the builtin GMM's logits of order 1e5 its prior
gradient departs from the kernels' by several percent of its max-abs
(``main()`` below prints it). Tolerances, each with its reason:

- values: rtol 1e-5 (float32 quadratic forms summed in different
  orders); ``valid`` and argmax identical;
- gradients of the fused and patch-level scorers and of the prior: 1e-4
  of their max-abs. The JAX backwards read ``A`` and the softmax weights
  as bf16 hi/lo pairs (about 16 significant bits), and the shipped GMMs'
  logits are of order 1e5 to 1e8, so a softmax weight of two near-tied
  components moves with float32 rounding of its logits;
- the patch-level Hessian action along a random tangent: 1e-4 of its
  max-abs, against the JAX kernels on a moderately conditioned random
  SPD GMM and against the exact mathematics in numpy float64 on the
  builtin GMM (the JAX package's own bars, ``tests/test_gmm_pallas.py``);
- the plain versions in float64 against torch autograd through the
  float64 logits: 1e-9 of the max-abs (float64 sums in other orders);
- ``MAPDeconvolver`` after 20 joint steps, the port under its default
  dial (the fused scorer's ``"split"`` logits in the logsumexp forward
  and the marginalise backward, as the JAX kernels' at HIGH): flux rtol
  5e-3 and flux errors rtol 1e-3, not the flux maps' 1e-4
  (``BASELINE.md``). The JAX
  kernels' marginalise backward mixes the components with the softmax
  weights and ``A`` split into bf16 hi/lo pairs whatever the precision
  dial says (its HIGH and HIGHEST runs give identical flux maps on the
  CPU), and at the trained flux that prior gradient lies 2.8e-5 of its
  max-abs from the float64 one, where the port's float32 plain version
  lies 1.6e-6 from it; 20 Adam steps amplify the difference to 2.7e-3
  in the flux and 2.8e-4 in the errors (``main()`` below prints these
  numbers). The test asserts that the port is the closer of the two to
  float64;
- the same run under a random SPD GMM whose weights are mixed, where
  the builtin GMM's are one-hot (so that there marginalised and MAP
  runs agree): flux and errors rtol 1e-4, as for MAP.
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
from jolideco_torch.config import force_fused
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.ops import gmm_pallas as tp
from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.config import force_fused as j_force_fused
from jolideco_tpu.config import force_pallas as j_force_pallas
from jolideco_tpu.ops.gmm_fused import gmm_score_fused_image as j_fused
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from jolideco_tpu.priors import GaussianMixtureModel as JGMM
from jolideco_tpu.priors.patches.core import ZERO_FLUX_SENTINEL
from test_torch_gmm_fused import STRIDE, jax_scores, make_image
from test_torch_gmm_patch import random_spd_arrays
from test_torch_prior import gmm_pair, jax_shifts
from test_torch_slice import SIZE, make_datasets

torch.set_num_threads(1)
SHAPES = [(16, 128), (20, 136)]
N_ROWS = 300


@pytest.fixture(scope="module", params=["builtin-8x8-v1", "astro-snr-v1"])
def gmms(request):
    return JGMM.from_registry(request.param), TGMM.from_registry(request.param)


def jax_fused(gmm_j, img):
    return j_fused(img, (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
                   interpret=True, precision=lax.Precision.HIGHEST,
                   marginalize=True)


# ----------------------------------------------------------------------
# (a), (b): the fused scorer


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_logsumexp_forward_matches_jax(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape)
    (v_j, _), (a_j, _), (valid_j, valid_outside) = jax_scores(
        gmm_j, img, marginalize=True)

    tf.reset_counters()
    values, argmax, valid = tf.gmm_score_fused_image(
        torch.as_tensor(img), (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"),
        ZERO_FLUX_SENTINEL, marginalize=True,
    )
    assert tf.fused_forward_plain.calls == 1
    assert not valid_outside.any()
    assert_array_equal(valid.numpy(), valid_j)
    m = valid.numpy()
    assert 0 < m.sum() < m.size
    assert_allclose(values.numpy()[m], v_j[m], rtol=1e-5)
    assert_array_equal(argmax.numpy()[m], a_j[m])
    # the logsumexp is at least the maximum, and at most log K above it
    v_map, _, _ = tf.gmm_score_fused_image(
        torch.as_tensor(img), (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"),
        ZERO_FLUX_SENTINEL,
    )
    gap = (values - v_map).numpy()[m]
    assert (gap >= 0).all() and (gap <= np.log(gmm_t.n_components)).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_marginalise_image_gradient_matches_jax(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape, seed=11)

    def scalar_j(x):
        values, _, valid = jax_fused(gmm_j, x)
        return jnp.sum(jnp.where(valid, values, 0.0))

    value_j, grad_j = jax.value_and_grad(scalar_j)(jnp.asarray(img))

    tf.reset_counters()
    x = torch.as_tensor(img).requires_grad_(True)
    values, _, valid = tf.gmm_score_fused_image(
        x, (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"), ZERO_FLUX_SENTINEL,
        marginalize=True,
    )
    torch.where(valid, values, torch.zeros_like(values)).sum().backward()
    assert tf.fused_backward_marg_plain.calls == 1
    assert tf.fused_backward_plain.calls == 0

    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))


def test_fused_marginalise_backward_is_the_autograd_of_the_logsumexp():
    """The plain marginalise backward against torch autograd through the
    plain forward's own logsumexp, in float64 (1e-9 of the max-abs)."""
    bufs = {k: v.double() for k, v in
            TGMM.from_registry("builtin-8x8-v1").kernel_buffers("cpu").items()}
    img = torch.as_tensor(make_image((24, 128), seed=3), dtype=torch.float64)
    x = img.clone().requires_grad_(True)
    padded, masks = tf._group_slices(x, STRIDE)
    ny, nx = img.shape[0] // 8, img.shape[1] // 8
    patches = torch.cat([
        padded[a:a + 8 * ny, b:b + 8 * nx].reshape(ny, 8, nx, 8)
        .permute(0, 2, 1, 3).reshape(-1, 64)
        for a, b in tf._offsets(STRIDE)
    ])
    valid = masks.reshape(-1) & (patches > ZERO_FLUX_SENTINEL).all(dim=1)
    z = torch.where(valid[:, None], patches, torch.zeros_like(patches))
    z = z - z.mean(dim=1, keepdim=True)
    logits = next(tf.logit_chunks(z, bufs["aq"], bufs["bq"], bufs["const2"]))
    dv = torch.as_tensor(np.random.RandomState(2).randn(len(z)))
    (torch.logsumexp(logits, dim=1) * valid * dv).sum().backward()

    lse, _, valid_f, xtn = tf.fused_forward_plain(
        img, bufs, STRIDE, ZERO_FLUX_SENTINEL, marginalize=True)
    grad = tf.fused_backward_marg_plain(xtn, lse, valid_f, dv * valid_f,
                                        bufs, img.shape, STRIDE)
    want = x.grad.numpy()
    assert_allclose(grad.numpy(), want, rtol=0,
                    atol=1e-9 * float(np.abs(want).max()))


# ----------------------------------------------------------------------
# (c): the patch-level scorer's gradient and Hessian action


@pytest.fixture(scope="module")
def rows():
    rs = np.random.RandomState(0)
    x = rs.rand(N_ROWS, 64).astype(np.float32) - 0.5
    return x - x.mean(axis=1, keepdims=True)


def torch_grad_and_hvp(x, tangent, bufs):
    """Gradient of ``sum(values)`` and its derivative along ``tangent``,
    reverse over reverse, through the port's marginalise scorer."""
    x = torch.as_tensor(x).requires_grad_(True)
    values, _ = tp.gmm_score_patches(x, bufs, marginalize=True)
    (grad,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x,
                                 grad_outputs=torch.as_tensor(tangent))
    return grad.detach().numpy(), hvp.numpy()


def test_patch_gradient_and_hvp_match_jax_on_a_random_spd_gmm(rows):
    means, covariances, weights = random_spd_arrays()
    gmm_j = JGMM.from_numpy(means=means, covariances=covariances,
                            weights=weights)
    gmm_t = gmm_from_arrays(means, covariances, weights, None)
    tangent = np.random.RandomState(5).randn(*rows.shape).astype(np.float32)
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def total_j(x):
        return jnp.sum(gmm_score_pallas(x, *args, True, marginalize=True)[0])

    grad_j = np.asarray(jax.grad(total_j)(jnp.asarray(rows)))
    _, hvp_j = jax.jvp(jax.grad(total_j), (jnp.asarray(rows),),
                       (jnp.asarray(tangent),))
    hvp_j = np.asarray(hvp_j)

    tp.reset_counters()
    grad_t, hvp_t = torch_grad_and_hvp(rows, tangent,
                                       gmm_t.kernel_buffers("cpu"))
    assert (tp.score_rows_plain.calls, tp.unit_marg_plain.calls,
            tp.hvp_marg_weights_plain.calls,
            tp.hvp_marg_mix_plain.calls) == (1, 1, 1, 1)
    assert tp.unit_map_plain.calls == tp.hvp_map_plain.calls == 0
    # the random GMM's weights are not one-hot: the mixture is exercised
    p, _ = tp.hvp_marg_weights_plain(
        torch.as_tensor(rows), torch.as_tensor(tangent),
        tp.score_rows_plain(torch.as_tensor(rows),
                            gmm_t.kernel_buffers("cpu"), True)[0],
        gmm_t.kernel_buffers("cpu"))
    assert float(p.max(dim=0).values.min()) < 0.99

    assert_allclose(grad_t, grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))
    assert_allclose(hvp_t, hvp_j, rtol=0,
                    atol=1e-4 * float(np.abs(hvp_j).max()))


def analytic_grad_and_hvp(gmm_j, x, t):
    """The marginalised score's gradient and Hessian action in numpy
    float64 from the GMM's own arrays (``tests/test_gmm_pallas.py``):
    ``sum_k p_k r_k`` and ``-sum_k p_k A_k t + sum_k p_k (g_k - gbar)
    r_k`` with ``r_k = b_k - A_k x``, ``g_k = r_k . t``."""
    x, t = np.asarray(x, np.float64), np.asarray(t, np.float64)
    L = np.asarray(gmm_j.precisions_cholesky, np.float64)
    mp = np.asarray(gmm_j.means_precisions_cholesky, np.float64)
    ld = np.asarray(gmm_j.log_det_cholesky, np.float64)
    lw = np.asarray(gmm_j.log_weights, np.float64)
    w = np.asarray(gmm_j.pixel_weights, np.float64).reshape(-1)
    d = x.shape[1]
    a_quad = np.einsum("kde,e,kje->kdj", L, w, L)
    b_quad = np.einsum("ke,e,kje->kj", mp, w, L)
    c_quad = np.einsum("ke,e,ke->k", mp, w, mp)
    const = -0.5 * d * np.log(2 * np.pi) + ld + lw - 0.5 * c_quad
    xa = np.einsum("nd,kdj->nkj", x, a_quad)
    logits = (-0.5 * np.einsum("nkj,nj->nk", xa, x) + x @ b_quad.T
              + const[None, :])
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    r = b_quad[None, :, :] - xa
    g = np.einsum("nkd,nd->nk", r, t)
    gbar = np.einsum("nk,nk->n", p, g)
    grad = np.einsum("nk,nkd->nd", p, r)
    hvp = (-np.einsum("nk,kdj,nj->nd", p, a_quad, t)
           + np.einsum("nk,nkd->nd", p * (g - gbar[:, None]), r))
    return grad, hvp


@pytest.mark.parametrize("tangent", ["ones", "random"])
def test_patch_gradient_and_hvp_of_the_builtin_gmm_are_exact(rows, tangent):
    gmm_j = JGMM.from_registry("builtin-8x8-v1")
    gmm_t = TGMM.from_registry("builtin-8x8-v1")
    x = rows[:64]
    t = (np.ones_like(x) if tangent == "ones" else
         np.random.RandomState(6).randn(*x.shape).astype(np.float32))
    grad_ref, hvp_ref = analytic_grad_and_hvp(gmm_j, x, t)
    grad_t, hvp_t = torch_grad_and_hvp(x, t, gmm_t.kernel_buffers("cpu"))
    for got, want in ((grad_t, grad_ref), (hvp_t, hvp_ref)):
        assert_allclose(got, want, rtol=0,
                        atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["builtin-8x8-v1", "random-spd"])
def test_plain_versions_are_the_derivatives_of_the_logsumexp(rows, name):
    """unit_marg_plain and hvp_marg_plain in float64 against torch
    autograd through the float64 logits' logsumexp (1e-9 of max-abs);
    the lse they are given only stabilises the exponentials."""
    if name == "random-spd":
        gmm_t = gmm_from_arrays(*random_spd_arrays(), None)
    else:
        gmm_t = TGMM.from_registry(name)
    bufs = {k: v.double() for k, v in gmm_t.kernel_buffers("cpu").items()}
    x = torch.as_tensor(rows[:96], dtype=torch.float64).requires_grad_(True)
    t = torch.as_tensor(np.random.RandomState(7).randn(96, 64))
    logits = next(tf.logit_chunks(x, bufs["aq"], bufs["bq"],
                                  bufs["const2"]))
    lse = torch.logsumexp(logits, dim=1)
    (unit,) = torch.autograd.grad(lse.sum(), x, create_graph=True)
    (hvp,) = torch.autograd.grad(unit, x, grad_outputs=t)

    shifted = lse.detach() + 3.0
    got_unit = tp.unit_marg_plain(x.detach(), shifted, bufs)
    got_hvp = tp.hvp_marg_plain(t, x.detach(), shifted, bufs)
    for got, want in ((got_unit, unit.detach()), (got_hvp, hvp)):
        assert got.dtype == torch.float64
        assert_allclose(got.numpy(), want.numpy(), rtol=0,
                        atol=1e-9 * float(want.abs().max()))


# ----------------------------------------------------------------------
# (d): the prior


@pytest.mark.parametrize("name,shape,fused", [
    ("builtin-8x8-v1", (32, 128), "auto"),
    ("builtin-8x8-v1", (32, 128), "off"),
    ("astro-snr-v1", (40, 64), "auto"),
    ("random-4x4", (40, 64), "auto"),
])
@pytest.mark.parametrize("spin", [True, False])
def test_marginalised_prior_value_and_gradient(name, shape, fused, spin):
    rs = np.random.RandomState(8)
    flux = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)[None, None]
    key = jax.random.PRNGKey(5)
    gmm_j, gmm_t, stride = gmm_pair(name)

    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride, cycle_spin=spin,
                               marginalize=True)
    with j_force_pallas("interpret"), j_force_fused(fused):
        value_j, grad_j = jax.value_and_grad(
            lambda f: prior_j(f, key=key)
        )(jnp.asarray(flux))

    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=stride, cycle_spin=spin,
                               marginalize=True)
    x = torch.as_tensor(flux).requires_grad_(True)
    shifts = jax_shifts(key, prior_t.patch_shape) if spin else None
    tf.reset_counters()
    tp.reset_counters()
    with force_fused(fused):
        on_fused = prior_t._fused_ok(shape)
        assert prior_t.second_order_ok(shape) == (not on_fused)
        value_t = prior_t(x, shifts=shifts)
        value_t.backward()
    assert on_fused == (name != "random-4x4" and fused == "auto")
    # the grouped branch follows the default dial ("split") where the GMM
    # has split buffers (8x8 patches)
    marg_calls = (tf.fused_backward_marg_plain.calls if on_fused
                  else tp.unit_marg_plain.calls if name == "random-4x4"
                  else tf.marg_unit_split_plain.calls)
    assert marg_calls == 1

    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))


# ----------------------------------------------------------------------
# (e): the deconvolver


def run_deconvolver(package, gmm, datasets, marginalize, **kwargs):
    comp = package.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32),
        prior=package.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False,
                                    marginalize=marginalize),
    )
    deco = package.MAPDeconvolver(
        n_epochs=20, learning_rate=0.1, update_strategy="joint",
        trace_every=0, seed=0, compute_error=True, **kwargs)
    flux = deco.run(datasets, components=comp).components["flux"]
    return flux.flux_upsampled_numpy, flux.flux_upsampled_error_numpy


def test_map_deconvolver_marginalised_matches_jax():
    """20 joint Adam steps and the flux-error probe under the
    marginalised ``builtin-8x8-v1`` prior (3 observations of 128²)."""
    datasets = make_datasets(3)
    gmm_j = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    gmm_t = gmm_from_arrays(np.asarray(gmm_j.means),
                            np.asarray(gmm_j.covariances),
                            np.asarray(gmm_j.weights), gmm_j.meta.stride)

    with j_force_pallas("interpret"):
        flux_j, errors_j = run_deconvolver(
            jj, gmm_j, datasets, True, scan_epochs=True,
            display_progress=False)
    tf.reset_counters()
    tp.reset_counters()
    flux_t, errors_t = run_deconvolver(jt, gmm_t, datasets, True,
                                       device="cpu")
    # training on the fused scorer, the probe on the patch-level one;
    # the default dial's "split" logits in both, and in both directions:
    # 20 steps and one probe each, no float32 scorer
    assert tf.fused_forward_plain.calls == 20
    assert tf.fused_backward_marg_plain.calls == 20
    assert tf.score_split_marg_plain.calls == 21
    assert tf.marg_unit_split_plain.calls == 21
    assert (tp.hvp_marg_weights_split_plain.calls,
            tp.hvp_marg_mix_plain.calls) == (1, 1)
    assert (tp.score_rows_plain.calls, tp.unit_marg_plain.calls,
            tp.hvp_marg_weights_plain.calls) == (0, 0, 0)

    assert_allclose(flux_t, flux_j, rtol=5e-3)
    assert np.isfinite(errors_t).all() and (errors_t > 0).all()
    assert_allclose(errors_t, errors_j, rtol=1e-3)

    # at the trained flux, the port's marginalise gradient is closer to
    # the float64 one than the JAX kernels' is
    img = flux_j.astype(np.float32)

    def grad_t(dtype):
        bufs = {k: v.to(dtype) for k, v in
                gmm_t.kernel_buffers("cpu").items()}
        x = torch.as_tensor(img, dtype=dtype).requires_grad_(True)
        values, _, valid = tf.gmm_score_fused_image(
            x, (8, 8), STRIDE, bufs, ZERO_FLUX_SENTINEL, marginalize=True)
        torch.where(valid, values, torch.zeros_like(values)).sum().backward()
        return x.grad.double().numpy()

    def scalar_j(x):
        values, _, valid = jax_fused(gmm_j, x)
        return jnp.sum(jnp.where(valid, values, 0.0))

    grad64 = grad_t(torch.float64)
    err_t = np.abs(grad_t(torch.float32) - grad64).max()
    err_j = np.abs(np.asarray(jax.grad(scalar_j)(jnp.asarray(img)),
                              np.float64) - grad64).max()
    assert err_t <= err_j


def mixed_gmm_arrays():
    """A random SPD GMM (K = 8) whose softmax weights stay mixed along the
    run below (the largest weight of a patch is near 0.2)."""
    rs = np.random.RandomState(3)
    a = rs.randn(8, 64, 64) / 2.0
    covariances = a @ a.transpose(0, 2, 1) + 2.0 * np.eye(64)
    return 0.3 * rs.randn(8, 64), covariances, rs.dirichlet(np.ones(8))


def test_map_deconvolver_marginalised_mixed_weights_matches_jax():
    """20 joint Adam steps and the flux-error probe under a GMM whose
    weights are mixed (3 observations of 128²), where the marginalised
    prior and the MAP one part: flux and errors rtol 1e-4 against the
    JAX package (the bars of ``tests/test_torch_errors.py``), and the
    marginalised flux stands apart from the MAP one by more than ten
    times that, so that a prior that scored by the best component would
    fail. The errors differ from MAP's only through the flux: the
    probe's tangent, ones, is the zero patch after mean subtraction, so
    the prior adds nothing to them (the op-level tests above hold the
    Hessian action along random tangents)."""
    datasets = make_datasets(3)
    arrays = mixed_gmm_arrays()
    gmm_j = JGMM.from_numpy(*arrays)
    gmm_t = gmm_from_arrays(*arrays, None)
    with j_force_pallas("interpret"):
        flux_j, errors_j = run_deconvolver(
            jj, gmm_j, datasets, True, scan_epochs=True,
            display_progress=False)
    tf.reset_counters()
    tp.reset_counters()
    flux_t, errors_t = run_deconvolver(jt, gmm_t, datasets, True,
                                       device="cpu")
    assert tf.fused_backward_marg_plain.calls == 20
    assert tf.score_split_marg_plain.calls == 21
    assert tf.marg_unit_split_plain.calls == 21
    assert tp.hvp_marg_weights_split_plain.calls == 1
    assert tp.hvp_marg_mix_plain.calls == 1
    flux_map, errors_map = run_deconvolver(jt, gmm_t, datasets, False,
                                           device="cpu")

    # the weights at the trained flux are mixed
    bufs = gmm_t.kernel_buffers("cpu")
    lse, _, valid, xtn = tf.fused_forward_plain(
        torch.as_tensor(flux_t), bufs, STRIDE, ZERO_FLUX_SENTINEL, True)
    m = valid > 0.5
    largest = torch.cat([p.max(dim=1).values for _, p in
                         tf.softmax_chunks(xtn[m], lse[m], bufs)])
    assert float(largest.max()) < 0.9

    assert_allclose(flux_t, flux_j, rtol=1e-4)
    assert_allclose(errors_t, errors_j, rtol=1e-4)
    assert np.max(np.abs(flux_t - flux_map) / flux_map) > 1e-3
    assert not np.array_equal(errors_t, errors_map)


# ----------------------------------------------------------------------
# (f): no silent zero beyond what is implemented


def test_third_order_and_fused_second_order_raise(rows):
    bufs = TGMM.from_registry("builtin-8x8-v1").kernel_buffers("cpu")
    x = torch.as_tensor(rows[:32]).requires_grad_(True)
    t = torch.as_tensor(np.random.RandomState(9).randn(32, 64),
                        dtype=torch.float32)
    values, _ = tp.gmm_score_patches(x, bufs, marginalize=True)
    (grad,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x, grad_outputs=t, create_graph=True)
    with pytest.raises(RuntimeError, match="third derivative"):
        torch.autograd.grad(hvp.sum(), x)

    prior = jt.GMMPatchPrior(gmm=TGMM.from_registry("builtin-8x8-v1"),
                             cycle_spin=False, marginalize=True)
    flux = torch.as_tensor(make_image((16, 128))[None, None]).abs()
    flux.requires_grad_(True)
    assert prior._fused_ok(flux.shape)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(prior(flux), flux, create_graph=True)


# ----------------------------------------------------------------------
# the CPU numbers quoted in PERF.md:
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_marginalise.py


def main():
    from jolideco_torch.ops.gmm_fused import softmax_chunks

    # nonzero softmax weights of a 64² uniform image under astro-snr-v1
    gmm_t = TGMM.from_registry("astro-snr-v1")
    bufs = gmm_t.kernel_buffers("cpu")
    img = np.random.RandomState(0).uniform(0.1, 2.0, (64, 64))
    lse, _, valid, xtn = tf.fused_forward_plain(
        torch.as_tensor(img, dtype=torch.float32), bufs, STRIDE,
        ZERO_FLUX_SENTINEL, True)
    m = valid > 0.5
    nonzero = sum(int((p > 0).sum())
                  for _, p in softmax_chunks(xtn[m], lse[m], bufs))
    print(f"nonzero weights, 64² astro-snr-v1: {nonzero} of "
          f"{int(m.sum())} x {gmm_t.n_components}")

    # the JAX prior's default CPU dispatch against its kernels
    name, shape = "builtin-8x8-v1", (32, 128)
    gmm_j, _, stride = gmm_pair(name)
    flux = np.random.RandomState(8).uniform(0.1, 2.0, shape)
    flux = jnp.asarray(flux.astype(np.float32)[None, None])
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride, cycle_spin=False,
                               marginalize=True)
    grad_scan = np.asarray(jax.grad(prior_j)(flux))
    with j_force_pallas("interpret"):
        grad_kernels = np.asarray(jax.grad(prior_j)(flux))
    dev = np.abs(grad_scan - grad_kernels).max() / np.abs(grad_kernels).max()
    print(f"JAX prior gradient, XLA scan against interpret kernels: max "
          f"deviation {dev:.3g} of max-abs")

    # the deconvolver: port against JAX, and both against float64
    datasets = make_datasets(3)
    gmm_t = gmm_from_arrays(np.asarray(gmm_j.means),
                            np.asarray(gmm_j.covariances),
                            np.asarray(gmm_j.weights), gmm_j.meta.stride)
    with j_force_pallas("interpret"):
        flux_j, err_j = run_deconvolver(jj, gmm_j, datasets, True,
                                        scan_epochs=True,
                                        display_progress=False)
    flux_t, err_t = run_deconvolver(jt, gmm_t, datasets, True, device="cpu")
    print(f"20 steps, port against JAX: flux max rel "
          f"{np.max(np.abs(flux_t - flux_j) / flux_j):.3g}, errors "
          f"{np.max(np.abs(err_t - err_j) / err_j):.3g}")

    img = flux_j.astype(np.float32)
    grads = {}
    for dtype in (torch.float64, torch.float32):
        b = {k: v.to(dtype) for k, v in gmm_t.kernel_buffers("cpu").items()}
        x = torch.as_tensor(img, dtype=dtype).requires_grad_(True)
        values, _, valid = tf.gmm_score_fused_image(
            x, (8, 8), STRIDE, b, ZERO_FLUX_SENTINEL, marginalize=True)
        torch.where(valid, values, torch.zeros_like(values)).sum().backward()
        grads[dtype] = x.grad.double().numpy()

    def scalar_j(x):
        values, _, valid = jax_fused(gmm_j, x)
        return jnp.sum(jnp.where(valid, values, 0.0))

    g64 = grads[torch.float64]
    scale = np.abs(g64).max()
    g_j = np.asarray(jax.grad(scalar_j)(jnp.asarray(img)), np.float64)
    print(f"prior gradient at the trained flux against float64 (share of "
          f"max-abs): port float32 "
          f"{np.abs(grads[torch.float32] - g64).max() / scale:.3g}, "
          f"JAX kernels {np.abs(g_j - g64).max() / scale:.3g}")


if __name__ == "__main__":
    main()
