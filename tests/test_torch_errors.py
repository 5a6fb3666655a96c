"""Second order in the port against ``jolideco_tpu``: the Hessian probe
behind ``compute_error=True``.

The port takes the probe reverse over reverse (the gradient with
``create_graph=True``, then the gradient of its dot product with the
tangent); the JAX package forward over reverse (``jax.jvp`` of
``jax.grad``). The loss Hessian is symmetric, so both give ``H · t``.
The JAX prior runs its Pallas kernels in interpret mode with the fused
scorer forced off, as its own probe runs it; the port runs the plain
versions of its kernels (CPU tensors). Under both packages' default
dial the MAP scorer's logits are the ``"split"`` mode's (the JAX kernel
at HIGH, the port's split plain version). Tolerances, each with its
reason:

- prior value rtol 1e-5 and gradient 1e-4 of its max-abs (float32 sums
  in different orders; the JAX backward reads ``A`` as a bf16 hi/lo
  pair, about 16 significant bits); the prior's Hessian action along a
  random tangent 1e-4 of its max-abs (the JAX package's own bar);
- the stacked Poisson loss's Hessian action 1e-5 of its max-abs (float32
  FFTs on both sides);
- ``hessian_diagonals`` and ``fluxes_error``: rtol 1e-4;
- ``MAPDeconvolver(compute_error=True)`` errors after 20 steps: rtol
  1e-4 (the flux maps agree to rtol 1e-4, ``tests/test_torch_slice.py``).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.config import force_fused, use_fused
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.ops import gmm_pallas as tp
from jolideco_torch.ops.fft import convolve_fft_precomputed, kernel_fft
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.config import force_fused as j_force_fused
from jolideco_tpu.config import force_pallas as j_force_pallas
from test_torch_slice import (  # noqa: E402  (tests/ is on sys.path)
    jax_setup,
    make_datasets,
    torch_setup,
)
from test_torch_stacked import make_datasets as make_stacked_datasets

torch.set_num_threads(1)
SIZE = 64


def random_flux(seed, size=SIZE):
    rs = np.random.RandomState(seed)
    return rs.uniform(0.5, 2.0, (size, size)).astype(np.float32)


def torch_hvp(fn, x, tangent):
    """``H · tangent`` of the scalar ``fn`` at ``x``, reverse over reverse."""
    x = torch.as_tensor(x).requires_grad_(True)
    value = fn(x)
    (grad,) = torch.autograd.grad(value, x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x,
                                 grad_outputs=torch.as_tensor(tangent))
    return value.item(), grad.detach().numpy(), hvp.numpy()


def jax_hvp(fn, x, tangent):
    value, grad = jax.value_and_grad(fn)(jnp.asarray(x))
    _, hvp = jax.jvp(jax.grad(fn), (jnp.asarray(x),), (jnp.asarray(tangent),))
    return float(value), np.asarray(grad), np.asarray(hvp)


def test_fused_scorer_refuses_second_order():
    """A graph through the fused scorer's backward raises, alone and
    beside the Poisson term (where a silent zero would hide among the
    Poisson term's second derivatives); the patch-level path does not."""
    prior = jt.GMMPatchPrior(
        gmm=jt.GaussianMixtureModel.from_registry("builtin-8x8-v1"),
        cycle_spin=False,
    )
    x = torch.as_tensor(random_flux(0)[None, None]).requires_grad_(True)
    assert prior._fused_ok(x.shape) and not prior.second_order_ok(x.shape)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(prior(x), x, create_graph=True)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad((x**2).sum() - prior(x), x, create_graph=True)
    # first order is unaffected
    (grad,) = torch.autograd.grad(prior(x), x)
    assert torch.isfinite(grad).all()

    with force_fused("off"):
        assert prior.second_order_ok(x.shape)
        (grad,) = torch.autograd.grad(prior(x), x, create_graph=True)
        (hvp,) = torch.autograd.grad(grad, x, grad_outputs=torch.ones_like(x))
    assert torch.isfinite(hvp).all()


@pytest.mark.parametrize("name", ["builtin-8x8-v1", "astro-snr-v1"])
def test_prior_hvp_matches_jax(name):
    flux = random_flux(1)[None, None]
    tangent = np.random.RandomState(2).randn(*flux.shape).astype(np.float32)
    prior_j = jj.GMMPatchPrior(gmm=jj.GaussianMixtureModel.from_registry(name),
                               stride=4, cycle_spin=False)
    prior_t = jt.GMMPatchPrior(gmm=jt.GaussianMixtureModel.from_registry(name),
                               stride=4, cycle_spin=False)

    with j_force_fused("off"), j_force_pallas("interpret"):
        value_j, grad_j, hvp_j = jax_hvp(prior_j, flux, tangent)
        _, _, ones_j = jax_hvp(prior_j, flux, np.ones_like(flux))
    tp.reset_counters()
    tf.reset_counters()
    with force_fused("off"):
        value_t, grad_t, hvp_t = torch_hvp(prior_t, flux, tangent)
        _, _, ones_t = torch_hvp(prior_t, flux, np.ones_like(flux))
    assert tf.fused_forward_plain.calls == 0
    # the default dial's MAP scorer: the split plain version, as the JAX
    # kernel runs at its default HIGH
    assert tf.score_split_plain.calls == 2 and tp.score_rows_plain.calls == 0
    assert tp.hvp_map_plain.calls == 2

    assert_allclose(value_t, value_j, rtol=1e-5)
    assert_allclose(grad_t, grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))
    assert_allclose(hvp_t, hvp_j, rtol=0,
                    atol=1e-4 * float(np.abs(hvp_j).max()))
    # The prior adds nothing to H · 1 in either package: the ones
    # tangent is a constant patch, which the mean subtraction maps to 0.
    for ones, hvp in ((ones_t, hvp_t), (ones_j, hvp_j)):
        assert np.abs(ones).max() <= 1e-6 * np.abs(hvp).max()


def test_convolution_is_twice_differentiable():
    """``_ConvolveFFT`` in float64: second derivatives by finite
    differences (``gradgradcheck``), the spectrum broadcast over a
    stack."""
    rs = np.random.RandomState(3)
    kernel = torch.as_tensor(rs.rand(5, 5))
    kft = kernel_fft(kernel, (12, 10))
    image = torch.tensor(rs.rand(2, 12, 10), requires_grad=True)

    def fn(x):
        return convolve_fft_precomputed(x, kft, (16, 14)) ** 2

    assert torch.autograd.gradcheck(fn, (image,))
    assert torch.autograd.gradgradcheck(fn, (image,))


def test_stacked_poisson_hvp_matches_jax():
    from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
    from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

    datasets = make_stacked_datasets(3)
    flux = random_flux(4)[None, None]
    tangent = np.random.RandomState(5).randn(*flux.shape).astype(np.float32)
    comps_j = jj.FluxComponents({"flux": jj.SpatialFluxComponent.from_numpy(
        flux[0, 0])})
    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        flux[0, 0])})
    loss_j = JStacked.from_datasets(datasets, comps_j, conv_mode="fft")
    loss_t = TStacked.from_datasets(datasets, comps_t, conv_mode="fft",
                                    device="cpu")

    value_j, grad_j, hvp_j = jax_hvp(lambda f: loss_j((f,)), flux, tangent)
    value_t, grad_t, hvp_t = torch_hvp(lambda f: loss_t((f,)), flux, tangent)
    assert_allclose(value_t, value_j, rtol=1e-5)
    assert_allclose(hvp_t, hvp_j, rtol=0,
                    atol=1e-5 * float(np.abs(hvp_j).max()))


def probe_setups(n_obs=2):
    """The same total loss in both packages on a 2-observation 64² stack
    (StackedPoissonLoss, FFT), ``builtin-8x8-v1`` prior, stride 4."""
    datasets = make_stacked_datasets(n_obs)
    gmm_j = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    comp_j = jj.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32),
        prior=jj.GMMPatchPrior(gmm=gmm_j, stride=4, cycle_spin=False),
    )
    deco_j = jj.MAPDeconvolver(update_strategy="joint", trace_every=0,
                               display_progress=False, conv_mode="fft")
    total_j = deco_j.build_loss(datasets, components=comp_j)

    gmm_t = gmm_from_arrays(np.asarray(gmm_j.means),
                            np.asarray(gmm_j.covariances),
                            np.asarray(gmm_j.weights), gmm_j.meta.stride)
    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32),
        prior=jt.GMMPatchPrior(gmm=gmm_t, stride=4, cycle_spin=False),
    )})
    deco_t = jt.MAPDeconvolver(update_strategy="joint", trace_every=0,
                               device="cpu", conv_mode="fft")
    total_t = deco_t.build_loss(datasets, components=comps_t,
                                device=torch.device("cpu"))
    return total_j, total_t


def test_hessian_diagonals_and_fluxes_error_match_jax():
    total_j, total_t = probe_setups()
    flux = random_flux(6)[None, None]

    with j_force_pallas("interpret"):
        (hess_j,) = total_j.hessian_diagonals((jnp.asarray(flux),))
        errors_j = total_j.fluxes_error((jnp.asarray(flux),))

    tf.reset_counters()
    tp.reset_counters()
    (hess_t,) = total_t.hessian_diagonals((torch.as_tensor(flux),))
    # the fused scorer applies at this shape, so the probe turned it off
    assert tf.fused_forward_plain.calls == 0
    assert (tf.score_split_plain.calls, tp.score_rows_plain.calls,
            tp.unit_map_plain.calls, tp.hvp_map_plain.calls) == (1, 0, 1, 1)
    errors_t = total_t.fluxes_error((torch.as_tensor(flux),))
    assert list(errors_t) == ["flux"]
    assert use_fused() == "auto"

    hess_j = np.asarray(hess_j)
    assert (hess_j > 0).all()
    assert_allclose(hess_t.numpy(), hess_j, rtol=1e-4)
    assert_allclose(errors_t["flux"].numpy(), np.asarray(errors_j["flux"]),
                    rtol=1e-4)


def test_map_deconvolver_errors_match_jax():
    datasets = make_datasets(2)
    gmm_j, comp_j, deco_j = jax_setup(datasets)
    comp_t, deco_t = torch_setup(gmm_j)
    deco_j.compute_error = True
    deco_t.compute_error = True
    assert deco_t.to_dict()["compute_error"]

    result_j = deco_j.run(datasets, components=comp_j)
    result_t = deco_t.run(datasets, components=comp_t)
    errors_j = result_j.components["flux"].flux_upsampled_error_numpy
    errors_t = result_t.components["flux"].flux_upsampled_error_numpy
    assert errors_t.shape == (128, 128)
    assert np.isfinite(errors_t).all() and (errors_t > 0).all()
    assert result_t.error_seconds > 0
    assert_allclose(errors_t, errors_j, rtol=1e-4)
