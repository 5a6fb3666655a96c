"""``conv_mode="pfft"`` in the port against the JAX package, end to end.

The JAX package runs its matrix-DFT kernels in the Pallas interpreter
(``force_pallas("interpret")``) under its default precision dial
(``"high"``), which gives them the ``"split"`` mode (bf16 hi/lo
products, 3.1e-5 of the result's max-abs at the benchmark shape,
``jolideco_tpu/ops/pallas_fft.py:86-102``); the port runs its plain
version (CPU tensors) under its own default dial, also ``"split"``. 32² images pad to 128 (n = 256); 3
observations are a pair and an odd tail, 4 are two pairs. Tolerances:

- per-observation losses rtol 1e-5 (the ``"fft"`` test's bar, 2.1e-6
  measured) and the flux gradient within 3.1e-5 of its max-abs (split's
  error; 1.4e-6 measured);
- after 20 Adam steps and the flux-error probe: flux rtol 2e-4 and atol
  1e-5 (the JAX package's own bar between its pfft and fft runs,
  ``tests/test_conv_modes_e2e.py``; 2.0e-5 measured) and errors rtol 1e-4
  (9.2e-6 measured); against the port's own ``"fft"`` run, both float32,
  rtol 1e-5 (9.7e-7 and 3.4e-7 measured).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.ops import pallas_fft as pf
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_tpu.config import force_pallas
from jolideco_tpu.data import gauss_and_point_sources_gauss_psf
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

torch.set_num_threads(1)
EPOCHS = 20


def make_datasets(n_obs):
    rs = np.random.RandomState(642020)
    return {f"{idx}": gauss_and_point_sources_gauss_psf(random_state=rs)
            for idx in range(n_obs)}


@pytest.mark.parametrize("n_obs", [3, 4])
def test_stacked_loss_and_gradient_match_jax(n_obs):
    datasets = make_datasets(n_obs)
    flux = np.random.RandomState(9).uniform(0.5, 2.0, (32, 32)).astype(
        np.float32)
    comps_j = jj.FluxComponents({"flux": jj.SpatialFluxComponent.from_numpy(
        flux)})
    with force_pallas("interpret"):
        loss_j = JStacked.from_datasets(datasets, comps_j, conv_mode="pfft")
        f_j = jnp.asarray(flux)[None, None]
        losses_j = np.asarray(loss_j.evaluate((f_j,)))
        grad_j = np.asarray(jax.grad(lambda f: loss_j((f,)))(f_j))

    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        flux)})
    loss_t = TStacked.from_datasets(datasets, comps_t, conv_mode="pfft",
                                    device="cpu")
    assert loss_t.pfft_ns == {"flux": 256} == dict(loss_j.pfft_ns)
    # the JAX package transforms in complex64, the port in complex128
    planes_j = [np.asarray(p) for p in loss_j.pfft_pairs["flux"]]
    scale = max(float(np.abs(p).max()) for p in planes_j)
    for got, want in zip(loss_t.pfft_pairs["flux"], planes_j):
        assert got.shape == (n_obs // 2, 1, 1, 256, 256)
        assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    f_t = torch.as_tensor(flux)[None, None].requires_grad_(True)
    pf.reset_counters()
    losses_t = loss_t.evaluate((f_t,))
    loss_t((f_t,)).backward()
    # two forwards, one adjoint; an odd tail takes the rfft2
    assert pf.conv_packed_pfft_plain.calls == 3

    assert_allclose(losses_t.detach().numpy(), losses_j, rtol=1e-5)
    assert_allclose(f_t.grad.numpy(), grad_j, rtol=0,
                    atol=3.1e-5 * float(np.abs(grad_j).max()))


def build_components(pkg):
    rs = np.random.RandomState(642020)
    return pkg.FluxComponents({"flux": pkg.SpatialFluxComponent.from_numpy(
        rs.gamma(20, size=(32, 32)), prior=pkg.UniformPrior())})


def test_deconvolver_with_errors_matches_jax_and_fft():
    datasets = make_datasets(3)
    deco_j = jj.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                               display_progress=False,
                               update_strategy="joint", conv_mode="pfft",
                               compute_error=True)
    with force_pallas("interpret"):
        comp_j = deco_j.run(datasets=datasets,
                            components=build_components(jj)).components
    results = {}
    for mode in ("pfft", "fft"):
        pf.reset_counters()
        deco = jt.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                                 update_strategy="joint", trace_every=0,
                                 conv_mode=mode, compute_error=True,
                                 device="cpu")
        results[mode] = deco.run(datasets, components=build_components(jt)).components
        # pfft: a forward and an adjoint per step; the probe's forward,
        # adjoint, and the adjoint's adjoint beside the adjoint again
        assert pf.conv_packed_pfft_plain.calls == (
            2 * EPOCHS + 4 if mode == "pfft" else 0)

    got = results["pfft"]["flux"]
    errors = got.flux_upsampled_error_numpy
    assert np.isfinite(errors).all() and (errors > 0).all()
    assert_allclose(got.flux_upsampled_numpy,
                    comp_j["flux"].flux_upsampled_numpy, rtol=2e-4,
                    atol=1e-5)
    assert_allclose(errors, comp_j["flux"].flux_upsampled_error_numpy,
                    rtol=1e-4)
    fft = results["fft"]["flux"]
    assert_allclose(got.flux_upsampled_numpy, fft.flux_upsampled_numpy,
                    rtol=1e-5)
    assert_allclose(errors, fft.flux_upsampled_error_numpy, rtol=1e-5)


def test_gmm_prior_run_matches_fft():
    """``chip_smoke.py``'s small run (4 × 128², no padding, n = 256, the
    GMM patch prior without cycle spin, 20 steps and the probe), pfft
    against fft in the port. Bar: flux and errors rtol 1e-4
    (``BASELINE.md``'s for flux maps; 6.6e-5 and 1.5e-6 measured: Adam's
    first step amplifies the convolutions' 4e-7 difference where a
    gradient is near zero)."""
    from jolideco_torch.utils.bench_data import make_datasets as bench

    datasets = bench(n_obs=4, size=128, psf_size=9, seed=1)
    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    results = {}
    for mode in ("pfft", "fft"):
        comp = jt.SpatialFluxComponent.from_numpy(
            np.ones((128, 128), np.float32),
            prior=jt.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False))
        deco = jt.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                                 update_strategy="joint", trace_every=0,
                                 conv_mode=mode, compute_error=True,
                                 device="cpu", seed=0)
        results[mode] = deco.run(datasets, components=comp).components["flux"]
    for name in ("flux_upsampled_numpy", "flux_upsampled_error_numpy"):
        assert_allclose(getattr(results["pfft"], name),
                        getattr(results["fft"], name), rtol=1e-4)


def test_auto_is_fft():
    deco = jt.MAPDeconvolver(update_strategy="joint", trace_every=0,
                             device="cpu")
    assert deco.conv_mode == "auto"
    comps = build_components(jt)
    loss = deco.build_loss(make_datasets(2), components=comps,
                           device=torch.device("cpu"))
    assert loss.poisson_loss.conv_mode == "fft"
    assert loss.poisson_loss.pfft_pairs is None
    single = jt.MAPDeconvolver(update_strategy="joint", trace_every=0,
                               device="cpu", conv_mode="pfft")
    loss = single.build_loss(make_datasets(1), components=comps,
                             device=torch.device("cpu"))
    # one observation has no pair: the rfft2 path
    assert loss.poisson_loss.conv_mode == "pfft"
    assert loss.poisson_loss.pfft_pairs is None
