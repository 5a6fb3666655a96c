"""Paths the port chooses from the data, against ``jolideco_tpu``: the joint
strategy's fallback to per-dataset models, and GMMs of patches other
than 8x8 on the plain scorer.

The fallback: when the stacked build raises a plain ``ValueError`` the
joint strategy logs "Cannot stack observations (...); falling back to
per-dataset forward models" and builds ``PoissonLoss`` for the training
and the validation data, as the JAX package does. Three data reach it:
an RMF on some datasets only, band counts that differ between datasets,
and components whose first does not need the largest FFT shape (x1 then
x2). A `DataValidationError` and any error under an explicit
``fft_shape`` propagate. A GMM of 6x6 patches (d = 36) has no kernel in
either package; the port scores it with its plain scorer on any device
(``ops.gmm_pallas.route``), the JAX package with its XLA scorer.
Tolerances:

- the fallback's losses against the JAX package's ``PoissonLoss``: rtol
  1e-5 (float32 FFTs in other orders); 10 joint epochs on it: flux rtol
  1e-4 (the ``BASELINE.md`` bar for flux maps);
- the 6x6 prior: value rtol 1e-5, gradient 1e-5 of its max-abs
  (``tests/test_torch_prior.py``'s bars).
"""

import logging

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.loss import PoissonLoss
from jolideco_torch.ops import gmm_pallas as gp
from jolideco_torch.parallel import DataValidationError
from jolideco_torch.utils.bench_data import band_rmf, make_datasets
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.loss import PoissonLoss as JPoissonLoss
from jolideco_tpu.parallel.stacked import (
    DataValidationError as JDataValidationError,
)
from jolideco_tpu.priors.patches.gmm import GaussianMixtureModelMeta

torch.set_num_threads(1)
N_OBS, SIZE, EPOCHS = 3, 16, 10


def band_datasets(rmf=True, seed=0):
    """3 x 16² datasets of two bands (with ``rmf`` a 2 x 2 RMF each)."""
    rng = np.random.RandomState(seed)
    datasets = {}
    for i in range(N_OBS):
        psf = rng.uniform(0, 1, (2, 5, 5)).astype(np.float32)
        psf /= psf.sum(axis=(1, 2), keepdims=True)
        datasets[f"o{i}"] = {
            "counts": rng.poisson(3.0, (2, SIZE, SIZE)).astype(np.float32),
            "background": np.full((2, SIZE, SIZE), 0.5, np.float32),
            "exposure": rng.uniform(0.8, 1.2, (2, SIZE, SIZE)).astype(
                np.float32),
            "psf": psf,
        }
        if rmf:
            datasets[f"o{i}"]["rmf"] = band_rmf(2)
    return datasets


def flux_components(pkg, factors=(1,)):
    rs = np.random.RandomState(4)
    return pkg.FluxComponents({
        f"c{i}": pkg.SpatialFluxComponent.from_numpy(
            rs.uniform(0.5, 2.0, (SIZE, SIZE)), upsampling_factor=factor)
        for i, factor in enumerate(factors)})


def _mixed_rmf():
    datasets = band_datasets()
    datasets["o2"].pop("rmf")
    return datasets, (1,)


def _band_counts():
    datasets = band_datasets(rmf=False)
    d = datasets["o1"]
    for key in ("counts", "background", "exposure", "psf"):
        d[key] = d[key][0]
    return datasets, (1,)


def _fft_shapes():
    datasets = make_datasets(n_obs=N_OBS, size=SIZE, psf_size=5, seed=2)
    return datasets, (1, 2)


FALLBACKS = {"mixed-rmf": _mixed_rmf, "band-counts": _band_counts,
             "fft-shapes": _fft_shapes}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_joint_strategy_falls_back_to_per_dataset_models(case, caplog):
    datasets, factors = FALLBACKS[case]()
    validation = {f"v-{name}": d for name, d in datasets.items()}
    comps_t = flux_components(jt, factors)
    deco = jt.MAPDeconvolver(update_strategy="joint", device="cpu")
    with caplog.at_level(logging.WARNING, logger="jolideco_torch.core"):
        total = deco.build_loss(datasets, datasets_validation=validation,
                                components=comps_t)
    messages = [r.getMessage() for r in caplog.records]
    assert sum("Cannot stack observations" in m and "falling back to "
               "per-dataset forward models" in m for m in messages) == 1
    assert isinstance(total.poisson_loss, PoissonLoss)
    assert isinstance(total.poisson_loss_validation, PoissonLoss)
    comps_j = flux_components(jj, factors)
    want = np.asarray(JPoissonLoss.from_datasets(datasets, comps_j).evaluate(
        comps_j.to_flux_tuple()))
    fluxes = comps_t.to_flux_tuple()
    for loss in (total.poisson_loss, total.poisson_loss_validation):
        assert_allclose(loss.evaluate(fluxes).numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("case", ["data-validation", "fft-shape"])
def test_fallback_reraises(case):
    """Data that neither path takes, and an explicit ``fft_shape``, do
    not fall back."""
    if case == "data-validation":
        datasets = band_datasets()
        for d in datasets.values():
            d["rmf"] = np.ones((3, 2), np.float32) / 2
        deco = jt.MAPDeconvolver(update_strategy="joint", device="cpu")
        error, match = DataValidationError, "input"
        factors = (1,)
        with pytest.raises(JDataValidationError, match=match):
            jj.MAPDeconvolver(update_strategy="joint").build_loss(
                datasets, components=flux_components(jj))
    else:
        datasets, factors = _fft_shapes()
        # large enough for the x1 component, too small for the x2 one
        deco = jt.MAPDeconvolver(update_strategy="joint", device="cpu",
                                 fft_shape=(24, 24))
        error, match = ValueError, "too small"
    with pytest.raises(error, match=match):
        deco.build_loss(datasets, components=flux_components(jt, factors))


def test_fallback_run_matches_jax():
    """10 joint epochs on the per-dataset models of an RMF on some
    datasets only, against the JAX package's run."""
    datasets, _ = _mixed_rmf()
    runs = {}
    for pkg in (jt, jj):
        kwargs = {"device": "cpu"} if pkg is jt else {
            "display_progress": False}
        deco = pkg.MAPDeconvolver(n_epochs=EPOCHS, update_strategy="joint",
                                  **kwargs)
        runs[pkg] = deco.run(datasets, components=flux_components(pkg))
    flux_j = runs[jj].components["c0"].flux_upsampled_numpy
    assert_allclose(runs[jt].components["c0"].flux_upsampled_numpy, flux_j,
                    rtol=1e-4)
    assert_allclose(runs[jt].trace_loss["total"], runs[jj].trace_loss["total"],
                    rtol=1e-4)


def gmm_6x6_pair(k=5, seed=3):
    rs = np.random.RandomState(seed)
    means = 0.3 * rs.randn(k, 36)
    covariances = np.stack([a @ a.T / 36 + 0.1 * np.eye(36)
                            for a in rs.randn(k, 36, 36)])
    weights = rs.dirichlet(np.ones(k))
    gmm_j = jj.GaussianMixtureModel.from_numpy(
        means, covariances, weights, meta=GaussianMixtureModelMeta(stride=3))
    return gmm_j, gmm_from_arrays(means, covariances, weights, 3)


@pytest.mark.parametrize("marginalize", [False, True])
def test_gmm_of_6x6_patches_matches_jax(marginalize):
    """The prior's value and gradient on the patch-level branch (no
    spin, stride 3), and the route the rows take: the plain scorer."""
    gmm_j, gmm_t = gmm_6x6_pair()
    flux = np.random.RandomState(8).uniform(
        0.1, 2.0, (1, 1, 30, 36)).astype(np.float32)
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=3, cycle_spin=False,
                               marginalize=marginalize)
    value_j, grad_j = jax.jit(jax.value_and_grad(lambda f: prior_j(f)))(
        jnp.asarray(flux))
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=3, cycle_spin=False,
                               marginalize=marginalize)
    assert prior_t.patch_shape == (6, 6) and not prior_t._fused_ok(
        flux.shape)
    x = torch.as_tensor(flux).requires_grad_(True)
    gp.reset_counters()
    value_t = prior_t(x)
    value_t.backward()
    assert gp.score_rows_plain.calls == 1
    assert gp.route(torch.zeros(2, 36)) == gp.route(torch.zeros(2, 64)) \
        == "plain"
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-5 * float(np.abs(grad_j).max()))


def test_deconvolver_with_a_6x6_gmm_matches_jax():
    """10 joint epochs under the 6x6 GMM prior (no spin) and the
    flux-error probe, against the JAX package's run."""
    gmm_j, gmm_t = gmm_6x6_pair()
    datasets = make_datasets(n_obs=N_OBS, size=24, psf_size=5, seed=5)
    runs = {}
    for pkg, gmm in ((jt, gmm_t), (jj, gmm_j)):
        kwargs = {"device": "cpu"} if pkg is jt else {
            "display_progress": False}
        deco = pkg.MAPDeconvolver(n_epochs=EPOCHS, update_strategy="joint",
                                  compute_error=True, **kwargs)
        comp = pkg.SpatialFluxComponent.from_numpy(
            np.ones((24, 24)), prior=pkg.GMMPatchPrior(
                gmm=gmm, stride=3, cycle_spin=False))
        runs[pkg] = deco.run(datasets, components=comp)
    got, want = runs[jt].components["flux"], runs[jj].components["flux"]
    assert_allclose(got.flux_upsampled_numpy, want.flux_upsampled_numpy,
                    rtol=1e-4)
    assert_allclose(got.flux_upsampled_error_numpy,
                    np.asarray(want._flux_upsampled_error)[0, 0], rtol=1e-4)
