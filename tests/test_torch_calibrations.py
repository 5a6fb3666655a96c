"""Per-observation calibrations and upsampled components through the port's
losses and deconvolver, against ``jolideco_tpu``.

``NPredCalibration(s)``: the flux shifted by ``shift_xy`` data pixels at
``scale=factor``, the background times ``exp(log_background_norm)``, the
static ``psf_scale`` zoom and likelihood ``weight``; ``frozen`` and
``frozen_shift`` leave leaves out of the params and the loss takes their
static values. The E0102 configuration of ``examples/chandra_e0102_like.py``
at 4 x 32²: a x2 component under the GMM prior beside a frozen x1 flat
component under ``UniformPrior``, ragged PSFs keyed by component, a
reference observation whose shift is frozen at a non-zero value, one
frozen calibration, one ``psf_scale`` and unequal weights.

The deconvolver runs (4 x 64² counts at x2, 20 epochs, joint and
sequential) hold the flux, the trained calibrations and the trace. They
run under ``UniformPrior``: under the MAP GMM prior a near-tied argmax
turns float32 differences into different steps (at this data the joint
runs' fluxes part by 4.7e-4 after 20 epochs), while under the smooth
prior the two packages agree to 1.5e-5. The GMM prior at x2 is held by the loss
tests, the probe and ``tests/test_torch_slice.py``'s runs.

The JAX package runs its default CPU dispatch, and its Pallas kernels in
the interpreter where ``conv_mode="pfft"`` needs them; the port its
plain versions. Tolerances, each with its reason:

- per-observation losses and the total loss: rtol 1e-5 (float32 FFTs
  and means in other orders; the ``"pfft"`` split mode within it,
  ``tests/test_torch_pfft_path.py``);
- gradients with respect to the flux: 1e-5 of their max-abs (``"pfft"``:
  3.1e-5, the split mode's error), and with respect to the calibration
  leaves rtol 1e-4 (sums over every pixel; 1e-6 measured, and the
  ``"pfft"`` split mode's 5e-6);
- the deconvolver's flux after 20 epochs: rtol 1e-4 (the ``BASELINE.md``
  bar for flux maps; 1.5e-5 measured), the trained shifts and log norms
  atol 1e-5 (4e-6 measured), the trace rtol 1e-4;
- flux errors: rtol 1e-4 (``tests/test_torch_errors.py``'s bar), the
  JAX probe taken at the port's trained flux and calibrations;
- resuming within the port: bitwise.
"""

import copy

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.core import MAPDeconvolverResult
from jolideco_torch.loss import PoissonLoss
from jolideco_torch.models import NPredModels
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_torch.utils.bench_data import make_shifted_datasets
from jolideco_torch.utils.interop import (
    adam_state_from_optax,
    gmm_from_arrays,
    params_from_jax,
)
from jolideco_torch.utils.kernels import gaussian_kernel_2d
from jolideco_tpu.config import force_pallas
from jolideco_tpu.loss import PoissonLoss as JPoissonLoss
from jolideco_tpu.models import NPredModels as JNPredModels
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

torch.set_num_threads(1)
N_OBS, SMALL, SIZE, EPOCHS, HALF = 4, 32, 64, 20, 10


@pytest.fixture(scope="module")
def gmms():
    gmm_j = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    gmm_t = gmm_from_arrays(np.asarray(gmm_j.means),
                            np.asarray(gmm_j.covariances),
                            np.asarray(gmm_j.weights), gmm_j.meta.stride)
    return gmm_j, gmm_t


def e0102_datasets():
    rs = np.random.RandomState(0)
    datasets = {}
    for i in range(N_OBS):
        size = 7 + 2 * (i % 2)
        psf = gaussian_kernel_2d(1.2 + 0.3 * i, x_size=size,
                                 y_size=size).astype(np.float32)
        datasets[f"obs-{i}"] = {
            "counts": rs.poisson(5.0, (SMALL, SMALL)).astype(np.float32),
            "psf": {"flux": psf, "background-flux": psf},
            "exposure": np.full((SMALL, SMALL), 1 + 0.1 * i, np.float32),
            "background": np.ones((SMALL, SMALL), np.float32),
        }
    return datasets


def e0102_components(pkg, gmm):
    comps = pkg.FluxComponents()
    comps["flux"] = pkg.SpatialFluxComponent.from_numpy(
        np.full((SMALL, SMALL), 2.0, np.float32), upsampling_factor=2,
        prior=pkg.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False))
    comps["background-flux"] = pkg.SpatialFluxComponent.from_numpy(
        np.full((SMALL, SMALL), 0.5, np.float32), prior=pkg.UniformPrior(),
        frozen=True)
    return comps


def e0102_calibrations(pkg):
    """obs-0 the reference (its shift frozen at a non-zero value), obs-2
    zoomed, obs-3 frozen; unequal weights."""
    cals = pkg.NPredCalibrations()
    for i in range(N_OBS):
        cals[f"obs-{i}"] = pkg.NPredCalibration(
            shift_x=0.3 * i + 0.2, shift_y=-0.2 * i - 0.1,
            background_norm=1 + 0.1 * i,
            psf_scale=1.2 if i == 2 else 1.0, frozen=i == 3,
            frozen_shift=i == 0, weight=1 + 0.5 * i)
    return cals


@pytest.fixture(scope="module")
def datasets():
    # 4 x 64² counts of a field seen at four known sub-pixel offsets
    return make_shifted_datasets(size=SIZE, psf_size=9, seed=3)


def run_calibrations(pkg):
    cals = pkg.NPredCalibrations()
    for i in range(N_OBS):
        cals[f"obs-{i}"] = pkg.NPredCalibration(frozen_shift=i == 0)
    return cals


def run_component(pkg, prior=None):
    return pkg.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32), upsampling_factor=2,
        prior=prior if prior is not None else pkg.UniformPrior())


def jax_params(cals):
    return jax.tree_util.tree_map(jnp.asarray, cals.parameters())


def torch_params(cals):
    return {name: {k: v.detach().clone().requires_grad_(True)
                   for k, v in leaves.items()}
            for name, leaves in cals.parameters().items()}


def close(got, want, rel):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def assert_calibrations_close(got, want, atol=1e-5):
    for name in want:
        a, b = got[name].to_dict(), want[name].to_dict()
        assert set(a) == set(b)
        for key in ("psf_scale", "frozen", "frozen_shift", "weight"):
            assert a[key] == b[key], (name, key)
        assert_allclose(got[name].shift_xy.cpu().numpy(),
                        np.asarray(want[name].shift_xy), rtol=0, atol=atol)
        assert_allclose(got[name]._background_norm.cpu().numpy(),
                        np.asarray(want[name]._background_norm), rtol=0,
                        atol=atol)


def test_calibration_leaves_and_dicts_match_jax():
    cals_j, cals_t = e0102_calibrations(jj), e0102_calibrations(jt)
    params_j, params_t = cals_j.parameters(), cals_t.parameters()
    assert list(params_t) == list(params_j) == ["obs-0", "obs-1", "obs-2"]
    for name in params_j:
        assert set(params_t[name]) == set(params_j[name])
        for key, value in params_j[name].items():
            assert_array_equal(params_t[name][key].numpy(),
                               np.asarray(value))
    assert "shift_xy" not in params_t["obs-0"]
    assert cals_t.to_dict() == cals_j.to_dict()
    again = jt.NPredCalibrations.from_dict(cals_t.to_dict())
    assert again.to_dict() == cals_t.to_dict()
    cals_t.set_parameters({"obs-1": {"shift_xy": torch.ones(1, 2)}})
    assert_array_equal(cals_t["obs-1"].shift_xy.numpy(), [[1.0, 1.0]])
    assert float(cals_t["obs-2"].background_norm_from()) == pytest.approx(
        1.2, rel=1e-6)


def test_npred_models_with_calibration_match_jax():
    dataset = e0102_datasets()["obs-2"]
    comps_j = jj.FluxComponents({"flux": jj.SpatialFluxComponent.from_numpy(
        np.ones((SMALL, SMALL)), upsampling_factor=2)})
    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        np.ones((SMALL, SMALL)), upsampling_factor=2)})
    dataset = dict(dataset, psf=dataset["psf"]["flux"])
    cal_j = e0102_calibrations(jj)["obs-2"]
    cal_t = e0102_calibrations(jt)["obs-2"]
    models_j = JNPredModels.from_dataset_numpy(dataset, comps_j,
                                               calibration=cal_j)
    models_t = NPredModels.from_dataset_numpy(dataset, comps_t,
                                              calibration=cal_t,
                                              device="cpu")
    flux = np.random.RandomState(1).uniform(
        0.5, 2.0, (1, 1, 2 * SMALL, 2 * SMALL)).astype(np.float32)
    weights = np.random.RandomState(2).normal(
        size=(1, 1, SMALL, SMALL)).astype(np.float32)
    value_j, (gflux_j, gcal_j) = jax.jit(jax.value_and_grad(
        lambda f, p: jnp.sum(models_j.evaluate((f,), p) * weights),
        argnums=(0, 1)))(jnp.asarray(flux), jax_params(cal_j))
    f = torch.as_tensor(flux).requires_grad_(True)
    params = torch_params(jt.NPredCalibrations({"c": cal_t}))["c"]
    value_t = (models_t.evaluate((f,), params)
               * torch.as_tensor(weights)).sum()
    value_t.backward()
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    close(f.grad.numpy(), gflux_j, 1e-5)
    for key, leaf in params.items():
        assert_allclose(leaf.grad.numpy(), np.asarray(gcal_j[key]),
                        rtol=1e-4)
    # without params the stored values are used
    assert_allclose(models_t.evaluate((f,)).detach().numpy(),
                    np.asarray(models_j.evaluate((jnp.asarray(flux),))),
                    rtol=1e-5)


@pytest.mark.parametrize("conv_mode", ["fft", "pfft"])
def test_e0102_losses_and_gradients_match_jax(gmms, conv_mode):
    gmm_j, gmm_t = gmms
    datasets = e0102_datasets()
    comps_j, comps_t = e0102_components(jj, gmm_j), e0102_components(jt,
                                                                     gmm_t)
    cals_j, cals_t = e0102_calibrations(jj), e0102_calibrations(jt)
    flux = np.random.RandomState(7).uniform(
        0.5, 2.0, (1, 1, 2 * SMALL, 2 * SMALL)).astype(np.float32)
    bkg = comps_j["background-flux"].flux_upsampled
    with force_pallas("interpret" if conv_mode == "pfft" else "off"):
        deco_j = jj.MAPDeconvolver(update_strategy="joint",
                                   conv_mode=conv_mode)
        total_j = deco_j.build_loss(datasets, components=comps_j,
                                    calibrations=cals_j)
        stacked_j = total_j.poisson_loss
        assert isinstance(stacked_j, JStacked)
        losses_j, single_j = jax.jit(lambda f, p: (
            stacked_j.evaluate((f, bkg), p),
            jnp.stack([stacked_j.evaluate_dataset(idx, (f, bkg), p)
                       for idx in range(N_OBS)])))(
            jnp.asarray(flux), jax_params(cals_j))
        value_j, (gflux_j, gcal_j) = jax.jit(jax.value_and_grad(
            lambda f, p: total_j((f, bkg), calibration_params=p),
            argnums=(0, 1)))(jnp.asarray(flux), jax_params(cals_j))
        losses_j, single_j = np.asarray(losses_j), np.asarray(single_j)

    deco_t = jt.MAPDeconvolver(update_strategy="joint", conv_mode=conv_mode,
                               device="cpu")
    total_t = deco_t.build_loss(datasets, components=comps_t,
                                calibrations=cals_t)
    stacked_t = total_t.poisson_loss
    assert isinstance(stacked_t, TStacked)
    assert stacked_t.psf_scales == stacked_j.psf_scales
    assert_array_equal(stacked_t.weights.numpy(),
                       np.asarray(stacked_j.weights))
    bkg_t = comps_t["background-flux"].flux_upsampled
    params = torch_params(cals_t)
    f = torch.as_tensor(flux).requires_grad_(True)
    value_t = total_t((f, bkg_t), calibration_params=params)
    value_t.backward()
    losses_t = stacked_t.evaluate((f, bkg_t), params).detach().numpy()
    assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    close(f.grad.numpy(), gflux_j, 3.1e-5 if conv_mode == "pfft" else 1e-5)
    assert set(params) == set(gcal_j)
    for name, leaves in params.items():
        for key, leaf in leaves.items():
            assert_allclose(leaf.grad.numpy(),
                            np.asarray(gcal_j[name][key]), rtol=1e-4,
                            err_msg=f"{name} {key}")
    # one observation alone, its rfft2 convolution
    for idx in range(N_OBS):
        assert_allclose(stacked_t.evaluate_dataset(
            idx, (f, bkg_t), params).item(), single_j[idx], rtol=1e-5)
    # the sequential strategy's per-dataset models give the same terms
    loss_j = JPoissonLoss.from_datasets(datasets, comps_j,
                                        calibrations=cals_j)
    loss_t = PoissonLoss.from_datasets(datasets, comps_t,
                                       calibrations=cals_t, device="cpu")
    assert_array_equal(loss_t.weights.numpy(), np.asarray(loss_j.weights))
    per_dataset_j = jax.jit(lambda f, p: loss_j.evaluate((f, bkg), p))(
        jnp.asarray(flux), jax_params(cals_j))
    assert_allclose(loss_t.evaluate((f, bkg_t), params).detach().numpy(),
                    np.asarray(per_dataset_j), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_runs(datasets):
    runs = {}
    for strategy in ("joint", "sequential"):
        deco = jj.MAPDeconvolver(n_epochs=EPOCHS, update_strategy=strategy,
                                 display_progress=False)
        runs[strategy] = deco.run(datasets, components=run_component(jj),
                                  calibrations=run_calibrations(jj))
    return runs


@pytest.mark.parametrize("strategy", ["joint", "sequential"])
def test_deconvolver_with_calibrations_matches_jax(datasets, jax_runs,
                                                   strategy):
    want = jax_runs[strategy]
    cals = run_calibrations(jt)
    deco = jt.MAPDeconvolver(n_epochs=EPOCHS, update_strategy=strategy,
                             device="cpu")
    got = deco.run(datasets, components=run_component(jt),
                   calibrations=cals)
    assert got.calibrations is cals
    assert got.calibrations_init["obs-1"].to_dict()["shift_x"] == 0.0
    flux_t = got.components["flux"].flux_upsampled_numpy
    assert flux_t.shape == (2 * SIZE, 2 * SIZE)
    assert_allclose(flux_t, want.components["flux"].flux_upsampled_numpy,
                    rtol=1e-4)
    assert_allclose(got.components["flux"].flux_numpy,
                    want.components["flux"].flux_numpy, rtol=1e-4)
    assert_calibrations_close(got.calibrations, want.calibrations)
    # the reference observation's shift is frozen: not moved at all
    assert_array_equal(got.calibrations["obs-0"].shift_xy.numpy(),
                       [[0.0, 0.0]])
    assert float(got.calibrations["obs-1"].shift_xy.abs().max()) > 0.05
    trace_t, trace_j = got.trace_loss, want.trace_loss
    assert trace_t.colnames == trace_j.colnames and len(trace_t) == EPOCHS
    for name in trace_j.colnames[:-1]:
        assert_allclose(trace_t[name], trace_j[name], rtol=1e-4,
                        err_msg=name)


def test_compute_error_with_calibrations_matches_jax(datasets, gmms):
    gmm_j, gmm_t = gmms
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=4, cycle_spin=False)
    deco_t = jt.MAPDeconvolver(n_epochs=5, update_strategy="joint",
                               trace_every=0, compute_error=True,
                               device="cpu")
    result = deco_t.run(datasets, components=run_component(jt, prior_t),
                        calibrations=run_calibrations(jt))
    errors_t = result.components["flux"].flux_upsampled_error_numpy
    assert errors_t.shape == (2 * SIZE, 2 * SIZE)
    assert np.isfinite(errors_t).all() and (errors_t > 0).all()
    assert result.error_seconds > 0

    # the JAX probe at the port's trained flux and calibrations
    comp_j = run_component(jj, jj.GMMPatchPrior(gmm=gmm_j, stride=4,
                                                cycle_spin=False))
    comps_j = jj.FluxComponents({"flux": comp_j})
    params_from_jax_like = {
        name: {k: jnp.asarray(v.cpu().numpy()) for k, v in leaves.items()}
        for name, leaves in result.calibrations.parameters().items()}
    log_flux = result.components["flux"].parameters()["flux"].numpy()
    comps_j.set_parameters({"flux": {"flux": jnp.asarray(log_flux)}})
    deco_j = jj.MAPDeconvolver(update_strategy="joint")
    total_j = deco_j.build_loss(datasets, components=comps_j,
                                calibrations=run_calibrations(jj))
    errors_j = total_j.fluxes_error(
        comps_j.fluxes_from(comps_j.parameters()),
        calibration_params=params_from_jax_like)["flux"]
    assert_allclose(errors_t, np.asarray(errors_j)[0, 0], rtol=1e-4)


@pytest.mark.parametrize("strategy", ["joint", "sequential"])
def test_resume_with_calibrations_equals_an_uninterrupted_run(
        datasets, strategy, tmp_path):
    def deco(n_epochs):
        return jt.MAPDeconvolver(n_epochs=n_epochs, update_strategy=strategy,
                                 device="cpu")

    whole = deco(EPOCHS).run(datasets, components=run_component(jt),
                             calibrations=run_calibrations(jt))
    first = deco(HALF).run(datasets, components=run_component(jt),
                           calibrations=run_calibrations(jt))
    first.save_state(tmp_path / "state")
    # from the directory: flux, calibrations, moments and generator
    second = deco(HALF).run(datasets, components=run_component(jt),
                            calibrations=run_calibrations(jt),
                            resume_from=tmp_path / "state")
    # from the result: its components and calibrations go on
    third = deco(HALF).run(datasets, components=first.components,
                           calibrations=first.calibrations,
                           resume_from=first)
    for resumed in (second, third):
        assert_array_equal(resumed.components["flux"].flux_upsampled_numpy,
                           whole.components["flux"].flux_upsampled_numpy)
        for name, cal in whole.calibrations.items():
            assert_array_equal(resumed.calibrations[name].shift_xy.numpy(),
                               cal.shift_xy.numpy())
            assert_array_equal(
                resumed.calibrations[name]._background_norm.numpy(),
                cal._background_norm.numpy())
        assert_array_equal(resumed.loss_per_step,
                           whole.loss_per_step[len(first.loss_per_step):])
        for key, entry in whole.opt_state["state"].items():
            assert torch.equal(entry["exp_avg_sq"],
                               resumed.opt_state["state"][key]["exp_avg_sq"])


def test_interop_carries_a_jax_run_with_calibrations(datasets, jax_runs):
    """The JAX package's params and Adam state after 10 joint epochs,
    carried across, go on in the port to the JAX run of 20."""
    deco_j = jj.MAPDeconvolver(n_epochs=HALF, update_strategy="joint",
                               display_progress=False)
    cals_j = run_calibrations(jj)
    half = deco_j.run(datasets, components=run_component(jj),
                      calibrations=cals_j)
    params_np = jax.tree_util.tree_map(np.asarray, {
        "components": half.components.parameters(),
        "calibrations": half.calibrations.parameters()})
    components = jt.FluxComponents({"flux": run_component(jt)})
    cals_t = run_calibrations(jt)
    loaded = params_from_jax(params_np, components, calibrations=cals_t)
    assert set(loaded) == {"components", "calibrations"}
    assert_calibrations_close(cals_t, half.calibrations, atol=0)
    adam = next(s for s in half.opt_state if hasattr(s, "mu"))
    state = adam_state_from_optax(
        jax.tree_util.tree_map(np.asarray, adam), components.parameters(),
        calibration_params=cals_t.parameters(), lr=0.1)
    # 3 x (shift, norm) + the reference's norm + the flux
    assert len(state["state"]) == 3 * 2 + 1 + 1
    carried = MAPDeconvolverResult(config={}, components=components,
                                   opt_state=state, calibrations=cals_t)
    result = jt.MAPDeconvolver(n_epochs=HALF, update_strategy="joint",
                               device="cpu").run(
        datasets, components=components, calibrations=cals_t,
        resume_from=carried)
    want = jax_runs["joint"]
    assert_allclose(result.components["flux"].flux_upsampled_numpy,
                    want.components["flux"].flux_upsampled_numpy, rtol=1e-4)
    assert_calibrations_close(result.calibrations, want.calibrations)


def test_remaining_forward_model_options_raise(tmp_path):
    """The calibrations' file I/O (once a raise, now ported):
    ``NPredCalibrations.write`` and ``read`` in YAML and FITS give the
    values back, on the CPU when asked; without a ``device`` the read
    goes to the card and raises without one. The energy redistribution,
    band stacks, sparse components and the joint strategy's per-dataset
    fallback are ported (``tests/test_torch_multiband.py``,
    ``tests/test_torch_sparse.py``, ``tests/test_torch_fallback.py``);
    the cross-package files are held in ``tests/test_torch_io.py``."""
    cals = e0102_calibrations(jt)
    for suffix in ("yaml", "fits"):
        path = tmp_path / f"calibrations.{suffix}"
        cals.write(path)
        back = jt.NPredCalibrations.read(path, device="cpu")
        assert back.to_dict() == cals.to_dict()
        assert back["obs-1"].shift_xy.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                jt.NPredCalibrations.read(path)


def test_copies_leave_the_originals_alone():
    cals = e0102_calibrations(jt)
    copied = cals.copy()
    copied["obs-1"].set_parameters({"shift_xy": torch.zeros(1, 2)})
    assert float(cals["obs-1"].shift_xy[0, 0]) == pytest.approx(0.5)
    assert copy.copy(cals["obs-1"]).weight == cals["obs-1"].weight
