"""The port's default deconvolver against ``jolideco_tpu``'s: the sequential
strategy, the loss trace, early stopping on validation data, a reused
loss, and resuming.

3 observations of 64² (a flat sky of 8 under a halo and point sources,
so that the flat start lies below the truth everywhere), the
``builtin-8x8-v1`` GMM prior without cycle spin, ``MAPDeconvolver()``
with its default keywords (``"sequential"``, ``trace_every=1``, Adam at
lr 0.1) for 6 epochs, 18 optimiser steps. The JAX package runs its
default CPU dispatch (XLA FFT, XLA patch scorer, a scanned epoch loop);
the port its plain versions, eagerly. The JAX runs are shared through
module-scoped fixtures.

Tolerances, each with its reason:

- ``PoissonLoss.evaluate_dataset`` and its gradient: rtol 1e-5 (float32
  FFTs and means in other orders), the gradient with a floor of 1e-6 of
  its max-abs;
- flux after 6 epochs: rtol 1e-4 (the ``BASELINE.md`` bar for flux
  maps);
- the trace, every column under the JAX package's names and in its
  order: rtol 1e-5 at row 0, 1e-4 after. At the same flux the two trace
  rows agree to 3e-6; row 0 lies at the end of the first epoch, and the
  3 Adam steps before it already differ: optax takes its bias
  corrections ``1 - b**t`` in float32 (``1 - 0.999`` carries a relative
  rounding error of 1.3e-5, see ``tests/test_torch_slice.py``), PyTorch
  in float64. That puts row 0 5.9e-6 to 8.7e-6 apart (seeds 1-6 of this
  data), and the flux after 6 epochs 4.4e-5 to 1.0e-4: the two packages'
  paths part further with every step, which is why these runs are 6
  epochs long, about the 20 steps of ``tests/test_torch_slice.py``.

Within the port, resuming is held bitwise: ``n`` epochs and then ``m``
more give the bits of ``n + m`` epochs in one run, with or without the
cycle spin. Against JAX, resuming runs without the cycle spin, because
JAX's ``final_key`` resumes on another key stream than its uninterrupted
run.

As in ``tests/test_torch_slice.py``, every pixel's gradient at the first
step is at least 1e-3 of the largest, so that Adam's first step, ``-lr g
/ (|g| + eps)``, is not decided by rounding.
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
from jolideco_torch.models import NPredModel, NPredModels
from jolideco_torch.parallel.stacked import StackedPoissonLoss
from jolideco_torch.utils.checkpoint import (
    restore_train_state,
    save_train_state,
)
from jolideco_torch.utils.interop import (
    adam_state_from_optax,
    gmm_from_arrays,
    params_from_jax,
)
from jolideco_torch.utils.kernels import gaussian_kernel_2d
from jolideco_torch.utils.table import Table
from jolideco_tpu.loss import PoissonLoss as JPoissonLoss

torch.set_num_threads(1)
SIZE, N_OBS, EPOCHS, HALF = 64, 3, 6, 3
# early stopping: 20 epochs asked, the validation data's total rises
# from the third epoch on, so both packages stop after the fourth
STOP_EPOCHS, STOP_N_AVERAGE = 20, 3


def make_datasets(n_obs=N_OBS, seed=6, scale=1.0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    truth = 5.0 * np.exp(
        -((xx - SIZE / 2) ** 2 + (yy - SIZE / 2 + 4) ** 2) / (2 * 6.0**2)
    ) + 8.0
    for _ in range(6):
        y0, x0 = rs.randint(4, SIZE - 4, 2)
        truth[y0, x0] += rs.gamma(2.0) * 20
    datasets = {}
    for i in range(n_obs):
        psf = gaussian_kernel_2d(1.5 + 0.3 * i, x_size=9,
                                 y_size=9).astype(np.float32)
        exposure = np.full((SIZE, SIZE), 1.0 + 0.1 * i, np.float32)
        background = np.full((SIZE, SIZE), 1.0, np.float32)
        lam = scale * (background + truth * exposure)
        counts = rs.poisson(lam).astype(np.float32)
        datasets[f"obs-{i}"] = {"counts": counts, "psf": psf,
                                "exposure": exposure,
                                "background": background}
    return datasets


@pytest.fixture(scope="module")
def datasets():
    return make_datasets()


@pytest.fixture(scope="module")
def validation():
    return make_datasets(n_obs=2, seed=11, scale=2.0)


@pytest.fixture(scope="module")
def gmm_j():
    return jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")


@pytest.fixture(scope="module")
def gmm_t(gmm_j):
    # the port's GMM from the very arrays the JAX GMM was built from
    return gmm_from_arrays(np.asarray(gmm_j.means),
                           np.asarray(gmm_j.covariances),
                           np.asarray(gmm_j.weights), gmm_j.meta.stride)


def comp_j(gmm_j, cycle_spin=False):
    prior = jj.GMMPatchPrior(gmm=gmm_j, stride=4, cycle_spin=cycle_spin)
    return jj.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32), prior=prior)


def comp_t(gmm_t, cycle_spin=False, flux=None):
    prior = jt.GMMPatchPrior(gmm=gmm_t, stride=4, cycle_spin=cycle_spin)
    flux = np.ones((SIZE, SIZE), np.float32) if flux is None else flux
    return jt.SpatialFluxComponent.from_numpy(flux, prior=prior)


def flux_of(result):
    return result.components["flux"].flux_upsampled_numpy


@pytest.fixture(scope="module")
def jax_default(datasets, gmm_j):
    # display_progress=False takes the scanned loop: the same results
    deco = jj.MAPDeconvolver(n_epochs=EPOCHS, display_progress=False)
    return deco.run(datasets, components=comp_j(gmm_j))


@pytest.fixture(scope="module")
def torch_default(datasets, gmm_t):
    deco = jt.MAPDeconvolver(n_epochs=EPOCHS, device="cpu")
    return deco.run(datasets, components=comp_t(gmm_t))


@pytest.fixture(scope="module")
def jax_half(datasets, gmm_j):
    deco = jj.MAPDeconvolver(n_epochs=HALF, display_progress=False)
    return deco.run(datasets, components=comp_j(gmm_j))


def assert_traces_close(trace_t, trace_j, first_rtol=1e-5):
    """Column names and order, rows: ``first_rtol`` at row 0 (1e-5 at
    the first epoch of training), 1e-4 after."""
    assert trace_t.colnames == trace_j.colnames
    assert len(trace_t) == len(trace_j)
    assert list(trace_t["filename"]) == [""] * len(trace_t)
    for name in trace_j.colnames[:-1]:
        got, want = trace_t[name], trace_j[name]
        assert_allclose(got[:1], want[:1], rtol=first_rtol, err_msg=name)
        assert_allclose(got[1:], want[1:], rtol=1e-4, err_msg=name)


def assert_results_equal(a, b):
    """Bitwise: flux, trace rows, optimiser moments, generator state."""
    assert_array_equal(flux_of(a), flux_of(b))
    for name in a.trace_loss.colnames:
        assert_array_equal(a.trace_loss[name], b.trace_loss[name])
    for key, entry in a.opt_state["state"].items():
        for name, value in entry.items():
            assert torch.equal(value, b.opt_state["state"][key][name])
    assert torch.equal(a.generator_state, b.generator_state)


@pytest.mark.parametrize("idx", range(N_OBS))
def test_poisson_loss_evaluate_dataset_matches_jax(datasets, idx):
    flux = np.random.RandomState(idx).uniform(0.5, 2.0, (1, 1, SIZE, SIZE))
    flux = flux.astype(np.float32)
    comps_j = jj.FluxComponents({"flux": jj.SpatialFluxComponent(flux)})
    loss_j = JPoissonLoss.from_datasets(datasets, comps_j)
    value_j, grad_j = jax.value_and_grad(
        lambda x: loss_j.evaluate_dataset(idx, (x,)))(jnp.asarray(flux))

    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent(flux)})
    loss_t = PoissonLoss.from_datasets(datasets, comps_t, device="cpu")
    x = torch.as_tensor(flux).requires_grad_(True)
    value_t = loss_t.evaluate_dataset(idx, (x,))
    value_t.backward()

    assert loss_t.names_all == loss_j.names_all
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=1e-5,
                    atol=1e-6 * float(np.abs(grad_j).max()))
    assert_allclose(loss_t.evaluate((x,)).detach().numpy(),
                    np.asarray(loss_j.evaluate((jnp.asarray(flux),))),
                    rtol=1e-5)


def test_first_step_gradient_far_from_zero(datasets, gmm_t):
    trainer = jt.MAPDeconvolver(device="cpu").make_trainer(
        datasets, comp_t(gmm_t))
    loss = trainer._loss_for_dataset(0, {"flux": None})
    loss.backward()
    grad = trainer.params["flux"]["flux"].grad.abs()
    assert float(grad.min()) >= 1e-3 * float(grad.max())


def test_default_deconvolver_matches_jax(jax_default, torch_default):
    assert jt.MAPDeconvolver().update_strategy == "sequential"
    assert torch_default.config["trace_every"] == 1
    assert torch_default.n_epochs == EPOCHS
    # a step per dataset and epoch
    assert torch_default.loss_per_step.shape == (EPOCHS * N_OBS,)
    assert np.isfinite(torch_default.loss_per_step).all()
    assert_allclose(flux_of(torch_default), flux_of(jax_default), rtol=1e-4)
    assert_traces_close(torch_default.trace_loss, jax_default.trace_loss)
    assert_array_equal(
        torch_default.components_init["flux"].flux_upsampled_numpy,
        np.ones((SIZE, SIZE), np.float32))


def test_trace_every_records_the_same_epochs(datasets, gmm_j, gmm_t,
                                             torch_default):
    deco_j = jj.MAPDeconvolver(n_epochs=EPOCHS, trace_every=3,
                               display_progress=False)
    result_j = deco_j.run(datasets, components=comp_j(gmm_j))
    deco_t = jt.MAPDeconvolver(n_epochs=EPOCHS, trace_every=3, device="cpu")
    result_t = deco_t.run(datasets, components=comp_t(gmm_t))
    assert len(result_t.trace_loss) == len(result_j.trace_loss) == 2
    assert_traces_close(result_t.trace_loss, result_j.trace_loss)
    # thinning the trace changes no training result: rows 0 and 3 and
    # the flux are those of the run that traces every epoch
    assert_array_equal(flux_of(result_t), flux_of(torch_default))
    for name in result_t.trace_loss.colnames[:-1]:
        assert_array_equal(result_t.trace_loss[name],
                           torch_default.trace_loss[name][[0, 3]])


def test_stop_early_stops_at_the_jax_epoch(datasets, validation, gmm_j,
                                           gmm_t):
    kwargs = dict(n_epochs=STOP_EPOCHS, stop_early=True,
                  stop_early_n_average=STOP_N_AVERAGE)
    result_j = jj.MAPDeconvolver(display_progress=False, **kwargs).run(
        datasets, datasets_validation=validation, components=comp_j(gmm_j))
    result_t = jt.MAPDeconvolver(device="cpu", **kwargs).run(
        datasets, datasets_validation=validation, components=comp_t(gmm_t))
    n_j = len(result_j.trace_loss)
    assert STOP_N_AVERAGE < n_j < STOP_EPOCHS
    assert result_t.n_epochs == len(result_t.trace_loss) == n_j
    assert result_t.loss_per_step.shape == (n_j * N_OBS,)
    assert result_t.trace_loss.colnames[-2] == "datasets-validation-total"
    assert_traces_close(result_t.trace_loss, result_j.trace_loss)
    # the stop is decided by a rise of 0.2% over the window's mean, far
    # beyond the packages' differences
    val = result_j.trace_loss["datasets-validation-total"]
    assert val[-1] > (1 + 1e-3) * np.mean(val[-STOP_N_AVERAGE:])


def test_stop_early_without_validation_data_raises(datasets, gmm_t):
    deco = jt.MAPDeconvolver(n_epochs=2, stop_early=True, device="cpu")
    with pytest.raises(ValueError,
                       match="Early stopping requires providing test"):
        deco.run(datasets, components=comp_t(gmm_t))
    loss = deco.build_loss(datasets, components=comp_t(gmm_t))
    with pytest.raises(ValueError, match="built without them"):
        deco.run(datasets, datasets_validation=datasets,
                 components=comp_t(gmm_t), total_loss=loss)


@pytest.mark.parametrize("strategy", ["sequential", "joint"])
def test_build_loss_reuse_equals_a_fresh_run(datasets, validation, gmm_t,
                                             strategy):
    deco = jt.MAPDeconvolver(n_epochs=HALF, update_strategy=strategy,
                             device="cpu")
    fresh = deco.run(datasets, datasets_validation=validation,
                     components=comp_t(gmm_t))
    loss = deco.build_loss(datasets, datasets_validation=validation,
                           components=comp_t(gmm_t))
    kind = PoissonLoss if strategy == "sequential" else StackedPoissonLoss
    assert isinstance(loss.poisson_loss, kind)
    assert isinstance(loss.poisson_loss_validation, kind)
    first = deco.run(datasets, components=comp_t(gmm_t), total_loss=loss)
    second = deco.run(datasets, components=comp_t(gmm_t), total_loss=loss)
    assert first.trace_loss is not second.trace_loss
    for result in (first, second):
        assert len(result.trace_loss) == HALF
        assert_results_equal(result, fresh)


@pytest.mark.parametrize("cycle_spin", [False, True])
def test_resume_equals_an_uninterrupted_run(datasets, gmm_t, cycle_spin):
    whole = jt.MAPDeconvolver(n_epochs=EPOCHS, device="cpu").run(
        datasets, components=comp_t(gmm_t, cycle_spin))
    deco = jt.MAPDeconvolver(n_epochs=HALF, device="cpu")
    first = deco.run(datasets, components=comp_t(gmm_t, cycle_spin))
    second = deco.run(datasets, components=first.components,
                      resume_from=first)
    assert_array_equal(flux_of(second), flux_of(whole))
    assert_array_equal(
        np.concatenate([first.loss_per_step, second.loss_per_step]),
        whole.loss_per_step)
    for name in whole.trace_loss.colnames[:-1]:
        assert_array_equal(np.concatenate([first.trace_loss[name],
                                           second.trace_loss[name]]),
                           whole.trace_loss[name])
    assert torch.equal(second.generator_state, whole.generator_state)
    # the first result is left as it was
    assert first.opt_state["state"][0]["step"].item() == HALF * N_OBS


def test_resume_matches_jax(datasets, gmm_j, gmm_t, jax_half, jax_default):
    deco_j = jj.MAPDeconvolver(n_epochs=HALF, display_progress=False)
    resumed_j = deco_j.run(datasets,
                           components=copy.deepcopy(jax_half.components),
                           resume_from=jax_half)
    deco_t = jt.MAPDeconvolver(n_epochs=HALF, device="cpu")
    first = deco_t.run(datasets, components=comp_t(gmm_t))
    resumed_t = deco_t.run(datasets, components=first.components,
                           resume_from=first)
    assert_allclose(flux_of(resumed_t), flux_of(resumed_j), rtol=1e-4)
    assert_allclose(flux_of(resumed_t), flux_of(jax_default), rtol=1e-4)
    # the resumed runs' row 0 is the fourth epoch of training
    assert_traces_close(resumed_t.trace_loss, resumed_j.trace_loss,
                        first_rtol=1e-4)


def test_save_state_round_trip(datasets, gmm_t, tmp_path):
    whole = jt.MAPDeconvolver(n_epochs=EPOCHS, device="cpu").run(
        datasets, components=comp_t(gmm_t, cycle_spin=True))
    deco = jt.MAPDeconvolver(n_epochs=HALF, device="cpu")
    first = deco.run(datasets, components=comp_t(gmm_t, cycle_spin=True))
    first.save_state(tmp_path / "state")
    params, opt_state, generator_state, epoch = restore_train_state(
        tmp_path / "state")
    assert epoch == HALF
    assert isinstance(params["flux"]["flux"], np.ndarray)
    assert_array_equal(params["flux"]["flux"],
                       first.components["flux"].parameters()["flux"].numpy())
    assert torch.equal(generator_state, first.generator_state)
    # parameters, moments and generator all come from the directory: the
    # components passed in start flat
    second = deco.run(datasets, components=comp_t(gmm_t, cycle_spin=True),
                      resume_from=str(tmp_path / "state"))
    assert_array_equal(flux_of(second), flux_of(whole))
    assert_array_equal(second.loss_per_step,
                       whole.loss_per_step[HALF * N_OBS:])
    assert torch.equal(second.generator_state, whole.generator_state)
    assert torch.equal(second.opt_state["state"][0]["exp_avg_sq"],
                       whole.opt_state["state"][0]["exp_avg_sq"])


def test_adam_state_from_optax_continues_a_jax_run(datasets, gmm_t,
                                                   jax_half, jax_default):
    comp = comp_t(gmm_t)
    components = jt.FluxComponents({"flux": comp})
    params_np = jax.tree_util.tree_map(
        np.asarray, {"components": jax_half.components.parameters()})
    params_from_jax(params_np, components)
    adam = next(s for s in jax_half.opt_state if hasattr(s, "mu"))
    state = adam_state_from_optax(
        jax.tree_util.tree_map(np.asarray, adam), components.parameters(),
        lr=0.1)
    assert set(state["state"]) == {0}
    assert state["state"][0]["step"].item() == HALF * N_OBS
    carried = MAPDeconvolverResult(config={}, components=components,
                                   opt_state=state)
    result = jt.MAPDeconvolver(n_epochs=HALF, device="cpu").run(
        datasets, components=components, resume_from=carried)
    assert_allclose(flux_of(result), flux_of(jax_default), rtol=1e-4)
    # the state dict loads into a torch.optim.Adam as it is
    opt = torch.optim.Adam([torch.zeros(1, 1, SIZE, SIZE)])
    opt.load_state_dict(state)


def test_compute_error_after_sequential_matches_jax(datasets, gmm_j, gmm_t,
                                                    jax_default):
    # the JAX package's probe at its trained flux, as its run takes it
    comps_j = jj.FluxComponents({"flux": jax_default.components["flux"]})
    deco_j = jj.MAPDeconvolver(n_epochs=EPOCHS, display_progress=False)
    errors_j = deco_j.build_loss(datasets, components=comps_j).fluxes_error(
        comps_j.fluxes_from(comps_j.parameters()))["flux"]
    deco_t = jt.MAPDeconvolver(n_epochs=EPOCHS, compute_error=True,
                               device="cpu")
    result = deco_t.run(datasets, components=comp_t(gmm_t))
    errors_t = result.components["flux"].flux_upsampled_error_numpy
    assert errors_t.shape == (SIZE, SIZE)
    assert np.isfinite(errors_t).all() and (errors_t > 0).all()
    assert result.error_seconds > 0
    assert_allclose(errors_t, np.asarray(errors_j)[0, 0], rtol=1e-4)


def test_npred_models_match_jax(datasets):
    from jolideco_tpu.models import NPredModels as JNPredModels

    dataset = datasets["obs-1"]
    flux = np.random.RandomState(3).uniform(0.5, 2.0, (1, 1, SIZE, SIZE))
    flux = flux.astype(np.float32)
    comps_j = jj.FluxComponents({"flux": jj.SpatialFluxComponent(flux)})
    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent(flux)})
    want = JNPredModels.from_dataset_numpy(dataset, comps_j).evaluate(
        (jnp.asarray(flux),))
    models = NPredModels.from_dataset_numpy(dataset, comps_t, device="cpu")
    got = models.evaluate((torch.as_tensor(flux),))
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                    atol=1e-6 * float(np.abs(want).max()))
    assert set(models.evaluate_per_component((torch.as_tensor(flux),))) \
        == {"flux", "background"}


@pytest.mark.parametrize("kwargs,match", [
    ({"upsampling_factor": 2}, "upsampling_factor"),
    ({"rmf": np.array([[0.8, 0.2], [0.1, 0.9]], np.float32)}, "rmf"),
], ids=["upsampling_factor", "rmf"])
def test_npred_model_raises_on_unported_options(kwargs, match):
    """``upsampling_factor``, an ``rmf`` (over a two-band stack), band
    stacks and a calibration are ported, and held against the JAX
    package (rtol 1e-5, float32 FFTs); a 4-D array raises the JAX
    package's ``ValueError``."""
    from jolideco_tpu.models import NPredCalibration as JNPredCalibration
    from jolideco_tpu.models import NPredModel as JNPredModel
    from jolideco_tpu.models import NPredModels as JNPredModels

    ones = np.ones((16, 16), np.float32)
    psf = gaussian_kernel_2d(1.0, x_size=3, y_size=3).astype(np.float32)
    options = {"upsampling_factor": None, **kwargs}
    rs = np.random.RandomState(0)
    if match == "rmf":
        exposure = rs.uniform(0.5, 1.5, (2, 16, 16)).astype(np.float32)
        psf_bands = np.stack([psf, gaussian_kernel_2d(
            1.5, x_size=5, y_size=5)[1:-1, 1:-1].astype(np.float32)])
        flux = rs.uniform(0.5, 2.0, (1, 1, 16, 16)).astype(np.float32)
        for psf_arg in (psf_bands, psf):
            got = NPredModel.from_numpy(exposure, psf_arg, device="cpu",
                                        **options)(torch.as_tensor(flux))
            want = JNPredModel.from_numpy(exposure, psf_arg, **options)(
                jnp.asarray(flux))
            assert tuple(got.shape) == want.shape == (1, 2, 16, 16)
            assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    else:
        flux = rs.uniform(0.5, 2.0, (1, 1, 32, 32)).astype(np.float32)
        got = NPredModel.from_numpy(ones, psf, device="cpu", **options)(
            torch.as_tensor(flux))
        want = JNPredModel.from_numpy(ones, psf, **options)(
            jnp.asarray(flux))
        assert tuple(got.shape) == want.shape == (1, 1, 16, 16)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    with pytest.raises(ValueError, match="band stack"):
        NPredModel.from_numpy(np.ones((1, 2, 16, 16)), psf,
                              upsampling_factor=None, device="cpu")
    # a calibration: the flux shifted, the background scaled
    model_t = NPredModel.from_numpy(ones, psf, None, device="cpu")
    model_j = JNPredModel.from_numpy(ones, psf, None)
    cal_t = jt.NPredCalibration(shift_x=0.4, shift_y=-1.0,
                                background_norm=1.5)
    cal_j = JNPredCalibration(shift_x=0.4, shift_y=-1.0,
                              background_norm=1.5)
    flux = np.random.RandomState(1).uniform(
        0.5, 2.0, (1, 1, 16, 16)).astype(np.float32)
    got = NPredModels(torch.ones(1, 1, 16, 16), calibration=cal_t,
                      values=[("flux", model_t)]).evaluate(
        (torch.as_tensor(flux),))
    want = JNPredModels(np.ones((1, 1, 16, 16)), cal_j,
                        [("flux", model_j)]).evaluate((jnp.asarray(flux),))
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    with pytest.raises(ValueError, match="reserved"):
        NPredModels(torch.ones(1, 1, 16, 16), values=[("background", None)])


def test_checkpoint_writes_host_tensors(tmp_path):
    params = {"flux": {"flux": torch.arange(4.0).reshape(1, 1, 2, 2)}}
    opt = torch.optim.Adam([params["flux"]["flux"].requires_grad_(True)])
    params["flux"]["flux"].sum().backward()
    opt.step()
    generator = torch.Generator().manual_seed(3)
    save_train_state(tmp_path, params, opt.state_dict(),
                     generator.get_state(), epoch=7)
    got, opt_state, generator_state, epoch = restore_train_state(tmp_path)
    assert epoch == 7
    assert_array_equal(got["flux"]["flux"],
                       params["flux"]["flux"].detach().numpy())
    assert torch.equal(opt_state["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    assert torch.equal(generator_state, generator.get_state())


def test_table_matches_the_jax_packages(torch_default):
    from jolideco_tpu.utils.table import Table as JTable

    data = torch_default.trace_loss.to_dict()
    assert Table.from_dict(data).to_dict() == JTable.from_dict(data).to_dict()
    assert repr(Table.from_dict(data)) == repr(JTable.from_dict(data))
    row = torch_default.trace_loss[-1]
    assert row["filename"] == "" and set(row) == set(data)


@pytest.mark.parametrize("strategy", ["sequential", "joint"])
def test_component_shape_mismatch_raises(datasets, validation, gmm_t,
                                         strategy):
    small = jt.SpatialFluxComponent.from_numpy(np.ones((SIZE // 2, SIZE)))
    deco = jt.MAPDeconvolver(n_epochs=1, update_strategy=strategy,
                             device="cpu")
    with pytest.raises(ValueError, match="expected flux shape"):
        deco.build_loss(datasets, components=small)
    # the validation data are checked too
    halved = {"obs-0": {**validation["obs-0"],
                        "counts": validation["obs-0"]["counts"][:SIZE // 2]}}
    with pytest.raises(ValueError, match="'obs-0' counts"):
        deco.build_loss(datasets, datasets_validation=halved,
                        components=comp_t(gmm_t))
