"""``MultiScalePrior`` in the port against ``jolideco_tpu``, and its
trainable leaves through the deconvolver, interop and resuming.

- The prior (3 levels, an asinh image norm): value rtol 1e-5; gradients
  with respect to the flux to 1e-5 of their max-abs, to the level
  weights and the norm's alpha and beta rtol 1e-5; with the fused switch
  on and off. The JAX keys' draws are injected: ``split(key, n_levels +
  1)``, the last for the own cycle spin, the others each level's prior's.
  The JAX prior runs its default CPU dispatch (MAP) or, marginalised,
  its Pallas kernels in interpret mode (``force_pallas("interpret")``),
  the marginalised prior's reference (``tests/test_torch_marginalise.py``).
- The Hessian probe over the levels, under injected draws: ``H · 1`` to
  1e-5 of its max-abs (the gradients' bar: the Poisson and prior terms
  cancel in part, so small entries carry the large ones' rounding).
- The deconvolver, joint (10 Adam steps) and sequential (3 epochs, 12
  steps) at 4 x 64² under
  ``MultiScalePrior(GMMPatchPrior(marginalize=True,
  norm=ASinhImageNorm()))`` with a random SPD GMM whose softmax weights
  are mixed, without cycle spins: flux rtol 1e-4 (the flux maps' bar),
  the prior's trained leaves (level log weights, alpha, beta) rtol 1e-5
  with a floor of 1e-5 (leaves of order one, which Adam's steps of 0.1
  move by one to five; alpha ends near 0.02, where the floor holds it).
  Marginalised, so that no near-tied argmax parts the two packages.
- The same trained state carried from the JAX package into the port
  (``params_from_jax``, ``adam_state_from_optax``) and through the
  port's ``save_state``/``resume_from``.
- A x2 calibrated joint run under ``GMMPatchPrior(marginalize=True)``,
  flux rtol 1e-4 against the JAX package.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.config import force_fused
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.utils.interop import (
    adam_state_from_optax,
    gmm_from_arrays,
    params_from_jax,
    params_to_numpy,
)
from jolideco_tpu.config import force_fused as j_force_fused
from jolideco_tpu.config import force_pallas as j_force_pallas
from jolideco_tpu.ops.image import cycle_spin
from test_torch_marginalise import mixed_gmm_arrays
from test_torch_prior import gmm_pair
from test_torch_prior_options import jax_draws
from test_torch_sequential import make_datasets

torch.set_num_threads(1)
N_LEVELS = 3
# epochs of the deconvolver runs: 10 joint steps, 12 sequential ones
EPOCHS = {"joint": 10, "sequential": 3}


def jax_multiscale_draws(key, prior_t, shape):
    """The JAX ``MultiScalePrior``'s draws under ``key``."""
    keys = jax.random.split(key, prior_t.n_levels + 1)
    spin = None
    if prior_t.cycle_spin:
        _, s = cycle_spin(keys[-1], jnp.zeros((8, 8)),
                          prior_t.prior.patch_shape)
        spin = tuple(int(v) for v in np.asarray(s))
    levels = []
    for idx in range(prior_t.n_levels):
        level_shape = prior_t._level_shape(shape, idx)
        draws = jax_draws(keys[idx], prior_t.prior, level_shape)
        inner = prior_t.prior
        if not (inner.cycle_spin_subpix or inner.jitter
                or inner.patch_fraction < 1):
            draws = draws["spin"]
        levels.append(draws)
    return {"spin": spin, "levels": levels}


def multiscale_pair(gmm_j, gmm_t, stride, marginalize=False, spin=True,
                    weights=(0.5, 0.3, 0.2)):
    def build(pkg, gmm):
        return pkg.MultiScalePrior(
            pkg.GMMPatchPrior(gmm=gmm, stride=stride, cycle_spin=spin,
                              marginalize=marginalize,
                              norm=pkg.priors.patches.core.ImageNorm
                              .from_dict({"type": "asinh", "alpha": 0.7,
                                          "beta": 1.8})),
            n_levels=N_LEVELS, weights=weights, cycle_spin=spin)

    return build(jj, gmm_j), build(jt, gmm_t)


def make_flux(shape, seed=5):
    rs = np.random.RandomState(seed)
    return rs.uniform(0.2, 3.0, size=shape).astype(np.float32)[None, None]


@pytest.mark.parametrize("name,shape", [
    ("builtin-8x8-v1", (64, 64)), ("random-4x4", (48, 40)),
    ("mixed", (64, 64)),
])
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_multiscale_value_and_gradients(name, shape, fused):
    marginalize = name == "mixed"
    if marginalize:
        arrays = mixed_gmm_arrays()
        gmm_j = jj.GaussianMixtureModel.from_numpy(*arrays)
        gmm_t, stride = gmm_from_arrays(*arrays, None), 4
    else:
        gmm_j, gmm_t, stride = gmm_pair(name)
    prior_j, prior_t = multiscale_pair(gmm_j, gmm_t, stride, marginalize)
    key = jax.random.PRNGKey(11)
    flux = make_flux(shape)
    params_j = prior_j.parameters()

    def value_j(f, p):
        return prior_j(f, params=p, key=key)

    with j_force_fused(fused), j_force_pallas(
            "interpret" if marginalize else "auto"):
        val_j, (g_flux, g_params) = jax.value_and_grad(
            value_j, argnums=(0, 1))(jnp.asarray(flux), params_j)

    x = torch.as_tensor(flux).requires_grad_(True)
    params_t = prior_t.parameters()
    leaves = {"log_weights": params_t["log_weights"].clone()
              .requires_grad_(True),
              "prior": {"norm": {k: v.clone().requires_grad_(True)
                                 for k, v in params_t["prior"]["norm"]
                                 .items()}}}
    tf.reset_counters()
    with force_fused(fused):
        fused_levels = [prior_t.prior._fused_ok(prior_t._level_shape(
            flux.shape, idx)) for idx in range(N_LEVELS)]
        value = prior_t(x, params=leaves,
                        shifts=jax_multiscale_draws(key, prior_t, flux.shape))
    value.backward()
    on_fused = fused == "auto" and name != "random-4x4"
    assert fused_levels == [on_fused] * N_LEVELS
    assert tf.fused_forward_plain.calls == (N_LEVELS if on_fused else 0)

    assert_allclose(value.item(), float(val_j), rtol=1e-5)
    g_flux = np.asarray(g_flux)
    atol = (1e-4 if marginalize else 1e-5) * float(np.abs(g_flux).max())
    assert_allclose(x.grad.numpy(), g_flux, rtol=0, atol=atol)
    assert_allclose(leaves["log_weights"].grad.numpy(),
                    np.asarray(g_params["log_weights"]), rtol=1e-5,
                    atol=1e-6 * float(np.abs(g_params["log_weights"]).max()))
    for k in ("alpha", "beta"):
        assert_allclose(leaves["prior"]["norm"][k].grad.numpy(),
                        np.asarray(g_params["prior"]["norm"][k]),
                        rtol=1e-4)


def test_multiscale_second_order_and_weights():
    gmm_j, gmm_t, stride = gmm_pair("builtin-8x8-v1")
    prior_j, prior_t = multiscale_pair(gmm_j, gmm_t, stride)
    assert_allclose(prior_t.weights.numpy(), np.asarray(prior_j.weights),
                    rtol=1e-6)
    for shape in [(1, 1, 64, 64), (1, 1, 8, 64), (1, 1, 20, 20)]:
        assert prior_t.second_order_ok(shape) == prior_j.second_order_ok(
            shape) or shape[-1] < 128
        with force_fused("off"):
            assert prior_t.second_order_ok(shape)
    assert not prior_t.second_order_ok((1, 1, 64, 64))
    data_t, data_j = prior_t.to_dict(), prior_j.to_dict()
    # the softmax in float32, exp and sum in another order: last bits
    assert_allclose(data_t.pop("weights"), data_j.pop("weights"), rtol=1e-6)
    assert data_t == data_j
    back = jt.priors.Prior.from_dict(prior_t.to_dict())
    assert type(back) is jt.MultiScalePrior
    assert_allclose(back.weights.numpy(), prior_t.weights.numpy(), rtol=1e-6)
    assert back.prior.to_dict() == prior_t.prior.to_dict()


@pytest.mark.parametrize("marginalize", [False, True])
def test_multiscale_probe(marginalize):
    """``TotalLoss.hessian_diagonals`` through every level on the
    patch-level scorer (the fused switch off for all of them)."""
    datasets = make_datasets(n_obs=2)
    if marginalize:
        arrays = mixed_gmm_arrays()
        gmm_j = jj.GaussianMixtureModel.from_numpy(*arrays)
        gmm_t, stride = gmm_from_arrays(*arrays, None), 4
    else:
        gmm_j, gmm_t, stride = gmm_pair("builtin-8x8-v1")
    prior_j, prior_t = multiscale_pair(gmm_j, gmm_t, stride, marginalize)
    flux = make_flux((64, 64))[0, 0] + 7.0
    key = jax.random.PRNGKey(3)

    comps_j = jj.FluxComponents({"flux": jj.SpatialFluxComponent.from_numpy(
        flux, prior=prior_j)})
    deco_j = jj.MAPDeconvolver(update_strategy="joint")
    with j_force_pallas("interpret" if marginalize else "auto"):
        loss_j = deco_j.build_loss(datasets, components=comps_j)
        h_j = loss_j.hessian_diagonals(comps_j.to_flux_tuple(), key=key)[0]

    comps_t = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        flux, prior=prior_t)})
    deco_t = jt.MAPDeconvolver(update_strategy="joint", device="cpu")
    loss_t = deco_t.build_loss(datasets, components=comps_t)
    fluxes = comps_t.to_flux_tuple()
    draws = jax_multiscale_draws(jax.random.split(key, 1)[0], prior_t,
                                 fluxes[0].shape)
    tf.reset_counters()
    h_t = loss_t.hessian_diagonals(fluxes, shifts={"flux": draws})[0]
    assert tf.fused_forward_plain.calls == 0
    h_j = np.asarray(h_j)
    assert_allclose(h_t.numpy(), h_j, rtol=0,
                    atol=1e-5 * float(np.abs(h_j).max()))


# ----------------------------------------------------------------------
# the deconvolver


def run_multiscale(pkg, gmm, datasets, strategy, n_epochs=None,
                   params=None, resume_from=None, **kwargs):
    """``EPOCHS[strategy]`` epochs (or ``n_epochs``) of the multiscale
    deconvolver from a flux of ones, or from ``params``."""
    prior = pkg.MultiScalePrior(
        pkg.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False,
                          marginalize=True,
                          norm=pkg.priors.patches.core.ImageNorm.from_dict(
                              {"type": "asinh"})),
        n_levels=N_LEVELS, cycle_spin=False)
    comp = pkg.SpatialFluxComponent.from_numpy(
        np.ones((64, 64), np.float32), prior=prior)
    if params is not None:
        comp.set_parameters(params)
    deco = pkg.MAPDeconvolver(
        n_epochs=EPOCHS[strategy] if n_epochs is None else n_epochs,
        update_strategy=strategy, trace_every=0, **kwargs)
    return deco.run(datasets, components=comp, resume_from=resume_from)


def leaves_of(result):
    """The trained leaves in a result's prior (either package's)."""
    prior = result.components["flux"].prior
    return {"log_weights": np.array(prior._log_weights, np.float64),
            "alpha": prior.prior.norm.alpha, "beta": prior.prior.norm.beta}


@pytest.fixture(scope="module")
def mixed_pair():
    arrays = mixed_gmm_arrays()
    return (jj.GaussianMixtureModel.from_numpy(*arrays),
            gmm_from_arrays(*arrays, None))


@pytest.fixture(scope="module")
def data4():
    return make_datasets(n_obs=4)


@pytest.fixture(scope="module")
def jax_runs(mixed_pair, data4):
    """The JAX package's run of a strategy, made once."""
    cache = {}

    def get(strategy):
        if strategy not in cache:
            with j_force_pallas("interpret"):
                cache[strategy] = run_multiscale(
                    jj, mixed_pair[0], data4, strategy,
                    display_progress=False, scan_epochs=True)
        return cache[strategy]

    return get


@pytest.mark.parametrize("strategy", ["joint", "sequential"])
def test_multiscale_deconvolver_matches_jax(strategy, jax_runs, mixed_pair,
                                            data4):
    result_j = jax_runs(strategy)
    tf.reset_counters()
    result_t = run_multiscale(jt, mixed_pair[1], data4, strategy,
                              device="cpu")
    steps = EPOCHS[strategy] * (4 if strategy == "sequential" else 1)
    assert tf.fused_backward_marg_plain.calls == N_LEVELS * steps
    assert_allclose(result_t.components["flux"].flux_upsampled_numpy,
                    result_j.components["flux"].flux_upsampled_numpy,
                    rtol=1e-4)
    got, want = leaves_of(result_t), leaves_of(result_j)
    # the trained leaves moved, and they are the result's prior's
    init = np.log(np.full(N_LEVELS, 1.0 / N_LEVELS))
    assert np.abs(got["log_weights"] - init).max() > 0.1
    assert abs(got["alpha"] - 1.0) > 0.1 and abs(got["beta"] - 1.0) > 0.1
    for k in ("log_weights", "alpha", "beta"):
        assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_multiscale_leaves_load_from_jax_and_resume(jax_runs, mixed_pair,
                                                    data4, tmp_path):
    """A JAX run's params and Adam state, level weights and norm
    parameters included, go into the port, which continues it as the JAX
    package does (3 more joint steps); and the port's own ``save_state``
    carries the leaves through ``resume_from`` bit for bit."""
    from jolideco_torch.core import MAPDeconvolverResult

    result_j = jax_runs("joint")
    params_np = jax.tree_util.tree_map(
        np.asarray, {"components": result_j.components.parameters()})
    prior = jt.MultiScalePrior(
        jt.GMMPatchPrior(gmm=mixed_pair[1], stride=4, cycle_spin=False,
                         marginalize=True, norm=jt.ASinhImageNorm()),
        n_levels=N_LEVELS, cycle_spin=False)
    comps = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        np.ones((64, 64), np.float32), prior=prior)})
    loaded = params_from_jax(params_np, comps)
    leaves_np = params_np["components"]["flux"]["prior"]
    assert np.array_equal(prior._log_weights.numpy(),
                          leaves_np["log_weights"])
    assert prior.prior.norm.alpha == float(
        leaves_np["prior"]["norm"]["alpha"][0])
    opt = adam_state_from_optax(
        jax.tree_util.tree_map(np.asarray, result_j.opt_state[0]),
        loaded["components"])
    assert len(opt["state"]) == 4  # flux, log_weights, alpha, beta

    with j_force_pallas("interpret"):
        more_j = run_multiscale(
            jj, mixed_pair[0], data4, "joint", n_epochs=3,
            params=params_np["components"]["flux"], resume_from=result_j,
            display_progress=False, scan_epochs=True)
    carried = MAPDeconvolverResult(config={}, components=comps,
                                   opt_state=opt)
    more_t = jt.MAPDeconvolver(n_epochs=3, update_strategy="joint",
                               trace_every=0, device="cpu").run(
        data4, components=comps, resume_from=carried)
    assert_allclose(more_t.components["flux"].flux_upsampled_numpy,
                    more_j.components["flux"].flux_upsampled_numpy,
                    rtol=1e-4)
    got, want = leaves_of(more_t), leaves_of(more_j)
    for k in ("log_weights", "alpha", "beta"):
        assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)

    # the port's own state on disk: 3 + 2 epochs give the bits of 5
    first = run_multiscale(jt, mixed_pair[1], data4, "joint", n_epochs=3,
                           device="cpu")
    first.save_state(tmp_path / "state")
    resumed = run_multiscale(jt, mixed_pair[1], data4, "joint", n_epochs=2,
                             device="cpu", resume_from=tmp_path / "state")
    whole = run_multiscale(jt, mixed_pair[1], data4, "joint", n_epochs=5,
                           device="cpu")
    assert np.array_equal(resumed.components["flux"].flux_upsampled_numpy,
                          whole.components["flux"].flux_upsampled_numpy)
    got, want = leaves_of(resumed), leaves_of(whole)
    assert np.array_equal(got.pop("log_weights"), want.pop("log_weights"))
    assert got == want


def test_upsampled_calibrated_run_under_the_gmm_prior_matches_jax(
        mixed_pair):
    """The x2 flux (128²) with an ``NPredCalibration`` per observation
    under ``GMMPatchPrior(marginalize=True)``, 10 joint steps at 4 x 64²
    counts seen at known sub-pixel offsets: flux rtol 1e-4, the trained
    shifts and log norms within 1e-5 (``tests/test_torch_calibrations.py``'s
    bars), against the JAX package."""
    from jolideco_torch.utils.bench_data import make_shifted_datasets
    from test_torch_calibrations import run_calibrations, run_component

    datasets = make_shifted_datasets(size=64, psf_size=9, seed=3)
    results = {}
    for pkg, gmm in ((jj, mixed_pair[0]), (jt, mixed_pair[1])):
        prior = pkg.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False,
                                  marginalize=True)
        kwargs = ({"device": "cpu"} if pkg is jt
                  else {"display_progress": False})
        deco = pkg.MAPDeconvolver(n_epochs=EPOCHS["joint"],
                                  update_strategy="joint", trace_every=0,
                                  **kwargs)
        with j_force_pallas("interpret"):
            results[pkg.__name__] = deco.run(
                datasets, components=run_component(pkg, prior),
                calibrations=run_calibrations(pkg))
    got, want = results["jolideco_torch"], results["jolideco_tpu"]
    flux_t = got.components["flux"].flux_upsampled_numpy
    assert flux_t.shape == (128, 128)
    assert_allclose(flux_t, want.components["flux"].flux_upsampled_numpy,
                    rtol=1e-4)
    for name, cal in got.calibrations.items():
        assert_allclose(cal.shift_xy.numpy(),
                        np.asarray(want.calibrations[name].shift_xy),
                        rtol=0, atol=1e-5)
        assert_allclose(cal._background_norm.numpy(),
                        np.asarray(want.calibrations[name]._background_norm),
                        rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# how far two runs part when their starts differ by float32 rounding:
# chip_smoke.py phase 10 (f) holds the card against the CPU from the
# data's estimate, not from a flat start. The numbers PERF.md quotes:
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_multiscale.py


def perturbed_run(datasets, kind, start, eps, steps):
    """``steps`` joint steps under ``profile_step.make_prior(kind)`` from a
    flat start or the data's estimate, its log-flux plus ``eps`` times a
    fixed normal field: the flux and the prior's leaves."""
    from jolideco_torch.utils.profile_step import make_prior

    prior = make_prior(kind, jt.GaussianMixtureModel.from_registry(
        "astro-snr-v1"))
    if start == "flat":
        component = jt.SpatialFluxComponent.from_numpy(
            np.ones((128, 128), np.float32), prior=prior)
    else:
        component = jt.SpatialFluxComponent.from_flux_init_datasets(
            list(datasets.values()), prior=prior)
    noise = np.random.RandomState(0).randn(*component.shape)
    with torch.no_grad():
        component._flux_upsampled += eps * torch.as_tensor(
            noise.astype(np.float32))
    result = jt.MAPDeconvolver(n_epochs=steps, update_strategy="joint",
                               trace_every=0, device="cpu").run(
        datasets, components=component)
    prior = result.components["flux"].prior
    leaves = [v.detach().numpy().ravel() for v in (
        [prior._log_weights] + list(prior.parameters()["prior"]["norm"]
                                    .values())
        if kind == "multiscale" else [])]
    return (result.flux_upsampled_total,
            np.concatenate(leaves) if leaves else np.zeros(0))


def parting(datasets, kind, start, steps):
    """The two runs' flux difference as a share of its max-abs, and their
    leaves' largest difference, for a perturbation of 1e-6."""
    (fa, la), (fb, lb) = (perturbed_run(datasets, kind, start, eps, steps)
                          for eps in (0.0, 1e-6))
    return (float(np.abs(fa - fb).max() / np.abs(fb).max()),
            float(np.abs(la - lb).max()) if la.size else 0.0)


def test_a_data_estimate_start_is_well_conditioned():
    """From the data's estimate two jitter runs whose starts differ by
    1e-6 stay within 1e-4 of the flux's max-abs after 5 steps; from a
    flat start they part by more than a tenth (the MAP argmaxes of flat
    patches follow the rounding)."""
    from jolideco_torch.utils.bench_data import make_datasets as bench

    datasets = bench(n_obs=4, size=128, psf_size=9, seed=1)
    assert parting(datasets, "jitter", "estimate", 5)[0] <= 1e-4
    assert parting(datasets, "jitter", "flat", 5)[0] > 0.1


def main():
    from jolideco_torch.utils.bench_data import make_datasets as bench

    torch.set_num_threads(4)
    datasets = bench(n_obs=4, size=128, psf_size=9, seed=1)
    for kind in ("multiscale", "jitter"):
        for start in ("flat", "estimate"):
            for steps in (5, 20):
                share, moved = parting(datasets, kind, start, steps)
                print(f"{kind} from the {start} start, {steps} steps: flux "
                      f"{share:.3g} of the max-abs, leaves {moved:.3g}")


if __name__ == "__main__":
    main()
