"""``SparseSpatialFluxComponent`` in the port, against ``jolideco_tpu``.

Point sources at trainable sub-pixel positions, splatted onto the grid
by separable triangular weights (``einsum("n,nh,nw->hw")``), beside a
dense component: the splat and its gradients in the fluxes and both
positions (sources on pixel centres too, where ``max(0, 1 - |d|)`` has
its kinks and both packages split the gradient of the tie), the stacked
loss with per-component PSF dicts against the per-dataset one and the
JAX package's, joint and sequential runs of the sparse example's
components (``examples/sparse_point_sources.py``), the flux-error probe,
resuming and the interop helpers with the sparse leaves, and the
example data's generators (``jolideco_torch.data``) bit for bit.
Tolerances:

- the splat: values rtol 1e-5 and gradients 1e-5 of their max-abs
  (float32 sums in other orders);
- the losses rtol 1e-5 and their parameter gradients rtol 1e-4, atol
  1e-6 (the JAX package's bar for the same comparison,
  ``tests/test_parallel.py``);
- 10 epochs: the dense flux, the source fluxes and positions rtol 1e-4
  (the ``BASELINE.md`` bar for flux maps), the splat within 1e-4 of its
  max-abs; the probe's errors rtol 1e-4 (``tests/test_torch_errors.py``'s
  bar);
- resuming within the port: bitwise.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch import data as tdata
from jolideco_torch.loss import PoissonLoss
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_torch.utils.interop import (
    adam_state_from_optax,
    params_from_jax,
    params_to_numpy,
)
from jolideco_torch.utils.kernels import tophat_kernel_2d
from jolideco_tpu import data as jdata
from jolideco_tpu.loss import PoissonLoss as JPoissonLoss
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked
from jolideco_tpu.utils.kernels import tophat_kernel_2d as jtophat

torch.set_num_threads(1)
N_OBS, SIZE, EPOCHS, HALF = 4, 32, 10, 5
# the sparse example's sources, started half a pixel off
X_POS = np.array([16.0, 16.0, 26.0, 6.0]) + 0.5
Y_POS = np.array([26.0, 6.0, 16.0, 16.0]) - 0.5
FLUX = np.array([500.0, 200.0, 80.0, 30.0])


def example_datasets(n_obs=N_OBS, package=tdata):
    """The sparse example's data, ``n_obs`` draws, with one PSF per
    component."""
    rs = np.random.RandomState(642020)
    datasets = {}
    for i in range(n_obs):
        d = package.gauss_and_point_sources_gauss_psf(random_state=rs)
        d = {key: d[key] for key in ("counts", "psf", "exposure",
                                     "background")}
        d["psf"] = {"diffuse": d["psf"], "points": d["psf"]}
        datasets[f"obs-{i}"] = d
    return datasets


def example_components(pkg, x_pos=X_POS, y_pos=Y_POS):
    comps = pkg.FluxComponents()
    comps["diffuse"] = pkg.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE)), prior=pkg.SmoothnessPrior(width=2))
    comps["points"] = pkg.SparseSpatialFluxComponent.from_numpy(
        flux=FLUX, x_pos=x_pos, y_pos=y_pos, shape=(SIZE, SIZE),
        prior=pkg.UniformPrior())
    return comps


def example_deco(pkg, strategy, n_epochs=EPOCHS, **kwargs):
    if pkg is jt:
        kwargs["device"] = "cpu"
    else:
        kwargs["display_progress"] = False
    return pkg.MAPDeconvolver(n_epochs=n_epochs, learning_rate=0.05,
                              beta=1e-3, update_strategy=strategy, **kwargs)


SPLATS = {
    "sub-pixel": (np.array([3.3, 7.8, 0.4]), np.array([5.6, 1.2, 9.9]),
                  True),
    "pixel-centres": (np.array([3.0, 7.0, 0.0]), np.array([5.0, 1.0, 9.0]),
                      True),
    "linear-flux": (np.array([3.3, 7.8, -0.4]), np.array([5.6, 1.2, 10.3]),
                    False),
}


@pytest.mark.parametrize("case", list(SPLATS))
def test_splat_and_its_gradients_match_jax(case):
    x_pos, y_pos, log = SPLATS[case]
    flux = np.array([5.0, 2.0, 7.0])
    weights = np.random.RandomState(1).uniform(0.5, 2.0, (1, 1, 11, 12))
    kwargs = {"flux": flux, "x_pos": x_pos, "y_pos": y_pos,
              "shape": (11, 12), "use_log_flux": log}
    comp_j = jj.SparseSpatialFluxComponent.from_numpy(**kwargs)
    comp_t = jt.SparseSpatialFluxComponent.from_numpy(**kwargs)
    params_j = comp_j.parameters()
    params_t = {k: v.clone().requires_grad_(True)
                for k, v in comp_t.parameters().items()}

    def objective_j(params):
        return jnp.sum(comp_j.flux_upsampled_from(params) * weights)

    value_j, grads_j = jax.value_and_grad(objective_j)(params_j)
    value_t = torch.sum(comp_t.flux_upsampled_from(params_t)
                        * torch.as_tensor(weights, dtype=torch.float32))
    value_t.backward()
    assert tuple(comp_t.flux.shape) == (1, 1, 11, 12)
    assert_allclose(comp_t.flux_numpy, np.asarray(comp_j.flux_numpy),
                    rtol=1e-5, atol=1e-6)
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    for key in ("flux", "x_pos", "y_pos"):
        want = np.asarray(grads_j[key])
        assert_allclose(params_t[key].grad.numpy(), want, rtol=0,
                        atol=1e-5 * float(np.abs(want).max()), err_msg=key)


def test_sparse_component_surface(tmp_path):
    """The JAX package's attributes and leaves; ``frozen``; copies and
    moves; the prior's leaves; serialisation (``to_dict``, ``from_dict``,
    FITS ``write`` and ``read``, ``plot``) and sky coordinates through
    duck-typed stand-ins (neither package needs astropy for them;
    ``sky_coord`` itself builds an astropy ``SkyCoord``)."""
    comp = jt.SparseSpatialFluxComponent.from_numpy(
        flux=[4.0, 9.0], x_pos=[1.5, 2.0], y_pos=[3.0, 0.25], shape=(6, 5),
        prior=jt.MultiScalePrior(jt.UniformPrior(), n_levels=2))
    assert comp.is_sparse and jt.SparseSpatialFluxComponent.is_sparse
    assert comp.shape == (1, 1, 6, 5) and comp.upsampling_factor == 1
    assert comp.use_log_flux and comp.wcs is None
    assert sorted(comp.parameters()) == ["flux", "prior", "x_pos", "y_pos"]
    assert_allclose(comp.parameters()["flux"].numpy(), np.log([4.0, 9.0]))
    assert_allclose(comp.flux_values_numpy, [4.0, 9.0], rtol=1e-6)
    assert_array_equal(comp.x_pos_numpy, [1.5, 2.0])
    assert_array_equal(comp.y_pos_numpy, [3.0, 0.25])
    assert_allclose(comp.flux_numpy.sum(), 13.0, rtol=1e-6)
    assert comp.flux_upsampled_numpy.shape == (6, 5)
    other = comp.copy()
    other.set_parameters({"x_pos": torch.tensor([0.0, 0.0])})
    assert_array_equal(comp.x_pos_numpy, [1.5, 2.0])
    assert comp.to("cpu") is comp
    frozen = jt.SparseSpatialFluxComponent.from_numpy(
        flux=1.0, x_pos=1.0, y_pos=1.0, shape=(3, 3), frozen=True)
    assert frozen.parameters() == {} and frozen.x_pos.shape == (1,)
    data = comp.to_dict()
    assert data["shape"] == (1, 1, 6, 5)
    assert data["prior"] == comp.prior.to_dict()
    back = jt.SparseSpatialFluxComponent.from_dict(data, device="cpu")
    assert_array_equal(back.x_pos_numpy, comp.x_pos_numpy)
    assert_array_equal(back.flux_values_numpy, comp.flux_values_numpy)
    assert type(back.prior) is jt.MultiScalePrior
    # FITS header keywords carry a prior's own settings, not a prior
    # nested in it (in the JAX package too): the file gets the default
    plain = jt.SparseSpatialFluxComponent.from_dict(
        {**data, "prior": {"type": "uniform"}}, device="cpu")
    plain.write(tmp_path / "points.fits")
    read = jt.SparseSpatialFluxComponent.read(tmp_path / "points.fits",
                                              device="cpu")
    assert_array_equal(read.y_pos_numpy, comp.y_pos_numpy)
    assert read.shape == comp.shape and read.use_log_flux
    pytest.importorskip("matplotlib").use("Agg")
    ax = comp.plot()
    assert_array_equal(ax.images[0].get_array(), comp.flux_numpy)

    class FakeSkyCoord:
        def to_pixel(self, wcs):
            return np.array([10.0, 3.0]), np.array([40.0, 7.0])

    placed = jt.SparseSpatialFluxComponent.from_sky_coord(
        FakeSkyCoord(), wcs=None, flux=np.array([1.0, 2.0]), shape=(64, 64))
    assert_array_equal(placed.x_pos_numpy, [10.0, 3.0])
    assert_array_equal(placed.y_pos_numpy, [40.0, 7.0])


def integer_source_components(pkg):
    """``tests/test_parallel.py``'s sparse-plus-dense components."""
    rs = np.random.RandomState(642020)
    for _ in range(N_OBS):
        jdata.gauss_and_point_sources_gauss_psf(random_state=rs)
    comps = pkg.FluxComponents()
    comps["diffuse"] = pkg.SpatialFluxComponent.from_numpy(
        flux=rs.gamma(20, size=(SIZE, SIZE)))
    comps["points"] = pkg.SparseSpatialFluxComponent.from_numpy(
        flux=np.array([10.0, 5.0]), x_pos=np.array([16.0, 26.0]),
        y_pos=np.array([26.0, 16.0]), shape=(SIZE, SIZE))
    return comps


def _flat(tree, path=()):
    """``(path, leaf)`` of nested dicts, keys sorted at every level."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flat(value, path + (key,))
        else:
            yield path + (key,), value


def test_sparse_plus_dense_losses_match_jax():
    """The stacked loss against the per-dataset one and the JAX package's:
    values and the gradients of every leaf, the positions included."""
    datasets = example_datasets()
    comps_j = integer_source_components(jj)
    comps_t = integer_source_components(jt)

    stacked_j = JStacked.from_datasets(datasets, comps_j)

    def total_j(p):
        return jnp.sum(stacked_j.evaluate(comps_j.fluxes_from(p)))

    value_j, grads_j = jax.jit(jax.value_and_grad(total_j))(
        comps_j.parameters())
    grads_j = dict(_flat(jax.tree_util.tree_map(np.asarray, grads_j)))
    per_dataset_j = JPoissonLoss.from_datasets(datasets, comps_j).evaluate(
        comps_j.to_flux_tuple())
    for loss in (TStacked.from_datasets(datasets, comps_t, device="cpu"),
                 PoissonLoss.from_datasets(datasets, comps_t, device="cpu")):
        params = {name: {k: v.clone().requires_grad_(True)
                         for k, v in leaves.items()}
                  for name, leaves in comps_t.parameters().items()}
        losses = loss.evaluate(comps_t.fluxes_from(params))
        assert_allclose(losses.detach().numpy(), np.asarray(per_dataset_j),
                        rtol=1e-5)
        losses.sum().backward()
        assert_allclose(losses.sum().item(), float(value_j), rtol=1e-5)
        for key, leaf in _flat(params):
            want = grads_j[key]
            assert_allclose(leaf.grad.numpy(), want, rtol=1e-4, atol=1e-6,
                            err_msg=str(key))


@pytest.fixture(scope="module")
def datasets():
    return example_datasets()


@pytest.fixture(scope="module")
def jax_runs(datasets):
    return {strategy: example_deco(jj, strategy).run(
        datasets, components=example_components(jj))
        for strategy in ("joint", "sequential")}


def assert_runs_close(got, want, rtol=1e-4):
    # the splat within rtol of its max-abs: elementwise, a pixel where a
    # source's weight nearly vanishes carries the position's error alone
    for name, share in (("diffuse", 0.0), ("points", rtol)):
        flux_j = np.asarray(want.components[name].flux_upsampled_numpy)
        assert_allclose(got.components[name].flux_upsampled_numpy, flux_j,
                        rtol=rtol, atol=share * float(np.abs(flux_j).max()),
                        err_msg=name)
    points_t, points_j = got.components["points"], want.components["points"]
    for attr in ("x_pos_numpy", "y_pos_numpy", "flux_values_numpy"):
        assert_allclose(getattr(points_t, attr),
                        np.asarray(getattr(points_j, attr)), rtol=rtol,
                        err_msg=attr)


@pytest.mark.parametrize("strategy", ["joint", "sequential"])
def test_deconvolver_with_sparse_sources_matches_jax(datasets, jax_runs,
                                                     strategy):
    """The sparse example's components over four of its observations:
    10 epochs, then the flux-error probe (finite, positive)."""
    got = example_deco(jt, strategy, compute_error=True).run(
        datasets, components=example_components(jt))
    want = jax_runs[strategy]
    assert_runs_close(got, want)
    moved = np.abs(got.components["points"].x_pos_numpy - X_POS).max()
    assert moved > 0.05
    assert_allclose(got.trace_loss["total"], want.trace_loss["total"],
                    rtol=1e-4)
    for name in ("diffuse", "points"):
        errors = got.components[name].flux_upsampled_error_numpy
        assert errors.shape == (SIZE, SIZE)
        assert np.isfinite(errors).all() and (errors > 0).all()


@pytest.mark.parametrize("strategy", ["joint", "sequential"])
def test_probe_with_sparse_sources_matches_jax(datasets, strategy):
    """Each component's flux errors against the JAX package's probe at
    the same fluxes, the sparse image's too. Its ``H · 1`` runs over the
    whole grid: where no source's counts reach a data pixel they are
    float32 rounding around 0, the clip's kink, so the packages agree
    only where every data pixel sees a source (a grid of 25 here; with
    the example's four they part by up to 26%, by the signs of their
    FFTs' roundings, ``ROADMAP.md`` section 3)."""
    grid = np.arange(3.3, SIZE, 7.0)
    x_pos, y_pos = np.meshgrid(grid, grid + 0.4)

    def components(pkg):
        comps = example_components(pkg)
        comps["points"] = pkg.SparseSpatialFluxComponent.from_numpy(
            flux=np.full(x_pos.size, 50.0), x_pos=x_pos.ravel(),
            y_pos=y_pos.ravel(), shape=(SIZE, SIZE))
        return comps

    comps_j, comps_t = components(jj), components(jt)
    errors_j = example_deco(jj, strategy).build_loss(
        datasets, components=comps_j).fluxes_error(comps_j.to_flux_tuple())
    errors_t = example_deco(jt, strategy).build_loss(
        datasets, components=comps_t).fluxes_error(comps_t.to_flux_tuple())
    for name in ("diffuse", "points"):
        assert_allclose(errors_t[name].numpy(), np.asarray(errors_j[name]),
                        rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("strategy", ["joint", "sequential"])
def test_resume_with_sparse_leaves_equals_an_uninterrupted_run(
        datasets, strategy, tmp_path):
    whole = example_deco(jt, strategy).run(
        datasets, components=example_components(jt))
    first = example_deco(jt, strategy, n_epochs=HALF).run(
        datasets, components=example_components(jt))
    first.save_state(tmp_path / "state")
    second = example_deco(jt, strategy, n_epochs=HALF).run(
        datasets, components=example_components(jt),
        resume_from=tmp_path / "state")
    third = example_deco(jt, strategy, n_epochs=HALF).run(
        datasets, components=first.components, resume_from=first)
    for resumed in (second, third):
        for (key, a), (_, b) in zip(
                _flat(params_to_numpy(resumed.components.parameters())),
                _flat(params_to_numpy(whole.components.parameters()))):
            assert_array_equal(a, b, err_msg=str(key))
        assert_array_equal(resumed.loss_per_step,
                           whole.loss_per_step[HALF * (1 + 3 * (
                               strategy == "sequential")):])


def test_interop_carries_a_jax_run_with_sparse_leaves(datasets, jax_runs):
    """The JAX package's params and Adam state after 5 joint epochs,
    carried across, go on in the port to the JAX run of 10."""
    half = example_deco(jj, "joint", n_epochs=HALF).run(
        datasets, components=example_components(jj))
    params_np = jax.tree_util.tree_map(
        np.asarray, {"components": half.components.parameters()})
    components = example_components(jt)
    params_from_jax(params_np, components)
    assert_array_equal(components["points"].x_pos_numpy,
                       np.asarray(half.components["points"].x_pos))
    adam = next(s for s in half.opt_state if hasattr(s, "mu"))
    state = adam_state_from_optax(jax.tree_util.tree_map(np.asarray, adam),
                                  components.parameters(), lr=0.05)
    # diffuse flux, and the sources' flux, x_pos and y_pos
    assert len(state["state"]) == 4
    carried = jt.MAPDeconvolverResult(config={}, components=components,
                                      opt_state=state)
    got = example_deco(jt, "joint", n_epochs=HALF).run(
        datasets, components=components, resume_from=carried)
    assert_runs_close(got, jax_runs["joint"])


def test_bare_sparse_component_runs():
    """``run`` and ``build_loss`` take a bare sparse component (named
    ``"flux"``), as the JAX package's do."""
    data = tdata.point_source_gauss_psf(random_state=np.random.RandomState(1))
    datasets = {"obs": {k: data[k] for k in ("counts", "psf", "exposure",
                                             "background")}}
    comp = jt.SparseSpatialFluxComponent.from_numpy(
        flux=800.0, x_pos=15.6, y_pos=16.3, shape=(SIZE, SIZE))
    deco = jt.MAPDeconvolver(n_epochs=20, learning_rate=0.1, device="cpu")
    assert list(deco.build_loss(datasets, components=comp)
                .prior_loss.priors) == ["flux"]
    result = deco.run(datasets, components=comp)
    points = result.components["flux"]
    assert abs(points.x_pos_numpy[0] - 16.0) < 0.3
    assert abs(points.y_pos_numpy[0] - 16.0) < 0.3
    assert result.flux_upsampled_total.shape == (SIZE, SIZE)


GENERATORS = ["point_source_gauss_psf", "disk_source_gauss_psf",
              "gauss_and_point_sources_gauss_psf"]


@pytest.mark.parametrize("name", GENERATORS)
def test_data_generators_match_jax_bit_for_bit(name):
    for kwargs in ({}, {"shape": (40, 48), "shape_psf": (9, 13)}):
        got = getattr(tdata, name)(random_state=np.random.RandomState(7),
                                   **kwargs)
        want = getattr(jdata, name)(random_state=np.random.RandomState(7),
                                    **kwargs)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert_array_equal(got[key], want[key], err_msg=key)
    for radius in (2, 3.5, 5.2):
        assert_array_equal(tophat_kernel_2d(radius), jtophat(radius))
    assert_array_equal(example_datasets(2)["obs-1"]["counts"],
                       example_datasets(2, jdata)["obs-1"]["counts"])
