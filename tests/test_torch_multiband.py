"""Band stacks and energy redistribution (RMF) in the port's forward model,
against ``jolideco_tpu``.

A dataset's arrays may be 3-D band stacks ``(C, H, W)``, its PSF a
``(C, k, k)`` stack (or one 2-D PSF broadcast over the bands) and its
``rmf`` a ``(C, K)`` matrix folded after the sum pool and before the
clip, an array or a dict keyed by component. The three RMFs of the JAX
package's own tests (``tests/test_parallel.py``): scalar ``1 x 1``,
square ``2 x 2`` and non-square ``2 -> 3``, at 4 x 16², through
``NPredModels``, ``PoissonLoss`` and ``StackedPoissonLoss`` under
``conv_mode`` ``"fft"`` and ``"pfft"`` (the JAX matrix DFT in the Pallas
interpreter, the port's plain version, ``"split"`` on both sides, the
bands in the pair batch). Then the deconvolver, both strategies, on the
shell of ``utils/bench_data.make_multiband_datasets`` at 4 x 32² x 3
bands. Tolerances:

- forward models and per-observation losses: rtol 1e-4 (float32 FFTs
  and einsums in other orders; 2e-6 measured);
- flux gradients: rtol 2e-4 and atol 1e-6 of their max-abs (the JAX
  package's bar between its stacked and per-dataset losses);
- 10 epochs under ``UniformPrior`` with the flux-error probe: flux and
  errors rtol 1e-4 (the ``BASELINE.md`` bar for flux maps); the pfft run
  against JAX's pfft run in the interpreter, rtol 2e-4 and atol 1e-5 of
  the max-abs (``tests/test_torch_pfft_path.py``'s bar).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.loss import PoissonLoss
from jolideco_torch.models import NPredModels
from jolideco_torch.parallel import DataValidationError
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_torch.utils.bench_data import (
    band_flux_estimate,
    band_rmf,
    make_multiband_datasets,
)
from jolideco_tpu.config import force_pallas
from jolideco_tpu.loss import PoissonLoss as JPoissonLoss
from jolideco_tpu.models import NPredModels as JNPredModels
from jolideco_tpu.parallel.stacked import (
    DataValidationError as JDataValidationError,
)
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

torch.set_num_threads(1)
N_OBS, SIZE, RUN_SIZE, EPOCHS = 4, 16, 32, 10
KINDS = [("scalar", 1, 1), ("square", 2, 2), ("nonsquare", 2, 3)]


def rmf_datasets(c=2, k=None, rmf_kind="square", seed=0, psf_sizes=None):
    """4 x 16² datasets of ``c`` bands folded into ``k`` by an RMF (the JAX
    package's ``tests/test_parallel.py::_rmf_datasets``); ``psf_sizes``
    gives each observation its own band-PSF size (ragged stacks)."""
    rng = np.random.RandomState(seed)
    k = c if k is None else k
    if rmf_kind == "scalar":
        rmf = np.array([[0.9]], np.float32)
    elif rmf_kind == "square":
        rmf = np.array([[0.7, 0.3], [0.2, 0.8]], np.float32)[:c, :k]
    else:
        rmf = rng.uniform(0.1, 0.9, (c, k)).astype(np.float32)
        rmf /= rmf.sum(axis=1, keepdims=True)
    datasets = {}
    for i in range(N_OBS):
        size = 5 if psf_sizes is None else psf_sizes[i]
        psf = rng.uniform(0, 1, (c, size, size)).astype(np.float32)
        psf /= psf.sum(axis=(1, 2), keepdims=True)
        in_shape = (SIZE, SIZE) if c == 1 else (c, SIZE, SIZE)
        out_shape = (SIZE, SIZE) if k == 1 and c == 1 else (k, SIZE, SIZE)
        datasets[f"o{i}"] = {
            "counts": rng.poisson(3.0, out_shape).astype(np.float32),
            "background": np.full(out_shape, 0.5, np.float32),
            "exposure": rng.uniform(0.8, 1.2, in_shape).astype(np.float32),
            "psf": psf[0] if c == 1 else psf,
            "rmf": rmf,
        }
    return datasets


def flux_image(size=SIZE, seed=0):
    return np.random.RandomState(seed).uniform(
        0.5, 2.0, (size, size)).astype(np.float32)


def components(pkg, flux, name="c0"):
    return pkg.FluxComponents(
        {name: pkg.SpatialFluxComponent.from_numpy(flux)})


def jax_values_and_grad(loss, flux):
    f = jnp.asarray(flux)[None, None]
    values, grad = jax.jit(lambda x: (
        loss.evaluate((x,)),
        jax.grad(lambda y: jnp.sum(loss.evaluate((y,))))(x)))(f)
    return np.asarray(values), np.asarray(grad)[0, 0]


def torch_values_and_grad(loss, flux):
    f = torch.as_tensor(flux)[None, None].requires_grad_(True)
    values = loss.evaluate((f,))
    (grad,) = torch.autograd.grad(values.sum(), f)
    return values.detach().numpy(), grad.numpy()[0, 0]


def assert_grad_close(got, want):
    assert_allclose(got, want, rtol=2e-4,
                    atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind,c,k", KINDS, ids=[k[0] for k in KINDS])
def test_npred_models_fold_the_rmf(kind, c, k):
    datasets = rmf_datasets(c=c, k=k, rmf_kind=kind)
    flux = flux_image()
    dataset = datasets["o1"]
    got = NPredModels.from_dataset_numpy(
        dataset, components(jt, flux), device="cpu").evaluate(
        (torch.as_tensor(flux)[None, None],))
    want = JNPredModels.from_dataset_numpy(
        dataset, components(jj, flux)).evaluate(
        (jnp.asarray(flux)[None, None],))
    # the JAX package's background of a band stack is (1, 1, K, H, W),
    # so its total is too: the same values
    assert tuple(got.shape) == (1, k, SIZE, SIZE)
    assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape),
                    rtol=1e-4)


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX package's per-observation losses and flux gradients: its
    per-dataset loss for each RMF kind, and for the non-square one (two
    bands into three) its stacked loss under each conv mode."""
    flux = flux_image()
    out = {}
    for kind, c, k in KINDS:
        datasets = rmf_datasets(c=c, k=k, rmf_kind=kind)
        comps = components(jj, flux)
        out[kind, "per-dataset"] = jax_values_and_grad(
            JPoissonLoss.from_datasets(datasets, comps), flux)
    datasets = rmf_datasets(c=2, k=3, rmf_kind="nonsquare")
    comps = components(jj, flux)
    out["nonsquare", "fft"] = jax_values_and_grad(
        JStacked.from_datasets(datasets, comps), flux)
    with force_pallas("interpret"):
        out["nonsquare", "pfft"] = jax_values_and_grad(
            JStacked.from_datasets(datasets, comps, conv_mode="pfft"), flux)
    return out


@pytest.mark.parametrize("conv_mode", ["fft", "pfft"])
@pytest.mark.parametrize("kind,c,k", KINDS, ids=[k[0] for k in KINDS])
def test_losses_and_gradients_match_jax(jax_losses, kind, c, k, conv_mode):
    """The port's stacked loss under each conv mode, and its per-dataset
    loss, against the JAX package's per-dataset loss (and its stacked
    loss of the same conv mode, the matrix DFT in the interpreter, where
    the bands go into the pair batch)."""
    datasets = rmf_datasets(c=c, k=k, rmf_kind=kind)
    flux = flux_image()
    comps = components(jt, flux)
    stacked = TStacked.from_datasets(datasets, comps, conv_mode=conv_mode,
                                     device="cpu")
    assert tuple(stacked.rmfs["c0"].shape) == (N_OBS, c, k)
    assert tuple(stacked.counts.shape) == (N_OBS, 1, k, SIZE, SIZE)
    assert (stacked.pfft_pairs is not None) == (conv_mode == "pfft")
    got = {conv_mode: torch_values_and_grad(stacked, flux)}
    if conv_mode == "fft":
        got["per-dataset"] = torch_values_and_grad(
            PoissonLoss.from_datasets(datasets, comps, device="cpu"), flux)
    refs = [ref for ref in (conv_mode, "per-dataset")
            if (kind, ref) in jax_losses]
    for tag, (values_t, grad_t) in got.items():
        for ref in refs:
            values, grad = jax_losses[kind, ref]
            assert_allclose(values_t, values, rtol=1e-4,
                            err_msg=f"{tag} against {ref}")
            assert_grad_close(grad_t, grad)


@pytest.mark.parametrize("case", ["dict-rmf", "ragged-psfs", "2d-psf"])
def test_rmf_forms_and_band_psfs_match_jax(case):
    """A dict RMF keyed by component (and ``evaluate_dataset``, the
    sequential strategy's path over a stacked loss), band PSFs of other
    sizes per observation (padded per shape group), and one 2-D PSF
    broadcast over the bands."""
    if case == "ragged-psfs":
        datasets = rmf_datasets(psf_sizes=(3, 5, 5, 7))
    else:
        datasets = rmf_datasets()
    for dataset in datasets.values():
        if case == "dict-rmf":
            dataset["rmf"] = {"c0": dataset["rmf"]}
        elif case == "2d-psf":
            dataset["psf"] = dataset["psf"][0]
    flux = flux_image()
    stacked = TStacked.from_datasets(datasets, components(jt, flux),
                                     device="cpu")
    per_dataset = JPoissonLoss.from_datasets(datasets, components(jj, flux))
    want = jax_values_and_grad(per_dataset, flux)
    got = torch_values_and_grad(stacked, flux)
    assert_allclose(got[0], want[0], rtol=1e-4)
    assert_grad_close(got[1], want[1])
    f = (torch.as_tensor(flux)[None, None],)
    for idx in range(N_OBS):
        assert_allclose(float(stacked.evaluate_dataset(idx, f)), want[0][idx],
                        rtol=1e-4)


def _mixed_presence(datasets):
    datasets["o3"].pop("rmf")


def _output_mismatch(datasets):
    for d in datasets.values():
        d["counts"], d["background"] = d["counts"][:2], d["background"][:2]


def _input_mismatch(datasets):
    for d in datasets.values():
        d["rmf"] = np.ones((3, 2), np.float32) / 2.0


def _dict_missing(datasets):
    for d in datasets.values():
        d["rmf"] = {"not-c0": d["rmf"]}


INVALID = {
    "mixed-presence": (_mixed_presence, "square", 2, ValueError, "rmf"),
    "output-channels": (_output_mismatch, "nonsquare", 3,
                        DataValidationError, "output"),
    "input-channels": (_input_mismatch, "square", 2, DataValidationError,
                       "input"),
    "dict-missing": (_dict_missing, "square", 2, DataValidationError,
                     "'c0'"),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_invalid_rmfs_raise_the_jax_types(case):
    """Each refusal of the stacked build, of the JAX package's type: an
    RMF on some datasets only cannot stack (a plain ``ValueError``, on
    which the joint strategy falls back); channel counts that do not
    match and a dict without the component are invalid for either path
    (`DataValidationError`, a ``ValueError`` too)."""
    edit, kind, k, error, match = INVALID[case]
    datasets = rmf_datasets(c=2, k=k, rmf_kind=kind)
    edit(datasets)
    flux = flux_image()
    with pytest.raises(error, match=match) as got:
        TStacked.from_datasets(datasets, components(jt, flux), device="cpu")
    with pytest.raises(ValueError, match=match) as want:
        JStacked.from_datasets(datasets, components(jj, flux))
    assert isinstance(got.value, DataValidationError) == isinstance(
        want.value, JDataValidationError)
    assert issubclass(DataValidationError, ValueError)
    if case == "dict-missing":
        with pytest.raises(ValueError, match=match):
            PoissonLoss.from_datasets(datasets, components(jt, flux),
                                      device="cpu")


def test_rmf_moves_counts_between_bands():
    """The fold runs: with the RMF the predicted band sums are the
    identity RMF's times the matrix, and the stacked loss changes."""
    datasets, _ = make_multiband_datasets(n_classes=2, size=RUN_SIZE,
                                          psf_scale=0.1)
    flux = band_flux_estimate(datasets)
    comps = components(jt, flux, "flux")
    identity = {n: dict(d, rmf=np.eye(3, dtype=np.float32))
                for n, d in datasets.items()}
    f = comps.fluxes_from()
    sums = {}
    for tag, data in (("rmf", datasets), ("identity", identity)):
        models = NPredModels.from_dataset_numpy(data["psf0"], comps,
                                                device="cpu")
        sums[tag] = models.evaluate_per_component(f)["flux"].sum(
            dim=(-2, -1))[0].numpy()
    assert_allclose(sums["rmf"], sums["identity"] @ band_rmf(3), rtol=1e-5)
    assert np.abs(sums["rmf"] / sums["identity"] - 1).max() > 0.05
    losses = [float(TStacked.from_datasets(data, comps, device="cpu")(f))
              for data in (datasets, identity)]
    assert abs(losses[0] - losses[1]) > 1e-3


@pytest.fixture(scope="module")
def run_data():
    datasets, _ = make_multiband_datasets(n_classes=N_OBS, size=RUN_SIZE,
                                          psf_scale=0.1)
    return datasets, band_flux_estimate(datasets)


RUNS = [("joint", "fft"), ("joint", "pfft"), ("sequential", "fft")]


@pytest.fixture(scope="module")
def jax_runs(run_data):
    """The JAX package's joint run with its probe, and its sequential
    run."""
    datasets, flux = run_data
    runs = {}
    for strategy in ("joint", "sequential"):
        deco = jj.MAPDeconvolver(n_epochs=EPOCHS, update_strategy=strategy,
                                 compute_error=strategy == "joint",
                                 display_progress=False)
        runs[strategy] = deco.run(
            datasets, components=jj.SpatialFluxComponent.from_numpy(flux))
    return runs


@pytest.mark.parametrize("strategy,conv_mode", RUNS,
                         ids=["-".join(r) for r in RUNS])
def test_deconvolver_on_band_stacks_matches_jax(run_data, jax_runs, strategy,
                                                conv_mode):
    """Four event classes of three bands with the RMF: 10 epochs (the
    joint ones with the flux-error probe), flux, errors and trace against
    the JAX package's run of the same strategy (its ``"fft"`` run for the
    port's ``"pfft"`` one, by the bar between the two conv modes)."""
    datasets, flux = run_data
    joint = strategy == "joint"
    deco = jt.MAPDeconvolver(n_epochs=EPOCHS, update_strategy=strategy,
                             conv_mode=conv_mode, compute_error=joint,
                             device="cpu")
    got = deco.run(datasets, components=jt.SpatialFluxComponent.from_numpy(
        flux))
    want = jax_runs[strategy]
    flux_t = got.components["flux"].flux_upsampled_numpy
    flux_j = want.components["flux"].flux_upsampled_numpy
    if conv_mode == "pfft":
        assert_allclose(flux_t, flux_j, rtol=2e-4,
                        atol=1e-5 * float(np.abs(flux_j).max()))
    else:
        assert_allclose(flux_t, flux_j, rtol=1e-4)
        assert_allclose(got.trace_loss["total"], want.trace_loss["total"],
                        rtol=1e-4)
    if joint:
        errors_j = np.asarray(
            want.components["flux"]._flux_upsampled_error)[0, 0]
        assert_allclose(got.components["flux"].flux_upsampled_error_numpy,
                        errors_j, rtol=1e-4)
    assert float(np.abs(flux_t - flux).max()) > 1e-2
