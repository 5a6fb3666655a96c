"""The port on an observation mesh against ``jolideco_tpu`` and against its
own unsharded run.

Four CPU ranks in one gloo group (``jolideco_torch.parallel.launch
.run_ranks``, one thread each; the rank workers live in
``tests/torch_mesh_workers.py``, which imports no JAX) run
``make_obs_mesh()`` with 8 observations of 64² (two a rank): the sharded
stacked loss under ``"fft"`` and under ``"pfft"`` with 2 observations a
rank (the pairs stay on their rank) and 3 (they do not: the rank
convolves through the ``rfft2``), and ``MAPDeconvolver(mesh=...)``
joint runs under the ``builtin-8x8-v1`` GMM prior from a flat start. The
JAX package runs the same on ``make_obs_mesh(4)`` of the 8 virtual CPU
devices of ``tests/conftest.py``.

Bars, each with its reason:

- per-observation losses against the port's unsharded loss rtol 1e-6
  (the same arithmetic; the gather adds zeros), their flux gradient 1e-6
  of its max-abs (the ranks' gradients summed in another order: the
  JAX package's bar, ``tests/test_prior_sharding.py``); against the JAX
  package rtol 1e-5 and 1e-5 of the max-abs (``tests/test_torch_stacked
  .py``); the pair-packed matrix DFT against the FFT 1e-4 (the JAX
  package's own bar between the two, ``tests/test_parallel.py``);
- joint runs: the flux and the trace rtol 1e-4 (``tests/test_parallel
  .py:481-484``): 10 epochs without cycle spin against the JAX package's
  mesh run and the port's unsharded run (the two packages' Adam steps
  part by float32 rounding: on this data their unsharded runs differ by
  up to 4.1e-5 after 10 epochs and 1.8e-4 after 20), 20 epochs with the
  cycle spin against the port's unsharded run; the probe's errors after
  the run rtol 1e-4 (the flux's);
- every rank's parameters and flux the same bits.

A rank that dies or raises fails the call within seconds, not at the
suite's time limit.
"""

import time

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import jolideco_tpu as jj
from jolideco_torch.parallel import make_obs_mesh
from jolideco_torch.parallel.launch import run_ranks
from jolideco_tpu.parallel import StackedPoissonLoss as JStacked
from jolideco_tpu.parallel import make_obs_mesh as j_make_obs_mesh
from torch_mesh_workers import (
    EPOCHS_JAX,
    MESH_CONV_CASES,
    deconvolve,
    dying_rank_worker,
    loss_and_gradient,
    make_datasets,
    mesh_refusals_worker,
    obs_mesh_worker,
    raising_rank_worker,
    run_summary,
    sample_flux,
    stacked,
)

torch.set_num_threads(1)
RANKS = 4


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def ranks(folder):
    return run_ranks(obs_mesh_worker, RANKS, args=(str(folder),),
                     threads=1, timeout=600)


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded runs of what the ranks run."""
    datasets = make_datasets(8)
    flux = sample_flux()
    out = {"fft": loss_and_gradient(stacked(datasets), flux)}
    for label, n_obs in (("pfft_even", 2 * RANKS), ("pfft_odd", 3 * RANKS)):
        data = make_datasets(n_obs)
        out[label] = {mode: loss_and_gradient(stacked(data, conv_mode=mode),
                                              flux)
                      for mode in ("fft", "pfft")}
    for label, (mode, per_rank) in MESH_CONV_CASES.items():
        loss = stacked(make_datasets(per_rank * RANKS), conv_mode=mode)
        out[label] = {"whole": loss_and_gradient(loss, flux)}
        if loss.ct_pairs is not None:
            # the same loss, each observation alone
            loss.ct_pairs = None
            out[label]["single"] = loss_and_gradient(loss, flux)
    out["joint"] = run_summary(deconvolve(datasets, n_epochs=EPOCHS_JAX)[1])
    out["ct_joint"] = run_summary(deconvolve(datasets, n_epochs=EPOCHS_JAX,
                                             conv_mode="ct")[1])
    result = deconvolve(datasets, cycle_spin=True, trace_every=5,
                        compute_error=True)[1]
    out["spin"] = run_summary(result)
    out["spin"]["error"] = result.components["flux"].flux_upsampled_error_numpy
    out["stop_early"] = run_summary(deconvolve(
        datasets, n_epochs=30, stop_early=True, stop_early_n_average=3,
        validation=make_datasets(4, seed=5))[1])
    out["sequential"] = run_summary(deconvolve(
        datasets, n_epochs=2, update_strategy="sequential")[1])
    return out


def jax_losses(datasets, flux):
    components = jj.FluxComponents({"flux": jj.SpatialFluxComponent.from_numpy(
        np.ones(flux.shape, np.float32))})
    loss = JStacked.from_datasets(datasets, components)
    loss = loss.shard(j_make_obs_mesh(RANKS))
    f = jnp.asarray(flux)[None, None]
    values = np.asarray(loss.evaluate((f,)))
    grad = jax.grad(lambda x: jnp.sum(loss.evaluate((x,))))(f)
    return values, np.asarray(grad)[0, 0]


@pytest.fixture(scope="module")
def jax_joint():
    """The JAX package's mesh run of 10 epochs without cycle spin."""
    datasets = make_datasets(8)
    gmm = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    component = jj.SpatialFluxComponent.from_numpy(
        np.ones((64, 64), np.float32),
        prior=jj.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False))
    deco = jj.MAPDeconvolver(
        n_epochs=EPOCHS_JAX, learning_rate=0.1, update_strategy="joint",
        mesh=j_make_obs_mesh(RANKS), display_progress=False, seed=0)
    result = deco.run(datasets, components=component)
    return result.flux_upsampled_total, np.asarray(result.trace_loss["total"])


def close(got, want, rtol):
    """Values within ``rtol``, gradients within ``rtol`` of the max-abs."""
    assert_allclose(got[0], want[0], rtol=rtol)
    assert_allclose(got[1], want[1], rtol=0,
                    atol=rtol * float(np.abs(want[1]).max()))


def test_sharded_fft_loss(ranks, unsharded):
    want_j = jax_losses(make_datasets(8), sample_flux())
    for out in ranks:
        close(out["fft"], unsharded["fft"], 1e-6)
        close(out["fft"], want_j, 1e-5)


@pytest.mark.parametrize("label,pairs_local", [("pfft_even", True),
                                               ("pfft_odd", False)])
def test_sharded_pfft_loss(ranks, unsharded, label, pairs_local):
    # pairs on their rank: the matrix DFT of the unsharded pfft loss;
    # otherwise each observation's rfft2, as the unsharded fft loss (the
    # JAX package's pfft loss on the CPU is its per-observation rFFT,
    # held by test_sharded_fft_loss); both within the matrix DFT's bar of
    # the FFT
    same = unsharded[label]["pfft" if pairs_local else "fft"]
    for out in ranks:
        assert out[label][2] is pairs_local
        close(out[label][:2], same, 1e-6)
        close(out[label][:2], unsharded[label]["fft"], 1e-4)


@pytest.mark.parametrize("label", list(MESH_CONV_CASES))
def test_sharded_ct_mxu_direct_losses(ranks, unsharded, label):
    """``"ct"`` keeps its pairs on a rank holding an even count of
    observations and convolves each alone otherwise (the JAX package's
    rule, ``tests/test_ct_conv.py:272-296``); ``"mxu"`` and ``"direct"``
    shard by observation. Against the unsharded loss doing the same
    arithmetic, 1e-6 (the gathers add zeros; the ranks' gradients summed
    in another order); ``"ct"``'s single transforms against its pairs,
    1e-5 (split-float products in other sums)."""
    mode, per_rank = MESH_CONV_CASES[label]
    pairs_local = mode == "ct" and per_rank % 2 == 0
    want = unsharded[label]
    for out in ranks:
        assert out[label][2] is pairs_local
        same = want["whole"] if pairs_local or mode != "ct" else \
            want["single"]
        close(out[label][:2], same, 1e-6)
        close(out[label][:2], want["whole"], 1e-5)


def test_replicate_gives_every_rank_rank_zeros_values(ranks):
    """``parallel.mesh.replicate``: copies of a nest of tensors holding
    rank 0's values on every rank, the rank's own tensors untouched."""
    for rank, out in enumerate(ranks):
        a, b, none, own = out["replicate"]
        assert_array_equal(a, [1.0, 1.0])
        assert_array_equal(b, -np.ones((1, 3)))
        assert none is None and own == rank + 1


def test_joint_ct_run_matches_unsharded(ranks, unsharded):
    want = unsharded["ct_joint"]
    for out in ranks:
        assert_allclose(out["ct_joint"]["flux"], want["flux"], rtol=1e-4)
        assert_allclose(out["ct_joint"]["loss"], want["loss"], rtol=1e-4)
    for out in ranks[1:]:
        assert_array_equal(out["ct_joint"]["flux"],
                           ranks[0]["ct_joint"]["flux"])


def test_joint_run_matches_jax_and_unsharded(ranks, unsharded, jax_joint):
    flux_j, trace_j = jax_joint
    for out in ranks:
        run = out["joint"]
        assert out["topology"] == f"obs:{RANKS}"
        assert_allclose(run["flux"], flux_j, rtol=1e-4)
        assert_allclose(run["trace"]["total"], trace_j, rtol=1e-4)
        assert_allclose(run["flux"], unsharded["joint"]["flux"], rtol=1e-4)
        for name, column in unsharded["joint"]["trace"].items():
            assert_allclose(run["trace"][name], column, rtol=1e-4)
        assert_allclose(run["loss"], unsharded["joint"]["loss"], rtol=1e-4)


@pytest.mark.parametrize("run", ["spin", "replicated_prior"])
def test_cycle_spin_run_matches_unsharded(ranks, unsharded, run):
    """``shard_prior`` splits the prior's patches (or, off, every rank
    scores them all); the port's own draws on every rank."""
    want = unsharded["spin"]
    for out in ranks:
        assert_allclose(out[run]["flux"], want["flux"], rtol=1e-4)
        assert_allclose(out[run]["loss"], want["loss"], rtol=1e-4)
    for out in ranks:
        assert_allclose(out["spin"]["trace"]["total"], want["trace"]["total"],
                        rtol=1e-4)
        assert_allclose(out["spin"]["error"], want["error"], rtol=1e-4)


def test_ranks_end_with_the_same_bits(ranks):
    for out in ranks[1:]:
        assert_array_equal(out["params"], ranks[0]["params"])
        for run in ("joint", "spin", "replicated_prior", "stop_early"):
            assert_array_equal(out[run]["flux"], ranks[0][run]["flux"])
            assert_array_equal(out[run]["loss"], ranks[0][run]["loss"])
        assert_array_equal(out["spin"]["error"], ranks[0]["spin"]["error"])


def test_stop_early_on_a_mesh(ranks, unsharded):
    want = unsharded["stop_early"]
    assert want["n_epochs"] < 30
    for out in ranks:
        got = out["stop_early"]
        assert got["n_epochs"] == want["n_epochs"]
        assert_allclose(got["trace"]["datasets-validation-total"],
                        want["trace"]["datasets-validation-total"], rtol=1e-4)


def test_rank_zero_writes_the_checkpoints(ranks, folder):
    assert [out["checkpoint_writes"] for out in ranks] == [3, 0, 0, 0]
    assert len(list((folder / "checkpoints").glob("*.asdf"))) == 3


def test_sequential_strategy_warns_and_runs_unsharded(ranks, unsharded):
    for out in ranks:
        assert any("sequential per-dataset loop runs unsharded" in m
                   for m in out["sequential_warnings"])
        assert_allclose(out["sequential"]["flux"],
                        unsharded["sequential"]["flux"], rtol=1e-6)


def test_mesh_refuses_the_per_dataset_fallback(ranks):
    for out in ranks:
        assert out["unstackable"] is not None and "rmf" in out["unstackable"]


def test_mesh_builders_refuse_other_sizes():
    for messages in run_ranks(mesh_refusals_worker, 2, threads=1,
                              timeout=120):
        assert "refusing" in messages[0]
        assert "every rank" in messages[1]
        assert "refusing" in messages[2]


def test_make_obs_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="not initialised"):
        make_obs_mesh()


def test_a_dying_rank_fails_the_call_fast():
    start = time.monotonic()
    # the survivor's collective or the parent's watch reports it first
    with pytest.raises(RuntimeError, match="run_ranks: rank"):
        run_ranks(dying_rank_worker, 2, threads=1, timeout=120)
    assert time.monotonic() - start < 60


def test_a_raising_rank_reports_its_traceback():
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(raising_rank_worker, 2, threads=1, timeout=120)
    assert time.monotonic() - start < 60
