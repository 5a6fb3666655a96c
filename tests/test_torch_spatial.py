"""The port on an ``(obs, row)`` mesh against ``jolideco_tpu`` and against
its own unsharded run: the pencil FFT (``ops.dist_fft``),
``shard_stacked_spatial`` and ``MAPDeconvolver(mesh=make_obs_row_mesh(2,
2))``.

Four CPU ranks in one gloo group (``jolideco_torch.parallel.launch
.run_ranks``, one thread each; the rank workers live in
``tests/torch_mesh_workers.py``, which imports no JAX), a 2 x 2 mesh: two
observation blocks of two image-row blocks each. The JAX package runs the
same on ``make_obs_row_mesh(2, 2)`` of the 8 virtual CPU devices of
``tests/conftest.py``. Data: 8 observations of 64² (Gaussian PSFs of 9²
and 7²), a flux of 64², and a x2 component (128²) under calibrations.

Bars, each with its reason:

- the pencil FFT, forward and adjoint, against the JAX package's and the
  port's single-device convolution: 1e-6 of the max-abs (float32
  transforms taken one axis at a time instead of two at once);
- the per-observation losses rtol 1e-5 and their flux gradient 1e-5 of
  its max-abs, against both (``tests/test_parallel.py``'s bars for the
  JAX package's own spatial sharding);
- joint runs: flux and trace rtol 1e-4 (``tests/test_parallel.py:
  481-484``), after 20 epochs against the port's unsharded run, after 10
  against the JAX package's mesh run (the two packages' Adam steps part
  by float32 rounding: on this data their unsharded runs differ by up to
  4.1e-5 after 10 epochs and 1.8e-4 after 20); the probe's errors rtol
  1e-4 (the flux's);
- every rank's flux the same bits.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import jolideco_tpu as jj
from jolideco_torch.ops.dist_fft import spatial_fft_shape
from jolideco_torch.ops.fft import convolve_fft_precomputed, kernel_fft
from jolideco_torch.parallel.launch import run_ranks
from jolideco_torch.utils.kernels import gaussian_kernel_2d
from jolideco_tpu.ops.dist_fft import dist_convolve_fft as j_dist_convolve
from jolideco_tpu.ops.dist_fft import spatial_fft_shape as j_spatial_fft_shape
from jolideco_tpu.parallel import StackedPoissonLoss as JStacked
from jolideco_tpu.parallel import make_obs_row_mesh as j_make_obs_row_mesh
from jolideco_tpu.parallel import shard_stacked_spatial as j_shard_spatial
from torch_mesh_workers import (
    EPOCHS_JAX,
    SIZE,
    deconvolve,
    loss_and_gradient,
    make_datasets,
    run_summary,
    sample_flux,
    spatial_worker,
    stacked,
)

torch.set_num_threads(1)
MESH = (2, 2)


def conv_inputs():
    """Two observations ``(2, 1, 1, 64, 64)``, their PSFs' spectra at a
    row-divisible FFT shape and a cotangent."""
    rs = np.random.RandomState(3)
    fft_shape = spatial_fft_shape((SIZE, SIZE), (9, 9), MESH[1])
    x = rs.uniform(0.0, 2.0, (2, 1, 1, SIZE, SIZE)).astype(np.float32)
    kft = np.stack([kernel_fft(torch.as_tensor(gaussian_kernel_2d(
        s, x_size=9, y_size=9).astype(np.float32)), (SIZE, SIZE),
        fft_shape).numpy()[None, None] for s in (1.3, 2.1)])
    g = rs.randn(*x.shape).astype(np.float32)
    return x, kft, g, fft_shape


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(spatial_worker, MESH[0] * MESH[1],
                     args=(*MESH, conv_inputs()), threads=1, timeout=600)


@pytest.fixture(scope="module")
def gathered(ranks):
    """The ranks' blocks of the pencil FFT's output and adjoint, put
    back together."""
    x = conv_inputs()[0]
    y, dx = np.zeros_like(x), np.zeros_like(x)
    for out in ranks:
        obs, rows, y_block, dx_block = out["conv"]
        y[obs, ..., rows, :] = y_block
        dx[obs, ..., rows, :] = dx_block
    return y, dx


def test_spatial_fft_shape_matches_jax():
    for image, kernel, rows in (((64, 64), (9, 9), 2), ((64, 64), (9, 9), 4),
                                ((1024, 1024), (33, 33), 2),
                                ((1000, 904), (33, 33), 3)):
        fh, fw = spatial_fft_shape(image, kernel, rows)
        assert (fh, fw) == j_spatial_fft_shape(image, kernel, rows)
        assert (fw // 2 + 1) % rows == 0


def test_pencil_fft_matches_jax_and_single_device(gathered):
    x, kft, g, fft_shape = conv_inputs()
    y, dx = gathered
    mesh = j_make_obs_row_mesh(*MESH)

    def j_conv(v):
        return j_dist_convolve(v, jnp.asarray(kft), fft_shape, mesh)

    y_j = np.asarray(j_conv(jnp.asarray(x)))
    dx_j = np.asarray(jax.grad(
        lambda v: jnp.sum(j_conv(v) * jnp.asarray(g)))(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt = convolve_fft_precomputed(xt, torch.as_tensor(kft), fft_shape)
    (yt * torch.as_tensor(g)).sum().backward()
    for got, want in ((y, y_j), (y, yt.detach().numpy()),
                      (dx, dx_j), (dx, xt.grad.numpy())):
        assert_allclose(got, want, rtol=0,
                        atol=1e-6 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_spatial():
    """The JAX package's spatially sharded loss: values and gradient."""
    components = jj.FluxComponents({"flux": jj.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32))})
    loss = JStacked.from_datasets(make_datasets(8), components,
                                  row_shards=MESH[1])
    loss = j_shard_spatial(loss, j_make_obs_row_mesh(*MESH))
    f = jnp.asarray(sample_flux())[None, None]
    grad = jax.grad(lambda v: jnp.sum(loss.evaluate((v,))))(f)
    return loss.fft_shape, np.asarray(loss.evaluate((f,))), np.asarray(
        grad)[0, 0]


def close(got, want, rtol):
    assert_allclose(got[0], want[0], rtol=rtol)
    assert_allclose(got[1], want[1], rtol=0,
                    atol=rtol * float(np.abs(want[1]).max()))


def test_row_sharded_loss_matches_jax_and_unsharded(ranks, jax_spatial):
    fft_shape_j, *want_j = jax_spatial
    unsharded = loss_and_gradient(stacked(make_datasets(8)), sample_flux())
    for out in ranks:
        assert out["fft_shape"] == fft_shape_j
        close(out["stacked"], want_j, 1e-5)
        close(out["stacked"], unsharded, 1e-5)


def test_row_sharded_loss_with_calibrations_and_upsampling(ranks):
    """Shifts and the x2 grid act on the whole flux before a rank takes
    its rows; the sum pool stays on the rank; each rank's rows carry
    their share of the pixel mean and of the Stirling term."""
    from jolideco_torch import (
        FluxComponents,
        NPredCalibration,
        NPredCalibrations,
        SpatialFluxComponent,
    )
    from jolideco_torch.parallel import StackedPoissonLoss

    datasets = make_datasets(8)
    calibrations = NPredCalibrations({
        name: NPredCalibration(shift_x=0.3 - 0.1 * i, shift_y=-0.2 + 0.05 * i,
                               background_norm=1.0 + 0.05 * i,
                               weight=1.0 + 0.1 * i)
        for i, name in enumerate(datasets)})
    components = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32), upsampling_factor=2)})
    loss = StackedPoissonLoss.from_datasets(datasets, components,
                                            calibrations=calibrations,
                                            device="cpu")
    flux2 = np.repeat(np.repeat(sample_flux(), 2, 0), 2, 1) / 4
    want = loss_and_gradient(loss, flux2)
    for out in ranks:
        close(out["calibrated"], want, 1e-5)


def test_indivisible_spectrum_is_refused(ranks):
    loss = JStacked.from_datasets(
        make_datasets(8), jj.FluxComponents({
            "flux": jj.SpatialFluxComponent.from_numpy(
                np.ones((SIZE, SIZE), np.float32))}), fft_shape=(72, 72))
    with pytest.raises(ValueError, match="spatial_fft_shape"):
        j_shard_spatial(loss, j_make_obs_row_mesh(*MESH))
    for out in ranks:
        assert "spatial_fft_shape" in out["indivisible"]


@pytest.fixture(scope="module")
def jax_joint():
    """The JAX package's 2 x 2 mesh run of 10 epochs without cycle spin."""
    gmm = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    component = jj.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32),
        prior=jj.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False))
    deco = jj.MAPDeconvolver(
        n_epochs=EPOCHS_JAX, learning_rate=0.1, update_strategy="joint",
        mesh=j_make_obs_row_mesh(*MESH), display_progress=False, seed=0)
    result = deco.run(make_datasets(8), components=component)
    return result.flux_upsampled_total, np.asarray(result.trace_loss["total"])


def test_joint_run_matches_jax_and_unsharded(ranks, jax_joint):
    flux_j, trace_j = jax_joint
    want = run_summary(deconvolve(make_datasets(8), trace_every=1,
                                  n_epochs=EPOCHS_JAX)[1])
    for out in ranks:
        assert out["topology"] == "obs:2xrow:2"
        assert any("does not partition over a row" in message
                   for message in out["pfft_warnings"])
        assert_allclose(out["joint"]["flux"], flux_j, rtol=1e-4)
        assert_allclose(out["joint"]["trace"]["total"], trace_j, rtol=1e-4)
        assert_allclose(out["joint"]["flux"], want["flux"], rtol=1e-4)
        for name, column in want["trace"].items():
            assert_allclose(out["joint"]["trace"][name], column, rtol=1e-4)


def test_cycle_spin_run_and_probe_match_unsharded(ranks):
    result = deconvolve(make_datasets(8), cycle_spin=True,
                        compute_error=True, trace_every=0)[1]
    want = run_summary(result)
    error = result.components["flux"].flux_upsampled_error_numpy
    for out in ranks:
        assert_allclose(out["spin"]["flux"], want["flux"], rtol=1e-4)
        assert_allclose(out["spin"]["loss"], want["loss"], rtol=1e-4)
        assert_allclose(out["spin"]["error"], error, rtol=1e-4)
    for out in ranks[1:]:
        assert_array_equal(out["joint"]["flux"], ranks[0]["joint"]["flux"])
        assert_array_equal(out["spin"]["flux"], ranks[0]["spin"]["flux"])
        assert_array_equal(out["spin"]["error"], ranks[0]["spin"]["error"])
