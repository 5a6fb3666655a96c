"""The port's joint MAP deconvolution against ``jolideco_tpu`` end to end.

4 observations of 128² (the JAX package pair-packs them) and 3 (one odd
tail), the ``builtin-8x8-v1`` GMM prior without cycle spin, 20 joint
Adam epochs at lr 0.1, flat flux start. The JAX run uses its default CPU
dispatch (XLA FFT, XLA patch scorer) and a scanned epoch loop; the port
runs its plain versions eagerly. Tolerances: the step-0 loss to rtol
1e-5 and its gradient to rtol 1e-5 with a floor of 1e-6 of the max-abs;
the final flux to rtol 1e-4 (the ``BASELINE.md`` bar for flux maps).

Adam's first step is ``-lr g / (|g| + eps)``: a pixel whose step-0
gradient is within float32 rounding of zero takes a first step that
depends on that rounding, and two correct float32 implementations then
part by far more than 1e-4 there. The data are therefore built so that
the flat start lies below the truth everywhere (a flat sky of 8 under a
halo and point sources) and the test asserts that every pixel's step-0
gradient is at least 1e-3 of the largest.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp
import optax

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.core import OPTIMIZER
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_torch.utils.kernels import gaussian_kernel_2d

torch.set_num_threads(1)
SIZE = 128
EPOCHS = 20


def make_datasets(n_obs, seed=1):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    truth = 5.0 * np.exp(
        -((xx - 64) ** 2 + (yy - 60) ** 2) / (2 * 12.0**2)
    ) + 8.0
    for _ in range(12):
        y0, x0 = rs.randint(8, SIZE - 8, 2)
        truth[y0, x0] += rs.gamma(2.0) * 20
    datasets = {}
    for i in range(n_obs):
        psf = gaussian_kernel_2d(1.5 + 0.3 * i, x_size=9,
                                 y_size=9).astype(np.float32)
        exposure = np.full((SIZE, SIZE), 1.0 + 0.1 * i, np.float32)
        background = np.full((SIZE, SIZE), 1.0, np.float32)
        counts = rs.poisson(background + truth * exposure).astype(np.float32)
        datasets[f"obs-{i}"] = {"counts": counts, "psf": psf,
                                "exposure": exposure,
                                "background": background}
    return datasets


def jax_setup(datasets):
    gmm = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    prior = jj.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False)
    comp = jj.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32), prior=prior
    )
    deco = jj.MAPDeconvolver(
        n_epochs=EPOCHS, learning_rate=0.1, update_strategy="joint",
        scan_epochs=True, trace_every=0, display_progress=False, seed=0,
    )
    return gmm, comp, deco


def torch_setup(gmm_j):
    # the port's GMM from the very arrays the JAX GMM was built from
    gmm = gmm_from_arrays(np.asarray(gmm_j.means),
                          np.asarray(gmm_j.covariances),
                          np.asarray(gmm_j.weights), gmm_j.meta.stride)
    prior = jt.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False)
    comp = jt.SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32), prior=prior
    )
    deco = jt.MAPDeconvolver(
        n_epochs=EPOCHS, learning_rate=0.1, update_strategy="joint",
        trace_every=0, seed=0, device="cpu",
    )
    return comp, deco


@pytest.mark.parametrize("n_obs", [4, 3])
def test_joint_run_matches_jax(n_obs):
    datasets = make_datasets(n_obs)
    gmm_j, comp_j, deco_j = jax_setup(datasets)
    comp_t, deco_t = torch_setup(gmm_j)

    # step-0 loss and gradient (the joint objective, key-free: no spin)
    total_j = deco_j.build_loss(datasets, components=comp_j)
    comps_j = jj.FluxComponents({"flux": comp_j})

    def loss_j(params):
        fluxes = comps_j.fluxes_from(params)
        losses = total_j.poisson_loss.evaluate(fluxes)
        prior = total_j.prior_loss(fluxes, params=params,
                                   key=jax.random.PRNGKey(0))
        return jnp.sum(losses * total_j.poisson_loss.weights) - prior

    value_j, grad_j = jax.value_and_grad(loss_j)(comps_j.parameters())
    grad_j = np.asarray(grad_j["flux"]["flux"])

    comps_t = jt.FluxComponents({"flux": comp_t})
    total_t = deco_t.build_loss(datasets, components=comps_t,
                               device=torch.device("cpu"))
    log_flux = comp_t.parameters()["flux"].clone().requires_grad_(True)
    params_t = {"flux": {"flux": log_flux}}
    value_t = total_t(comps_t.fluxes_from(params_t), params=params_t)
    value_t.backward()

    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    assert_allclose(log_flux.grad.numpy(), grad_j, rtol=1e-5,
                    atol=1e-6 * float(np.abs(grad_j).max()))
    assert np.abs(grad_j).min() >= 1e-3 * np.abs(grad_j).max()

    # 20 epochs end to end
    result_j = deco_j.run(datasets, components=comp_j)
    result_t = deco_t.run(datasets, components=comp_t)
    assert result_t.loss_per_step.shape == (EPOCHS,)
    assert_allclose(result_t.loss_per_step[0], float(value_j), rtol=1e-5)
    assert_allclose(result_t.components["flux"].flux_upsampled_numpy,
                    result_j.components["flux"].flux_upsampled_numpy,
                    rtol=1e-4)


def test_adam_step_matches_optax():
    """Three Adam steps on the same gradients give the same updates.

    The update rule is the same (bias-corrected moments, eps outside the
    square root). optax takes the bias corrections ``1 - b**t`` in
    float32, where ``1 - 0.999`` carries a relative rounding error of
    1.3e-5 (6.4e-6 after the square root); PyTorch takes them in
    float64. Tolerance: rtol 2e-5 on each step's update.
    """
    rs = np.random.RandomState(0)
    p0 = rs.randn(32).astype(np.float32)
    grads = [rs.randn(32).astype(np.float32) * 10.0 ** -k for k in range(3)]

    tx = optax.adam(learning_rate=0.1, b1=0.9, b2=0.999, eps=1e-8)
    p_j = jnp.asarray(p0)
    state = tx.init(p_j)
    p_t = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = OPTIMIZER["adam"]([p_t], learning_rate=0.1, betas=(0.9, 0.999),
                            eps=1e-8)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        before = p_t.detach().clone()
        p_t.grad = torch.as_tensor(g)
        opt.step()
        assert_allclose((p_t.detach() - before).numpy(), np.asarray(updates),
                        rtol=2e-5)


@pytest.mark.parametrize("momentum,nesterov",
                         [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_steps_match_optax(momentum, nesterov):
    """Three SGD steps on the same gradients: rtol 1e-6 (float32)."""
    rs = np.random.RandomState(1)
    p0 = rs.randn(32).astype(np.float32)
    grads = [rs.randn(32).astype(np.float32) for _ in range(3)]

    tx = optax.sgd(learning_rate=0.1, momentum=momentum or None,
                   nesterov=nesterov)
    p_j = jnp.asarray(p0)
    state = tx.init(p_j)
    p_t = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = OPTIMIZER["sgd"]([p_t], learning_rate=0.1, momentum=momentum,
                           nesterov=nesterov)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        p_t.grad = torch.as_tensor(g)
        opt.step()
    assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=1e-6)


def test_unported_options_raise(tmp_path):
    """The sequential strategy, the loss trace, early stopping,
    checkpoints and meshes are ported: the deconvolver takes them (a
    checkpoint path is made and recorded, a mesh's topology recorded as
    the JAX package writes it). ``conv_mode="ct"`` still raises
    ``NotImplementedError``; an unknown strategy raises the JAX package's
    ``ValueError``."""
    checkpoints = str(tmp_path / "checkpoints")
    for kwargs in ({"update_strategy": "sequential", "trace_every": 0},
                   {"update_strategy": "joint", "trace_every": 1},
                   {"update_strategy": "joint", "trace_every": 0,
                    "stop_early": True},
                   {"update_strategy": "joint", "trace_every": 0,
                    "checkpoint_path": checkpoints}):
        config = jt.MAPDeconvolver(**kwargs).to_dict()
        assert {k: config[k] for k in kwargs} == kwargs
    assert (tmp_path / "checkpoints").is_dir()
    mesh = SimpleNamespace(mesh_dim_names=("obs", "row"), shape=(2, 2))
    config = jt.MAPDeconvolver(update_strategy="joint", trace_every=0,
                               mesh=mesh).to_dict()
    assert config["mesh"] == "obs:2xrow:2"
    # every conv mode of the JAX package is ported and recorded; one it
    # does not document is refused
    for mode in ("ct", "mxu", "direct"):
        config = jt.MAPDeconvolver(update_strategy="joint", trace_every=0,
                                   conv_mode=mode).to_dict()
        assert config["conv_mode"] == mode
    with pytest.raises(ValueError, match="conv_mode"):
        jt.MAPDeconvolver(update_strategy="joint", trace_every=0,
                          conv_mode="cufft")
    with pytest.raises(ValueError, match="update strategy"):
        jt.MAPDeconvolver(update_strategy="one at a time")
