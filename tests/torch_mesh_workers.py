"""Rank workers of the port's mesh tests (``tests/test_torch_mesh.py``,
``test_torch_spatial.py``, ``test_torch_prior_sharding.py``).

Each worker runs in a process of its own, spawned by
``jolideco_torch.parallel.launch.run_ranks`` into a gloo group on the CPU,
and returns numpy arrays and plain values that the test compares, in the
parent, with the JAX package and with the port's unsharded run. This
module imports torch and ``jolideco_torch`` only, so that no rank
imports JAX.
"""

import functools
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

SIZE = 64
EPOCHS = 20
# the runs held against the JAX package: the two packages' Adam steps
# part by float32 rounding (optax takes its bias corrections in float32,
# tests/test_torch_sequential.py), and on this data their unsharded runs
# differ by up to 4.1e-5 after 10 epochs and 1.8e-4 after 20, at the
# border pixels
EPOCHS_JAX = 10


def make_datasets(n_obs, size=SIZE, seed=1):
    """A flat sky of 8 under a halo and point sources, seen ``n_obs``
    times (Gaussian PSFs of two sizes): the flat start lies below the
    truth everywhere, so that no pixel's first gradient is near zero."""
    from jolideco_torch.utils.kernels import gaussian_kernel_2d

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    truth = 5.0 * np.exp(-((xx - size / 2) ** 2 + (yy - size / 2 + 4) ** 2)
                         / (2 * (size / 10) ** 2)) + 8.0
    for _ in range(6):
        y0, x0 = rs.randint(8, size - 8, 2)
        truth[y0, x0] += rs.gamma(2.0) * 20
    datasets = {}
    for i in range(n_obs):
        k = 9 if i % 2 == 0 else 7
        psf = gaussian_kernel_2d(1.5 + 0.2 * i, x_size=k,
                                 y_size=k).astype(np.float32)
        exposure = rs.uniform(0.9, 1.2, (size, size)).astype(np.float32)
        background = np.full((size, size), 1.0, np.float32)
        counts = rs.poisson(background + truth * exposure).astype(np.float32)
        datasets[f"obs-{i}"] = {"counts": counts, "psf": psf,
                                "exposure": exposure,
                                "background": background}
    return datasets


def sample_flux(size=SIZE, seed=9):
    return np.random.RandomState(seed).uniform(
        0.5, 2.0, (size, size)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def builtin_gmm():
    """The ``builtin-8x8-v1`` GMM, read once a process (a read takes
    about a second)."""
    from jolideco_torch import GaussianMixtureModel

    return GaussianMixtureModel.from_registry("builtin-8x8-v1")


def gmm_prior(cycle_spin, marginalize=False):
    from jolideco_torch import GMMPatchPrior

    return GMMPatchPrior(gmm=builtin_gmm(), stride=4, cycle_spin=cycle_spin,
                         marginalize=marginalize)


def deconvolve(datasets, mesh=None, cycle_spin=False, n_epochs=EPOCHS,
               **kwargs):
    """``MAPDeconvolver(update_strategy="joint")`` from a flat start under
    the GMM prior on the CPU; the result."""
    from jolideco_torch import MAPDeconvolver, SpatialFluxComponent

    shape = next(iter(datasets.values()))["counts"].shape
    component = SpatialFluxComponent.from_numpy(
        np.ones(shape, np.float32), prior=gmm_prior(cycle_spin))
    validation = kwargs.pop("validation", None)
    kwargs.setdefault("update_strategy", "joint")
    deco = MAPDeconvolver(n_epochs=n_epochs, learning_rate=0.1, seed=0,
                          device="cpu", mesh=mesh, **kwargs)
    return deco, deco.run(datasets, components=component,
                          datasets_validation=validation)


def run_summary(result):
    """A result's flux, trace, per-step losses and epochs."""
    trace = result.trace_loss
    return {
        "flux": result.flux_upsampled_total,
        "trace": {name: np.asarray(trace[name]) for name in trace.colnames
                  if name != "filename"} if len(trace) else {},
        "loss": result.loss_per_step,
        "n_epochs": result.n_epochs,
    }


def loss_and_gradient(loss, flux):
    """A (sharded) stacked loss's every per-observation value and the
    flux gradient of its sum, both summed over the ranks."""
    f = torch.as_tensor(flux)[None, None].requires_grad_(True)
    losses = loss.evaluate((f,))
    losses.sum().backward()
    grad = f.grad
    if dist.is_initialized():
        dist.all_reduce(grad)
    return loss.gather(losses.detach()).numpy(), grad[0, 0].numpy()


def stacked(datasets, conv_mode="fft", **kwargs):
    from jolideco_torch import FluxComponents, SpatialFluxComponent
    from jolideco_torch.parallel import StackedPoissonLoss

    shape = next(iter(datasets.values()))["counts"].shape
    components = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
        np.ones(shape, np.float32))})
    return StackedPoissonLoss.from_datasets(
        datasets, components, conv_mode=conv_mode, device="cpu", **kwargs)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def capture_warnings():
    handler = _Records()
    logging.getLogger("jolideco_torch").addHandler(handler)
    return handler


# ----------------------------------------------------------------------
# tests/test_torch_mesh.py


def obs_mesh_worker(rank, world, folder):
    """The obs mesh of every rank: sharded stacked losses (fft, pfft with
    an even and an odd count per rank), joint runs, the probe, early
    stopping, checkpoints, the sequential strategy's warning and the
    refused fallback."""
    from jolideco_torch import MAPDeconvolverResult
    from jolideco_torch.parallel import make_obs_mesh

    mesh = make_obs_mesh(world)
    out = {"rank": rank, "topology": None}
    flux = sample_flux()
    datasets = make_datasets(8)
    out["fft"] = loss_and_gradient(stacked(datasets).shard(mesh), flux)
    for label, n_obs in (("pfft_even", 2 * world), ("pfft_odd", 3 * world)):
        loss = stacked(make_datasets(n_obs), conv_mode="pfft").shard(mesh)
        out[label] = loss_and_gradient(loss, flux) + (
            loss.pfft_pairs is not None,)

    deco, result = deconvolve(datasets, mesh=mesh, n_epochs=EPOCHS_JAX)
    out["topology"] = deco.to_dict()["mesh"]
    out["joint"] = run_summary(result)
    out["params"] = result.components["flux"].parameters()["flux"].numpy()
    _, result = deconvolve(datasets, mesh=mesh, cycle_spin=True,
                           trace_every=5, compute_error=True)
    out["spin"] = run_summary(result)
    out["spin"]["error"] = result.components["flux"].flux_upsampled_error_numpy
    _, result = deconvolve(datasets, mesh=mesh, cycle_spin=True,
                           shard_prior=False)
    out["replicated_prior"] = run_summary(result)

    _, result = deconvolve(datasets, mesh=mesh, n_epochs=30,
                           stop_early=True, stop_early_n_average=3,
                           validation=make_datasets(4, seed=5))
    out["stop_early"] = run_summary(result)

    writes = []
    write = MAPDeconvolverResult.write

    def counted(self, *args, **kwargs):
        writes.append(1)
        return write(self, *args, **kwargs)

    MAPDeconvolverResult.write = counted
    try:
        deconvolve(datasets, mesh=mesh, n_epochs=3,
                   checkpoint_path=os.path.join(folder, "checkpoints"))
    finally:
        MAPDeconvolverResult.write = write
    out["checkpoint_writes"] = len(writes)

    handler = capture_warnings()
    _, result = deconvolve(datasets, mesh=mesh, n_epochs=2,
                           update_strategy="sequential")
    out["sequential_warnings"] = handler.messages
    out["sequential"] = run_summary(result)

    # an rmf on one dataset only: the stack cannot form, and a mesh
    # refuses the per-dataset fallback
    unstackable = {name: dict(dataset) for name, dataset in datasets.items()}
    unstackable["obs-0"]["rmf"] = np.ones((1, 1), np.float32)
    try:
        deconvolve(unstackable, mesh=mesh, n_epochs=1)
        out["unstackable"] = None
    except ValueError as exc:
        out["unstackable"] = str(exc)
    return out


def mesh_refusals_worker(rank, world):
    """The mesh builders' refusals on a group of ``world`` ranks."""
    from jolideco_torch.parallel import make_obs_mesh, make_obs_row_mesh

    messages = []
    for build in (lambda: make_obs_mesh(world + 1),
                  lambda: make_obs_mesh(world - 1),
                  lambda: make_obs_row_mesh(world, 2)):
        try:
            build()
            messages.append(None)
        except ValueError as exc:
            messages.append(str(exc))
    return messages


def dying_rank_worker(rank, world):
    """Rank 1 dies while the others wait for it in a collective."""
    from jolideco_torch.parallel import make_obs_mesh

    make_obs_mesh(world)
    if rank == 1:
        os._exit(3)
    dist.all_reduce(torch.ones(1))
    return rank


def raising_rank_worker(rank, world):
    """Rank 1 raises while the others wait for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


# ----------------------------------------------------------------------
# tests/test_torch_spatial.py


def spatial_worker(rank, world, n_obs_shards, n_row_shards, conv_inputs):
    """The ``(obs, row)`` mesh: the pencil FFT and its adjoint, sharded
    stacked losses (with and without calibrations and upsampling), the
    divisibility error, joint runs and the probe."""
    from jolideco_torch import NPredCalibration, NPredCalibrations
    from jolideco_torch import FluxComponents, SpatialFluxComponent
    from jolideco_torch.ops.dist_fft import dist_convolve_fft
    from jolideco_torch.parallel import (
        StackedPoissonLoss,
        make_obs_row_mesh,
        shard_stacked_spatial,
    )
    from jolideco_torch.parallel.mesh import block

    mesh = make_obs_row_mesh(n_obs_shards, n_row_shards)
    out = {}
    obs_index = int(mesh.get_local_rank("obs"))
    row_index = int(mesh.get_local_rank("row"))

    # the pencil FFT: forward and the adjoint through autograd, this
    # rank's block of the observations and of their rows
    x, kft, g, fft_shape = conv_inputs
    obs = block(x.shape[0], n_obs_shards, obs_index)
    rows = block(x.shape[-2], n_row_shards, row_index)
    cols = block(kft.shape[-1], n_row_shards, row_index)
    x_local = torch.as_tensor(x[obs, ..., rows, :]).requires_grad_(True)
    y = dist_convolve_fft(x_local, torch.as_tensor(kft[obs, ..., cols]),
                          fft_shape, mesh)
    (y * torch.as_tensor(g[obs, ..., rows, :])).sum().backward()
    out["conv"] = (obs, rows, y.detach().numpy(), x_local.grad.numpy())

    flux = sample_flux()
    datasets = make_datasets(8)
    loss = stacked(datasets, row_shards=n_row_shards)
    out["fft_shape"] = loss.fft_shape
    out["stacked"] = loss_and_gradient(shard_stacked_spatial(loss, mesh),
                                       flux)

    # calibrations (shifts, background norms, weights) and a x2 component
    calibrations = NPredCalibrations({
        name: NPredCalibration(shift_x=0.3 - 0.1 * i, shift_y=-0.2 + 0.05 * i,
                               background_norm=1.0 + 0.05 * i,
                               weight=1.0 + 0.1 * i)
        for i, name in enumerate(datasets)})
    components = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
        np.ones((SIZE, SIZE), np.float32), upsampling_factor=2)})
    loss = StackedPoissonLoss.from_datasets(
        datasets, components, calibrations=calibrations,
        row_shards=n_row_shards, device="cpu")
    flux2 = np.repeat(np.repeat(flux, 2, 0), 2, 1) / 4
    out["calibrated"] = loss_and_gradient(shard_stacked_spatial(loss, mesh),
                                          flux2)

    try:
        shard_stacked_spatial(stacked(datasets, fft_shape=(72, 72)), mesh)
        out["indivisible"] = None
    except ValueError as exc:
        out["indivisible"] = str(exc)

    handler = capture_warnings()
    deco, result = deconvolve(datasets, mesh=mesh, trace_every=1,
                              conv_mode="pfft", n_epochs=EPOCHS_JAX)
    out["pfft_warnings"] = handler.messages
    out["topology"] = deco.to_dict()["mesh"]
    out["joint"] = run_summary(result)
    _, result = deconvolve(datasets, mesh=mesh, cycle_spin=True,
                           compute_error=True, trace_every=0)
    out["spin"] = run_summary(result)
    out["spin"]["error"] = result.components["flux"].flux_upsampled_error_numpy
    return out


# ----------------------------------------------------------------------
# tests/test_torch_prior_sharding.py


def prior_cases():
    """``name -> (priors keyed by component, flux shapes, marginalise)``:
    the fused GMM prior (MAP and marginalised, with a learnable norm), the
    jitter fallback, a GMM prior beside a uniform one, and
    ``MultiScalePrior``."""
    from jolideco_torch import (
        ASinhImageNorm,
        MultiScalePrior,
        SmoothnessPrior,
        UniformPrior,
    )

    def gmm(**kwargs):
        prior = gmm_prior(cycle_spin=True,
                          marginalize=kwargs.pop("marginalize", False))
        for key, value in kwargs.items():
            setattr(prior, key, value)
        return prior

    return {
        "fused": ({"flux": gmm()}, [(48, 48)]),
        "fused_ragged": ({"flux": gmm()}, [(56, 40)]),
        "marginalised": ({"flux": gmm(marginalize=True)}, [(48, 48)]),
        "asinh_norm": ({"flux": gmm(norm=ASinhImageNorm())}, [(48, 48)]),
        "jitter": ({"flux": gmm(jitter=True)}, [(48, 48)]),
        "mixed": ({"a": gmm(), "b": UniformPrior(),
                   "c": SmoothnessPrior()}, [(48, 48), (32, 32), (32, 32)]),
        "multiscale": ({"flux": MultiScalePrior(gmm(), n_levels=2)},
                       [(48, 48)]),
    }


def prior_fluxes(shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.uniform(0.1, 2.0, shape).astype(np.float32)
            for shape in shapes]


def prior_values(priors, fluxes, draws, sharded_fn=None):
    """The summed log-prior and its gradients (fluxes, then the priors'
    trainable leaves, keys sorted at every level as JAX flattens them),
    unsharded or through ``sharded_fn``; the gradients summed over the
    ranks."""
    from jolideco_torch import PriorLoss

    prior_loss = PriorLoss(priors)
    xs = [torch.as_tensor(f)[None, None].requires_grad_(True)
          for f in fluxes]
    params = {name: {"prior": _trainable(prior.parameters())}
              for name, prior in priors.items()}
    if sharded_fn is None:
        value = prior_loss(xs, params=params, shifts=draws)
    else:
        value = sharded_fn(prior_loss, xs, params=params, shifts=draws)
    leaves = xs + list(_leaves(params))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for g, leaf in zip(grads, leaves)]
    if sharded_fn is not None:
        for grad in grads:
            dist.all_reduce(grad)
    return float(value.detach()), [g.numpy() for g in grads]


def _trainable(tree):
    return {key: _trainable(value) if isinstance(value, dict)
            else value.detach().clone().requires_grad_(True)
            for key, value in tree.items()}


def _leaves(tree):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key])
        else:
            yield tree[key]


def prior_worker(rank, world, jax_draws):
    """``sharded_prior_fn`` on every rank against the unsharded prior,
    with the JAX package's draws where it gives them, the port's own
    generator elsewhere; the fused scorer's calls on this rank."""
    from jolideco_torch.ops import gmm_fused
    from jolideco_torch.parallel import make_obs_mesh, sharded_prior_fn

    mesh = make_obs_mesh(world)
    fn = sharded_prior_fn(mesh)
    out = {}
    for name, (priors, shapes) in prior_cases().items():
        fluxes = prior_fluxes(shapes)
        draws = jax_draws.get(name)
        if draws is None:
            generator = torch.Generator().manual_seed(7)
            draws = {key: prior.draw_shifts(generator, (1, 1) + shape)
                     for (key, prior), shape in zip(priors.items(), shapes)}
        gmm_fused.reset_counters()
        sharded = prior_values(priors, fluxes, draws, sharded_fn=fn)
        calls = gmm_fused.fused_forward_plain.calls
        out[name] = {"sharded": sharded, "forward_calls": calls,
                     "whole": prior_values(priors, fluxes, draws)}
    try:
        fn(__import__("jolideco_torch").PriorLoss({}), [])
        out["no_draws"] = None
    except ValueError as exc:
        out["no_draws"] = str(exc)
    return out
