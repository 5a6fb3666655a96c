"""MAP deconvolution driver (the JAX package's ``core.py``).

Two update strategies, as in the JAX package:

- ``"sequential"`` (the default): each epoch takes one optimiser step
  per dataset, in the datasets' order, on
  ``weight_i · NLL_i − β · log_prior / n_datasets``, all steps sharing
  one optimiser state; each dataset has its own forward model
  (``models/npred.py``, FFT convolution);
- ``"joint"``: one step per epoch on the weighted sum of every
  dataset's NLL minus ``β · log_prior``, the observations stacked
  (``parallel/stacked.py``; ``conv_mode`` ``"fft"`` or ``"pfft"``).
  Observations that cannot stack (image shapes or band counts that
  differ, an ``rmf`` on some datasets only, components without a common
  FFT shape) fall back to the per-dataset models with a warning, as in
  the JAX package; data that neither path takes
  (`parallel.DataValidationError`) and any failure under an explicit
  ``fft_shape`` raise.

Datasets may be band stacks with an energy redistribution matrix
(``rmf``, ``models/npred.py``), and components may be
`SparseSpatialFluxComponent` point-source lists beside dense ones.

A step is

    flux = exp(log_flux) -> Poisson NLL (FFT convolution)
         -> minus beta times the log-prior (GMM patch prior)
         -> backward -> one optimiser step,

run eagerly, one Python iteration per step (no CUDA graph yet). The
optimisers are ``torch.optim.Adam`` and ``torch.optim.SGD``, which make
the same updates as the JAX package's ``optax.adam`` and ``optax.sgd``
(bias-corrected moments, ``eps`` outside the square root).

After an epoch's steps, a trace row is computed at the epoch's end
parameters (``trace_every=1``: every epoch; ``k > 1``: epochs with
``epoch % k == 0``; ``0``: none): the total loss, the summed data and
prior terms, each prior and each dataset's raw NLL, and, with
validation data, their summed NLL. Rows stay on the device and are
fetched once, at the end of the run, into ``result.trace_loss``. With
``stop_early`` a row is computed every epoch and its validation total
fetched (one synchronisation an epoch): training stops after the first
epoch, past the first ``stop_early_n_average``, whose validation total
exceeds the mean of the last ``stop_early_n_average`` (itself included).

Randomness (the priors' cycle spins, subpixel offsets, jitters and
patch subsets) comes from one CPU ``torch.Generator`` seeded with
``seed``. Each epoch draws every prior's draws of its steps in order
(``PriorLoss.draw_shifts``, the priors in the components' order), then
those of its trace row whenever the run traces at all (``trace_every >
0`` or ``stop_early``), whether or not that epoch's row is computed, so
that ``trace_every`` changes no training result. The priors' trainable
parameters (image norms, ``MultiScalePrior``'s level weights) train with
the fluxes and are written back into the priors at the end. The
generator draws other numbers than JAX's keys from the same seed. A run
resumes (``run(resume_from=)``) from a result or from a
directory written by ``MAPDeconvolverResult.save_state`` with the
optimiser's moments and the generator's state, so ``n`` epochs and then
``m`` more give the bits of ``n + m`` epochs in one run.

With ``checkpoint_path`` every epoch ends with a result file,
``checkpoint-epoch-{epoch}.asdf`` in that directory, written after the
epoch's steps and before its trace row, whose ``filename`` names it: the
configuration, the trace so far and the components and calibrations at the
epoch's parameters, as the JAX package writes them. The write copies the
parameters to the host (one synchronisation an epoch) and changes nothing
the run goes on from. ``MAPDeconvolverResult.write`` and ``read`` keep a
result in FITS or ASDF, in the JAX package's layout.

With ``compute_error=True`` the run ends with one Hessian probe at the
trained fluxes (``TotalLoss.fluxes_error``): flux errors
``sqrt(1 / (H · 1))`` per component, on the patch-level GMM scorer's
kernels, after either strategy, the calibrations held at their trained
values.

``run(calibrations=)`` takes an `NPredCalibrations` keyed like the
datasets: their trainable shifts and log background norms join the flux
in the one optimiser, with the same learning rate, and are written back
into them at the end (``result.calibrations``; ``calibrations_init``
keeps the values the run received). The optimiser's leaves are those
of the JAX package's params pytree ``{"components": ..., "calibrations":
...}``, in its order (keys sorted at every level).

On several devices (``mesh=``, ``parallel.mesh``) every rank of the
process group runs the same program on the same datasets. The joint
strategy's stacked losses are sharded: a rank keeps its block of the
observations (``"obs"``) and, on a 2-D mesh, its block of their image
rows (``"row"``, through the pencil FFT of ``ops.dist_fft``). The
parameters are replicated, broadcast from rank 0 when the run starts;
each step a rank differentiates its part of the loss, and one
``all_reduce`` sums the gradients and the data terms, so that every rank
takes the same optimiser step. With ``shard_prior`` (the default) the
prior's patches are split over the ranks as well (``parallel.prior``).
The trace rows, the validation totals early stopping reads and the
probe's Hessian diagonals are summed over the ranks, so that every rank
decides alike; only rank 0 writes checkpoints. The result equals the
unsharded run's up to float32 summation order. The sequential strategy
runs unsharded on every rank, as in the JAX package.

Not ported, raising ``NotImplementedError``: ``conv_mode`` values other
than ``"auto"``, ``"fft"`` and ``"pfft"``. Every keyword of the JAX
package's signatures is accepted, so that a call written for it fails
only on what is not ported.
"""

import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .config import resolve_device
from .loss import PriorLoss, TotalLoss
from .models import (
    FluxComponents,
    NPredCalibrations,
    SparseSpatialFluxComponent,
    SpatialFluxComponent,
)
from .parallel.mesh import (
    all_reduce_sum,
    broadcast_tensors,
    mesh_size,
    mesh_topology,
)
from .parallel.prior import sharded_prior_fn
from .parallel.spatial import shard_stacked_spatial
from .parallel.stacked import DataValidationError, StackedPoissonLoss
from .utils.checkpoint import (
    restore_calibration_params,
    restore_train_state,
    save_train_state,
)
from .utils.misc import format_class_str
from .utils.table import Table

log = logging.getLogger(__name__)

__all__ = ["MAPDeconvolver", "MAPDeconvolverResult"]


def _build_adam(params, learning_rate, betas=(0.9, 0.999), eps=1e-8):
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                            eps=eps)


def _build_sgd(params, learning_rate, momentum=0.0, nesterov=False):
    return torch.optim.SGD(params, lr=learning_rate,
                           momentum=momentum or 0.0, nesterov=nesterov)


OPTIMIZER = {"adam": _build_adam, "sgd": _build_sgd}


def _leaves(params):
    """Tensors of a nested params dict, keys sorted at every level (the
    order in which JAX flattens a dict pytree)."""
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def optimizer_leaves(params, calibration_params=None):
    """The optimiser's tensors: the leaves of the JAX package's params
    pytree ``{"components": params, "calibrations":
    calibration_params}`` (the latter only when it has leaves), in its
    order."""
    tree = {"components": params}
    if calibration_params:
        tree["calibrations"] = calibration_params
    return list(_leaves(tree))


def _trainable(params, device):
    """Copy of a nested params dict with leaves that require grad."""
    return {
        name: (
            _trainable(value, device) if isinstance(value, dict)
            else value.detach().to(device).clone().requires_grad_(True)
        )
        for name, value in params.items()
    }


def _load_params(params, values):
    """Copy the nested numpy ``values`` into the nested tensors ``params``."""
    with torch.no_grad():
        for name, leaf in params.items():
            if isinstance(leaf, dict):
                _load_params(leaf, values[name])
            else:
                leaf.copy_(torch.as_tensor(np.asarray(values[name])))


def _load_opt_state(optimizer, opt_state):
    """Load the moments and step counts of ``opt_state`` (a state dict),
    cloned, keeping the optimiser's own hyper-parameters."""
    current = optimizer.state_dict()
    current["state"] = {
        index: {k: v.clone() if torch.is_tensor(v) else v
                for k, v in entry.items()}
        for index, entry in opt_state["state"].items()
    }
    optimizer.load_state_dict(current)


def _validate_component_shapes(datasets, components):
    """Fail the build with a clear message on a flux/data shape mismatch
    (a sparse component's grid included, at factor 1, as the JAX
    package's check reads its splat)."""
    for ds_name, dataset in datasets.items():
        data_shape = tuple(np.asarray(dataset["counts"]).shape[-2:])
        for name, component in components.items():
            factor = component.upsampling_factor or 1
            expected = (data_shape[0] * factor, data_shape[1] * factor)
            got = tuple(component.shape[-2:])
            if got != expected:
                raise ValueError(
                    f"Flux component {name!r} has shape {got} but dataset "
                    f"{ds_name!r} counts are {data_shape} with upsampling "
                    f"factor {factor} (expected flux shape {expected}). "
                    "Note SpatialFluxComponent.from_numpy takes the flux "
                    "at data resolution and upsamples it by "
                    "upsampling_factor itself."
                )


class Trainer:
    """The optimisation state of one run and its epoch.

    Built by :meth:`MAPDeconvolver.make_trainer`. ``epoch(index)`` runs
    one epoch in place and returns ``(losses, row)``: the device scalar
    losses of its steps (each at the parameters its step started from)
    and its trace row (a dict of device scalars), ``None`` on an epoch
    that computes none. With a sharded stacked loss (its ``mesh``) the
    joint step is the mesh's (:meth:`_step_mesh`), ``prior_fn`` the
    prior split over the ranks (``parallel.prior``) or ``None``.
    """

    def __init__(self, deconvolver, components, total_loss, params,
                 optimizer, generator, calibration_params=None,
                 prior_fn=None):
        self.components = components
        self.total_loss = total_loss
        self.params = params
        # the calibrations' trainable leaves keyed by dataset name (None
        # without calibrations or with every leaf frozen)
        self.calibration_params = calibration_params or None
        self.optimizer = optimizer
        self.generator = generator
        self.beta = deconvolver.beta
        self.sequential = deconvolver.update_strategy == "sequential"
        self.trace_every = deconvolver.trace_every
        self.stop_early = deconvolver.stop_early
        # early stopping reads the validation total off a row every epoch
        self.traced = self.trace_every != 0 or self.stop_early
        self.n_datasets = total_loss.poisson_loss.n_datasets
        self.weights = total_loss.poisson_loss.weights
        # the fluxes' shapes, at which the priors draw (jitter, subsets)
        self.shapes = tuple(c.shape for c in components.values())
        self.mesh = getattr(total_loss.poisson_loss, "mesh", None)
        self.prior_fn = prior_fn
        if self.mesh is not None:
            # every rank starts from rank 0's parameters
            broadcast_tensors(self.optimizer.param_groups[0]["params"])

    def _step(self, loss_fn):
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        # a leaf this loss does not reach (another dataset's calibration
        # in a sequential step) takes a zero gradient, as in optax: its
        # moments decay and it moves, where torch would skip it
        for leaf in self.optimizer.param_groups[0]["params"]:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        self.optimizer.step()
        return loss.detach()

    def _step_mesh(self, shifts):
        """One joint step on a rank of the mesh: the rank's part of the
        loss, its gradient, then one ``all_reduce`` of the gradients and
        the data term together. Returns the total loss, the same on every
        rank."""
        self.optimizer.zero_grad(set_to_none=True)
        fluxes = self.components.fluxes_from(self.params)
        poisson = self.total_loss.poisson_loss
        data = torch.sum(poisson.evaluate(fluxes, self.calibration_params)
                         * poisson.weights)
        prior_loss = self.total_loss.prior_loss
        if self.prior_fn is not None:
            # the whole log-prior; each rank's gradient is its part's
            prior = self.prior_fn(prior_loss, fluxes, params=self.params,
                                  shifts=shifts)
            objective = data - self.beta * prior
        else:
            # every rank computes the whole prior: each takes 1/n of it
            prior = prior_loss(fluxes, params=self.params, shifts=shifts)
            objective = data - self.beta * prior / dist.get_world_size()
        objective.backward()
        # a leaf this rank does not reach (another rank's calibration)
        # takes a zero gradient, so that every rank reduces every leaf
        leaves = self.optimizer.param_groups[0]["params"]
        flat = torch.cat(
            [(leaf.grad if leaf.grad is not None
              else torch.zeros_like(leaf)).reshape(-1) for leaf in leaves]
            + [data.detach().reshape(1)])
        all_reduce_sum(flat)
        offset = 0
        for leaf in leaves:
            leaf.grad = flat[offset:offset + leaf.numel()].view_as(leaf)
            offset += leaf.numel()
        self.optimizer.step()
        return flat[-1] - self.beta * prior.detach()

    def _loss_for_dataset(self, idx, shifts):
        fluxes = self.components.fluxes_from(self.params)
        loss = self.total_loss.poisson_loss.evaluate_dataset(
            idx, fluxes, self.calibration_params)
        prior = self.total_loss.prior_loss(fluxes, params=self.params,
                                           shifts=shifts)
        return self.weights[idx] * loss - self.beta * prior / self.n_datasets

    def _loss_joint(self, shifts):
        return self.total_loss(self.components.fluxes_from(self.params),
                               params=self.params, shifts=shifts,
                               calibration_params=self.calibration_params)

    def computes_row(self, epoch):
        """Whether ``epoch`` computes a trace row."""
        if self.trace_every == 1 or self.stop_early:
            return True
        return self.trace_every > 0 and epoch % self.trace_every == 0

    def records_row(self, epoch):
        """Whether ``epoch``'s row goes into the trace table."""
        return self.trace_every > 0 and epoch % self.trace_every == 0

    def _draw(self):
        """The priors' draws of one evaluation, from the run's generator."""
        return self.total_loss.prior_loss.draw_shifts(self.generator,
                                                      self.shapes)

    def epoch(self, epoch):
        if self.sequential:
            losses = []
            for idx in range(self.n_datasets):
                shifts = self._draw()
                losses.append(self._step(
                    lambda: self._loss_for_dataset(idx, shifts)))
        elif self.mesh is not None:
            losses = [self._step_mesh(self._draw())]
        else:
            shifts = self._draw()
            losses = [self._step(lambda: self._loss_joint(shifts))]
        row = None
        if self.traced:
            shifts = self._draw()
            if self.computes_row(epoch):
                with torch.no_grad():
                    row = self.total_loss.trace_row_values(
                        self.components.fluxes_from(self.params),
                        params=self.params, shifts=shifts,
                        calibration_params=self.calibration_params,
                    )
        return losses, row


class MAPDeconvolver:
    """Maximum a-posteriori deconvolver.

    Parameters
    ----------
    n_epochs : int
        Number of training epochs.
    beta : float
        Prior scale factor.
    learning_rate : float
    compute_error : bool
        Compute flux errors from the loss Hessian after training.
    stop_early : bool
        Stop when the validation loss stops improving (needs
        ``datasets_validation``).
    stop_early_n_average : int
        Moving-average window of early stopping.
    display_progress : bool
        Log the run's epochs, steps, time and first and last loss at INFO
        level when training ends (the JAX package shows a progress bar).
    optimizer_type : {"adam", "sgd"}
    optimizer_kwargs : dict, optional
        Torch-style keys: ``lr``, ``betas``, ``eps``, ``momentum``,
        ``nesterov``.
    checkpoint_path : str or Path, optional
        Directory (made if missing) for a result file each epoch,
        ``checkpoint-epoch-{epoch}.asdf`` (needs pyyaml).
    update_strategy : {"sequential", "joint"}
        ``"sequential"``: one optimiser step per dataset per epoch;
        ``"joint"``: one step per epoch on the summed loss.
    scan_epochs, scan_chunk :
        How the JAX package compiles its loop; accepted and stored. The
        port runs one eager step at a time whatever they say, with the
        same results.
    trace_every : int
        Record the loss trace every N epochs (0: no trace).
    seed : int
        Seed of the generator that draws the prior's cycle spins.
    device : str or torch.device, optional
        Where the run happens; default the first CUDA card (and an error
        without one). ``"cpu"`` runs the plain versions of the kernels.
    mesh : DeviceMesh, optional
        ``parallel.make_obs_mesh()`` (observations split over the ranks)
        or ``parallel.make_obs_row_mesh(n_obs, n_row)`` (observations and
        image rows) over every rank of the initialised process group,
        which all run this program on the same data: the joint strategy
        then runs sharded (see the module's docstring). A mesh pins the
        stacked path (data that cannot stack raises), and
        ``conv_mode="pfft"`` on a mesh with a ``"row"`` dimension falls
        back to ``"fft"`` with a warning.
    conv_mode : {"auto", "fft", "pfft"}
        PSF convolution backend of the joint strategy: ``"fft"`` a
        batched ``rfft2`` (cuFFT on the card), ``"pfft"`` the pair-packed
        matrix DFT (``ops/pallas_fft.py``). ``"auto"`` takes the one that
        was faster on the card at the main path's shape (see
        ``build_loss``). The sequential strategy's per-dataset models
        always use the FFT.
    fft_shape : tuple of int, optional
        Padded FFT shape (at least image + kernel - 1 per axis).
    shard_prior : bool
        On a mesh with the joint strategy, split the prior's patches over
        every rank (``parallel.prior``) instead of scoring all of them on
        each; no effect without a mesh.
    """

    _default_flux_component = "flux"
    _default_checkpoint_filename = "checkpoint-epoch-{epoch}.asdf"

    def __init__(self, n_epochs=1_000, beta=1, learning_rate=0.1,
                 compute_error=False, stop_early=False,
                 stop_early_n_average=10, display_progress=True,
                 optimizer_type="adam", optimizer_kwargs=None,
                 checkpoint_path=None, update_strategy="sequential",
                 scan_epochs=None, scan_chunk=None, trace_every=1, seed=0,
                 device=None, mesh=None, conv_mode="auto", fft_shape=None,
                 shard_prior=True):
        if conv_mode not in ("auto", "fft", "pfft"):
            raise NotImplementedError(
                f"MAPDeconvolver(conv_mode={conv_mode!r}) is not ported yet"
            )
        if optimizer_type not in OPTIMIZER:
            raise ValueError(
                f"Unknown optimizer: {optimizer_type}, must be one of "
                f"{list(OPTIMIZER)}"
            )
        if update_strategy not in ("sequential", "joint"):
            raise ValueError(
                f"Unknown update strategy {update_strategy!r}, choose from "
                "'sequential' or 'joint'"
            )
        self.n_epochs = int(n_epochs)
        self.beta = float(beta)
        self.learning_rate = float(learning_rate)
        self.compute_error = bool(compute_error)
        self.stop_early = bool(stop_early)
        self.stop_early_n_average = int(stop_early_n_average)
        self.display_progress = bool(display_progress)
        self.scan_epochs = scan_epochs
        self.scan_chunk = None if scan_chunk is None else int(scan_chunk)
        self.mesh = mesh
        if mesh is not None and update_strategy != "joint":
            log.warning(
                "mesh is only used by the joint update strategy; the "
                "sequential per-dataset loop runs unsharded. Pass "
                "update_strategy='joint' to shard over the mesh."
            )
        if checkpoint_path is not None:
            checkpoint_path = Path(checkpoint_path)
            checkpoint_path.mkdir(exist_ok=True, parents=True)
        self.checkpoint_path = checkpoint_path
        self.shard_prior = bool(shard_prior)
        self.optimizer_type = optimizer_type
        optimizer_kwargs = dict(optimizer_kwargs or {})
        if "lr" in optimizer_kwargs:
            self.learning_rate = float(optimizer_kwargs.pop("lr"))
        optimizer_kwargs.setdefault("learning_rate", self.learning_rate)
        self.optimizer_kwargs = optimizer_kwargs
        self.update_strategy = update_strategy
        self.trace_every = int(trace_every)
        self.seed = int(seed)
        self.device = device
        self.conv_mode = str(conv_mode)
        self.fft_shape = None if fft_shape is None else tuple(
            int(s) for s in fft_shape
        )

    def to_dict(self):
        """Configuration with simple data types."""
        return {
            "n_epochs": self.n_epochs,
            "beta": self.beta,
            "learning_rate": self.learning_rate,
            "compute_error": self.compute_error,
            "stop_early": self.stop_early,
            "stop_early_n_average": self.stop_early_n_average,
            "display_progress": self.display_progress,
            "optimizer_type": self.optimizer_type,
            "optimizer_kwargs": {
                k: v for k, v in self.optimizer_kwargs.items()
                if k != "learning_rate"
            },
            "update_strategy": self.update_strategy,
            "scan_epochs": self.scan_epochs,
            "scan_chunk": self.scan_chunk,
            "trace_every": self.trace_every,
            "seed": self.seed,
            "device": None if self.device is None else str(self.device),
            "conv_mode": self.conv_mode,
            "fft_shape": None if self.fft_shape is None
            else list(self.fft_shape),
            "mesh": None if self.mesh is None else mesh_topology(self.mesh),
            "shard_prior": self.shard_prior,
            "checkpoint_path": None if self.checkpoint_path is None
            else str(self.checkpoint_path),
        }

    def __str__(self):
        return format_class_str(instance=self)

    def _flux_components(self, components):
        if isinstance(components, (SpatialFluxComponent,
                                   SparseSpatialFluxComponent)):
            components = {self._default_flux_component: components}
        return FluxComponents(components)

    def build_loss(self, datasets, datasets_validation=None, components=None,
                   calibrations=None, device=None):
        """Build the total loss once, for reuse across ``run`` calls
        (``run(total_loss=...)``): stacked observations for ``"joint"``,
        per-dataset forward models for ``"sequential"``, and with
        ``datasets_validation`` a validation loss of the same kind.

        ``device`` defaults to the deconvolver's (the first CUDA card
        unless it says otherwise). ``calibrations`` (`NPredCalibrations`,
        keyed like ``datasets``) shift, scale and weight the datasets;
        the loss keeps their static values (``psf_scale``, ``weight``
        and the leaves they do not train), the trained ones come from
        ``run``.
        """
        components = self._flux_components(components)
        device = resolve_device(self.device if device is None else device)
        _validate_component_shapes(datasets, components)
        if datasets_validation:
            _validate_component_shapes(datasets_validation, components)

        if self.update_strategy == "joint":
            poisson = self._stacked_losses(
                datasets, datasets_validation, components, calibrations,
                device)
            if poisson is not None:
                return TotalLoss(
                    poisson_loss=poisson[0],
                    prior_loss=PriorLoss(components.priors),
                    poisson_loss_validation=poisson[1],
                    beta=self.beta,
                )

        if self.conv_mode not in ("fft", "auto"):
            log.warning(
                f"conv_mode={self.conv_mode!r} only applies to the "
                "stacked joint path; the per-dataset forward models "
                "always convolve via FFT"
            )
        return TotalLoss.from_datasets_and_components(
            datasets=datasets, datasets_validation=datasets_validation,
            components=components, beta=self.beta,
            calibrations=calibrations, fft_shape=self.fft_shape,
            device=device,
        )

    def _stacked_losses(self, datasets, datasets_validation, components,
                        calibrations, device):
        """The joint strategy's stacked losses ``(training, validation)``,
        or None when the observations cannot stack (a plain
        ``ValueError`` from the build, as for image shapes or band counts
        that differ, an ``rmf`` on some datasets only, or components
        without a common FFT shape): the JAX package's fallback to
        per-dataset models, decided from the data before anything runs.
        A `DataValidationError` (data neither path takes) and any error
        under an explicit ``fft_shape`` or a mesh propagate. On a mesh the
        losses are this rank's shards."""
        # "auto" is the rfft2 (cuFFT): at the main path's 5 pairs of
        # 1024^2 (n = 1152) the matrix DFT took 1.94 ms per direction
        # under the default dial ("split": passes 2 and 3 on the tensor
        # cores) and 3.94 ms under "highest" (float32), cuFFT's packed
        # pair 0.58 ms and the batched rfft2 of the same 10 images 0.45 ms
        # (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W limit)
        conv_mode = "fft" if self.conv_mode == "auto" else self.conv_mode
        mesh = self.mesh
        row_shards = (mesh_size(mesh, "row") if mesh is not None
                      and "row" in mesh.mesh_dim_names else None)
        if conv_mode == "pfft" and row_shards:
            log.warning(
                "conv_mode='pfft' does not partition over a row (spatial) "
                "mesh; using conv_mode='fft' for this sharded run"
            )
            conv_mode = "fft"

        def stacked(data):
            return StackedPoissonLoss.from_datasets(
                datasets=data, components=components,
                calibrations=calibrations, fft_shape=self.fft_shape,
                conv_mode=conv_mode, row_shards=row_shards, device=device,
            )

        try:
            losses = (stacked(datasets), stacked(datasets_validation)
                      if datasets_validation else None)
        except DataValidationError:
            raise
        except ValueError as exc:
            # an explicit fft_shape or a mesh pins the stacked path
            if self.fft_shape is not None or mesh is not None:
                raise
            log.warning(f"Cannot stack observations ({exc}); falling back "
                        "to per-dataset forward models")
            return None
        if mesh is None:
            return losses
        shard = (shard_stacked_spatial if row_shards
                 else StackedPoissonLoss.shard)
        return tuple(None if loss is None else shard(loss, mesh)
                     for loss in losses)

    def _write_checkpoint(self, trainer, calibrations, filename):
        """Write the epoch's result file: the components and calibrations
        at the trainer's parameters (copies: the optimiser's tensors stay
        as they are), the trace so far and the configuration. On a mesh,
        rank 0 writes it."""
        if self.mesh is not None and dist.get_rank() != 0:
            return
        trainer.components.set_parameters(trainer.params)
        if calibrations and trainer.calibration_params:
            calibrations.set_parameters(trainer.calibration_params)
        checkpoint = MAPDeconvolverResult(
            config=self.to_dict(),
            trace_loss=trainer.total_loss.trace,
            components=trainer.components,
            calibrations=calibrations,
        )
        path = self.checkpoint_path / filename
        log.info(f"Writing checkpoint to {path}")
        checkpoint.write(filename=path)

    def make_trainer(self, datasets, components, datasets_validation=None,
                     total_loss=None, resume_from=None, calibrations=None):
        """Build (or take) the loss, the parameters, the optimiser and the
        generator of a run, and return its `Trainer`.

        ``components`` (and ``calibrations``) are moved to the run's
        device; the trainer's ``params`` is the nested dict of trainable
        flux tensors its epochs update in place, ``calibration_params``
        the calibrations' (keyed by dataset name). ``resume_from`` as in
        :meth:`run`.
        """
        device = resolve_device(self.device)
        components = self._flux_components(components)
        for component in components.values():
            component.to(device)
        if calibrations:
            calibrations.to(device)
        if total_loss is None:
            total_loss = self.build_loss(
                datasets, datasets_validation=datasets_validation,
                components=components, calibrations=calibrations,
                device=device,
            )
        else:
            total_loss.reset_trace()
            if (datasets_validation is not None
                    and total_loss.poisson_loss_validation is None):
                log.warning(
                    "datasets_validation is ignored when a prebuilt "
                    "total_loss is supplied; pass it to build_loss() "
                    "instead"
                )
        if self.stop_early and total_loss.poisson_loss_validation is None:
            raise ValueError(
                "Early stopping requires a loss with validation datasets; "
                "the supplied total_loss was built without them"
            )

        params = _trainable(components.parameters(), device)
        calibration_params = _trainable(
            calibrations.parameters() if calibrations else {}, device)
        generator = torch.Generator().manual_seed(self.seed)
        opt_state = None
        if isinstance(resume_from, MAPDeconvolverResult):
            opt_state = resume_from.opt_state
            if resume_from.generator_state is not None:
                generator.set_state(resume_from.generator_state)
        elif resume_from is not None:
            values, opt_state, generator_state, _ = restore_train_state(
                resume_from
            )
            _load_params(params, values)
            _load_params(calibration_params,
                         restore_calibration_params(resume_from))
            if generator_state is not None:
                generator.set_state(generator_state)
        optimizer = OPTIMIZER[self.optimizer_type](
            optimizer_leaves(params, calibration_params),
            **self.optimizer_kwargs
        )
        if opt_state is not None:
            _load_opt_state(optimizer, opt_state)
        prior_fn = None
        if (self.mesh is not None and self.shard_prior
                and self.update_strategy == "joint"):
            prior_fn = sharded_prior_fn(self.mesh)
        return Trainer(self, components, total_loss, params, optimizer,
                       generator, calibration_params, prior_fn=prior_fn)

    def run(self, datasets, datasets_validation=None, components=None,
            calibrations=None, resume_from=None, total_loss=None):
        """Run the MAP deconvolution.

        Parameters
        ----------
        datasets : dict of [str, dict]
            Per-dataset dicts with ``counts``, ``psf``, ``exposure`` and
            ``background`` numpy arrays, 2-D images or 3-D band stacks,
            and optionally an ``rmf`` ``(C, K)`` (``psf`` and ``rmf`` may
            be dicts keyed by component).
        datasets_validation : dict of [str, dict], optional
            Validation data: traced as ``datasets-validation-total`` and
            read by early stopping.
        components : `FluxComponents`, dict or a component
            A `SpatialFluxComponent` or `SparseSpatialFluxComponent`
            alone is named ``"flux"``. Required (the JAX package's
            default, ``None``, fails there too).
        calibrations : `NPredCalibrations`, optional
            Per-dataset calibrations, keyed like ``datasets``; their
            trainable values are trained with the fluxes and written back
            into them.
        resume_from : `MAPDeconvolverResult`, str or Path, optional
            Continue a run: a result (pass its ``components`` too, to go
            on from its parameters, and its ``calibrations``; its
            optimiser state and generator state are restored) or a
            directory written by
            :meth:`MAPDeconvolverResult.save_state` (parameters,
            optimiser state and generator state all restored from it,
            the calibrations' values too).
        total_loss : `TotalLoss`, optional
            Prebuilt by :meth:`build_loss`; each run gets a fresh trace.

        Returns
        -------
        result : `MAPDeconvolverResult`
        """
        if self.stop_early and datasets_validation is None:
            raise ValueError("Early stopping requires providing test datasets")
        if components is None:
            raise ValueError("MAPDeconvolver.run needs components")
        components = self._flux_components(components)
        if calibrations is not None and not isinstance(calibrations,
                                                       NPredCalibrations):
            calibrations = NPredCalibrations(calibrations)
        components_init = components.copy()
        calibrations_init = (calibrations.copy() if calibrations
                             else calibrations)
        trainer = self.make_trainer(
            datasets, components, datasets_validation=datasets_validation,
            total_loss=total_loss, resume_from=resume_from,
            calibrations=calibrations,
        )
        total_loss, params = trainer.total_loss, trainer.params

        t0 = time.perf_counter()
        losses, rows, val_hist = [], [], []
        n_average = self.stop_early_n_average
        n_epochs = 0
        for epoch in range(self.n_epochs):
            step_losses, row = trainer.epoch(epoch)
            losses += step_losses
            n_epochs += 1
            recorded = row is not None and trainer.records_row(epoch)
            if self.checkpoint_path is not None:
                filename = self._default_checkpoint_filename.format(
                    epoch=epoch)
                self._write_checkpoint(trainer, calibrations, filename)
                # the checkpoint holds the rows before this epoch's, so
                # the rows go to the host as they come
                if recorded:
                    total_loss.append_trace_device_row(row,
                                                       filename=filename)
            elif recorded:
                rows.append(torch.stack(list(row.values())))
            if self.stop_early:
                val_hist.append(float(row["datasets-validation-total"]))
                if (len(val_hist) > n_average
                        and val_hist[-1] > np.mean(val_hist[-n_average:])):
                    break
        # one host fetch of the losses and one of the trace: no
        # per-step synchronisation (but stop_early's, one an epoch)
        loss_per_step = (torch.stack(losses).cpu().numpy() if losses
                         else np.zeros(0, np.float32))
        trace = torch.stack(rows).cpu().numpy() if rows else []
        train_seconds = time.perf_counter() - t0

        names = [name for name in total_loss.trace.colnames
                 if name != "filename"]
        for values in trace:
            total_loss.append_trace_device_row(dict(zip(names, values)))
        if self.display_progress and len(loss_per_step):
            log.info(f"MAPDeconvolver: {n_epochs} epochs, "
                     f"{len(loss_per_step)} steps in {train_seconds:.3f} s, "
                     f"loss {loss_per_step[0]:.6g} -> "
                     f"{loss_per_step[-1]:.6g}")

        components.set_parameters(params)
        if calibrations and trainer.calibration_params:
            calibrations.set_parameters(trainer.calibration_params)
        if not all(bool(torch.isfinite(p).all())
                   for p in trainer.optimizer.param_groups[0]["params"]):
            log.warning(
                "Training produced non-finite parameters. Check the flux "
                "initialisation (strictly positive for log-flux "
                "components), the learning rate, and the data."
            )

        error_seconds = 0.0
        if self.compute_error:
            t1 = time.perf_counter()
            fluxes = components.fluxes_from(params)
            components.set_flux_errors(total_loss.fluxes_error(
                fluxes, calibration_params=trainer.calibration_params))
            if fluxes and fluxes[0].is_cuda:
                torch.cuda.synchronize(fluxes[0].device)
            error_seconds = time.perf_counter() - t1

        return MAPDeconvolverResult(
            config=self.to_dict(),
            components=components,
            trace_loss=total_loss.trace,
            components_init=components_init,
            calibrations=calibrations,
            calibrations_init=calibrations_init,
            opt_state=trainer.optimizer.state_dict(),
            generator_state=trainer.generator.get_state(),
            n_epochs=n_epochs,
            loss_per_step=loss_per_step,
            train_seconds=train_seconds,
            error_seconds=error_seconds,
        )


class MAPDeconvolverResult:
    """MAP deconvolver result.

    Parameters
    ----------
    config : dict
    components : `FluxComponents`
    trace_loss : `Table` or dict, optional
        The loss trace, one row per recorded epoch (a dict of columns, as
        a file holds it, becomes a `Table`).
    components_init : `FluxComponents`, optional
        The components as the run received them.
    calibrations, calibrations_init : `NPredCalibrations`, optional
        The trained calibrations, and copies of them as the run
        received them.
    opt_state : dict, optional
        The optimiser's ``state_dict()`` at the end (for resuming).
    generator_state : tensor, optional
        The cycle spins' generator state at the end (for resuming; the
        JAX package keeps a PRNG key, ``final_key``).
    n_epochs : int
        Epochs the run took (fewer than asked after an early stop).
    loss_per_step : numpy array ``(n_steps,)``
        Total loss at the parameters each optimiser step started from
        (``n_datasets`` steps an epoch under ``"sequential"``; their
        objective carries ``1 / n_datasets`` of the prior).
    train_seconds : float
        Host wall time of the optimisation loop, ending with the fetch
        of the losses and the trace (so it includes the device's work).
    error_seconds : float
        Host wall time of the flux-error probe, ending with a device
        synchronisation (0 without ``compute_error``).

    A result read from a file (:meth:`read`) holds what the file holds:
    the configuration, the trace, the components and calibrations, not
    the optimiser's or the generator's state.
    """

    def __init__(self, config, components, trace_loss=None,
                 components_init=None, opt_state=None, generator_state=None,
                 n_epochs=0, loss_per_step=(), train_seconds=0.0,
                 error_seconds=0.0, calibrations=None,
                 calibrations_init=None):
        self.config = config
        self.components = components
        if isinstance(trace_loss, dict):
            trace_loss = Table.from_dict(trace_loss)
        self.trace_loss = trace_loss if trace_loss is not None else Table()
        self.components_init = components_init
        self.calibrations = calibrations
        self.calibrations_init = calibrations_init
        self.opt_state = opt_state
        self.generator_state = generator_state
        self.n_epochs = int(n_epochs)
        self.loss_per_step = np.asarray(loss_per_step, np.float32)
        self.train_seconds = float(train_seconds)
        self.error_seconds = float(error_seconds)

    def save_state(self, path):
        """Save the train state (parameters, the calibrations' too,
        optimiser state, generator state, epochs) into the directory
        ``path``, for ``MAPDeconvolver.run(resume_from=path)``
        (``utils/checkpoint.py``: host tensors, so a state saved on the
        card resumes on the CPU)."""
        save_train_state(
            path, params=self.components.parameters(),
            opt_state=self.opt_state, generator_state=self.generator_state,
            epoch=self.n_epochs,
            calibration_params=(self.calibrations.parameters()
                                if self.calibrations else None))

    @property
    def flux_upsampled_total(self):
        """Summed upsampled flux as a 2-D numpy array."""
        return self.components.flux_upsampled_total_numpy

    @property
    def flux_total(self):
        """Summed flux at data resolution as a 2-D numpy array."""
        return self.components.flux_total_numpy

    @property
    def wcs(self):
        """World-coordinate object of the reconstruction (the
        components')."""
        return self.components.wcs

    @property
    def checkpoint_path(self):
        """The run's checkpoint directory (``None`` for a run without)."""
        path = self.config.get("checkpoint_path", None)
        if path is None or path == "None":
            return None
        return Path(path)

    def read_checkpoint(self, epoch, device=None):
        """Read the checkpoint written at ``epoch`` onto ``device`` (its
        file name made from the epoch number: every epoch writes one,
        whatever ``trace_every`` records)."""
        if self.checkpoint_path is None:
            raise ValueError(
                "This run was configured without checkpoint_path; there "
                "are no per-epoch checkpoints to read."
            )
        filename = self.checkpoint_path / (
            MAPDeconvolver._default_checkpoint_filename.format(epoch=epoch)
        )
        if not filename.exists():
            raise FileNotFoundError(
                f"No checkpoint for epoch {epoch}: {filename}"
            )
        return self.__class__.read(filename=filename, device=device)

    @property
    def config_table(self):
        """The configuration as a one-row `Table` of strings."""
        config = Table(names=list(self.config),
                       dtype=[str] * len(self.config))
        config.add_row({k: str(v) for k, v in self.config.items()})
        return config

    def plot_trace_loss(self, ax=None, which=None, **kwargs):
        """Plot the loss trace (matplotlib)."""
        import matplotlib.pyplot as plt

        from .utils.plot import plot_trace_loss

        ax = plt.gca() if ax is None else ax
        plot_trace_loss(ax=ax, trace_loss=self.trace_loss, which=which,
                        **kwargs)
        return ax

    def peek(self, figsize=(12, 5), kwargs_norm=None):
        """Plot the loss trace and the total flux (matplotlib)."""
        import matplotlib.pyplot as plt

        from .utils.plot import add_cbar, simple_norm

        fig, axes = plt.subplots(nrows=1, ncols=2, figsize=figsize)
        self.plot_trace_loss(ax=axes[0])

        kwargs_norm = kwargs_norm or {"vmin": 0, "stretch": "asinh",
                                      "asinh_a": 0.01}
        flux = self.components.flux_total_numpy
        norm = simple_norm(flux, **kwargs_norm)
        im = axes[1].imshow(flux, origin="lower", norm=norm,
                            interpolation="None")
        add_cbar(im=im, ax=axes[1], fig=fig)

    def write(self, filename, overwrite=False, format=None):
        """Write the result to a file (FITS or ASDF; the format from the
        suffix unless given), in the JAX package's layout."""
        from .utils.io import IO_FORMATS_MAP_RESULT_WRITE, get_writer

        writer = get_writer(filename=filename, format=format,
                            registry=IO_FORMATS_MAP_RESULT_WRITE)
        writer(result=self, filename=filename, overwrite=overwrite)

    @classmethod
    def read(cls, filename, format=None, device=None):
        """Read a result from a file (FITS or ASDF) onto ``device``, by
        default the first CUDA card."""
        from .utils.io import IO_FORMATS_MAP_RESULT_READ, get_reader

        reader = get_reader(filename=filename, format=format,
                            registry=IO_FORMATS_MAP_RESULT_READ)
        return reader(filename=filename, device=resolve_device(device))
