"""MAP deconvolution driver (the JAX package's ``core.py``), joint strategy.

One step of the joint strategy is

    flux = exp(log_flux) -> stacked Poisson NLL (FFT convolution)
         -> minus beta times the log-prior (GMM patch prior)
         -> backward -> one optimiser step,

run eagerly, one Python iteration per epoch (no CUDA graph yet). The
optimisers are ``torch.optim.Adam`` and ``torch.optim.SGD``, which make
the same updates as the JAX package's ``optax.adam`` and ``optax.sgd``
(bias-corrected moments, ``eps`` outside the square root). Randomness
(the prior's cycle spins) comes from one CPU ``torch.Generator`` seeded
with ``seed``; it draws other numbers than JAX's keys from the same
seed.

With ``compute_error=True`` the run ends with one Hessian probe at the
trained fluxes (``TotalLoss.fluxes_error``): flux errors
``sqrt(1 / (H · 1))`` per component, on the patch-level GMM scorer's
kernels.

Ported: ``update_strategy="joint"``, ``trace_every=0``, ``conv_mode``
``"fft"`` and ``"pfft"``, ``compute_error``. The sequential strategy,
the loss trace, early stopping, checkpoints, a device mesh, validation
data, calibrations, resuming and a prebuilt loss raise
``NotImplementedError``. Every keyword of the JAX package's signatures
is accepted, so that a call written for it fails only on what is not
ported.
"""

import logging
import time

import numpy as np
import torch

from .config import resolve_device
from .loss import PriorLoss, TotalLoss
from .models import FluxComponents, SpatialFluxComponent
from .parallel.stacked import StackedPoissonLoss

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
    """Tensors of a nested params dict, in insertion order."""
    for value in params.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def _trainable(params, device):
    """Copy of a nested params dict with leaves that require grad."""
    return {
        name: (
            _trainable(value, device) if isinstance(value, dict)
            else value.detach().to(device).clone().requires_grad_(True)
        )
        for name, value in params.items()
    }


class MAPDeconvolver:
    """Maximum a-posteriori deconvolver.

    Parameters
    ----------
    n_epochs : int
        Number of optimiser steps (one per epoch in the joint strategy).
    beta : float
        Prior scale factor.
    learning_rate : float
    optimizer_type : {"adam", "sgd"}
    optimizer_kwargs : dict, optional
        Torch-style keys: ``lr``, ``betas``, ``eps``, ``momentum``,
        ``nesterov``.
    update_strategy : {"joint"}
        ``"sequential"`` is not ported yet.
    trace_every : int
        Only 0 (no loss trace) is ported.
    seed : int
        Seed of the generator that draws the prior's cycle spins.
    device : str or torch.device, optional
        Where the run happens; default the first CUDA card (and an error
        without one). ``"cpu"`` runs the plain versions of the kernels.
    conv_mode : {"auto", "fft", "pfft"}
        PSF convolution backend: ``"fft"`` a batched ``rfft2`` (cuFFT on
        the card), ``"pfft"`` the pair-packed matrix DFT
        (``ops/pallas_fft.py``). ``"auto"`` takes the one that was faster
        on the card at the main path's shape (see ``build_loss``).
    fft_shape : tuple of int, optional
        Padded FFT shape (at least image + kernel - 1 per axis).
    compute_error : bool
        Compute flux errors from the loss Hessian after training.
    display_progress : bool
        Log the run's step count, time and first and last loss at INFO
        level when training ends (the JAX package shows a progress bar).
    scan_epochs, scan_chunk :
        How the JAX package compiles its loop; accepted and stored. The
        port runs one eager step per epoch whatever they say, with the
        same results.
    shard_prior : bool
        Accepted and stored: without a mesh it has no effect, in the JAX
        package too.
    stop_early, stop_early_n_average, checkpoint_path, mesh :
        Accepted for signature parity; ``stop_early``, a checkpoint path
        and a mesh raise ``NotImplementedError``.
    """

    _default_flux_component = "flux"

    def __init__(self, n_epochs=1_000, beta=1, learning_rate=0.1,
                 compute_error=False, stop_early=False,
                 stop_early_n_average=10, display_progress=True,
                 optimizer_type="adam", optimizer_kwargs=None,
                 checkpoint_path=None, update_strategy="sequential",
                 scan_epochs=None, scan_chunk=None, trace_every=1, seed=0,
                 device=None, mesh=None, conv_mode="auto", fft_shape=None,
                 shard_prior=True):
        unported = {
            "stop_early": stop_early,
            "checkpoint_path": checkpoint_path is not None,
            "mesh": mesh is not None,
            f"update_strategy={update_strategy!r}":
                update_strategy != "joint",
            f"trace_every={trace_every}": int(trace_every) != 0,
            f"conv_mode={conv_mode!r}":
                conv_mode not in ("auto", "fft", "pfft"),
        }
        for name, requested in unported.items():
            if requested:
                raise NotImplementedError(
                    f"MAPDeconvolver({name}) is not ported yet"
                )
        if optimizer_type not in OPTIMIZER:
            raise ValueError(
                f"Unknown optimizer: {optimizer_type}, must be one of "
                f"{list(OPTIMIZER)}"
            )
        self.n_epochs = int(n_epochs)
        self.beta = float(beta)
        self.learning_rate = float(learning_rate)
        self.compute_error = bool(compute_error)
        self.stop_early = False
        self.stop_early_n_average = int(stop_early_n_average)
        self.display_progress = bool(display_progress)
        self.scan_epochs = scan_epochs
        self.scan_chunk = None if scan_chunk is None else int(scan_chunk)
        self.mesh = None
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
            "mesh": None,
            "shard_prior": self.shard_prior,
        }

    def build_loss(self, datasets, components, device):
        """The joint strategy's total loss on ``device``."""
        # "auto" is the rfft2 (cuFFT): at the main path's 5 pairs of
        # 1024^2 (n = 1152) the matrix DFT took 1.94 ms per direction
        # under the default dial ("split": passes 2 and 3 on the tensor
        # cores) and 3.94 ms under "highest" (float32), cuFFT's packed
        # pair 0.58 ms and the batched rfft2 of the same 10 images 0.45 ms
        # (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W limit)
        conv_mode = "fft" if self.conv_mode == "auto" else self.conv_mode
        poisson = StackedPoissonLoss.from_datasets(
            datasets=datasets, components=components,
            fft_shape=self.fft_shape, conv_mode=conv_mode,
            device=device,
        )
        return TotalLoss(poisson_loss=poisson,
                         prior_loss=PriorLoss(components.priors),
                         beta=self.beta)

    def make_step(self, datasets, components):
        """Build the loss, parameters and optimiser of a run.

        Returns ``(step, params, components, total_loss)``: ``step()``
        takes one optimiser step and returns the loss at the parameters
        it started from (a device scalar, not fetched); ``params`` is
        the nested dict of trainable tensors it updates in place.
        """
        device = resolve_device(self.device)
        if isinstance(components, SpatialFluxComponent):
            components = {self._default_flux_component: components}
        components = FluxComponents(components)
        for component in components.values():
            component.to(device)
        total_loss = self.build_loss(datasets, components, device)

        params = _trainable(components.parameters(), device)
        optimizer = OPTIMIZER[self.optimizer_type](
            list(_leaves(params)), **self.optimizer_kwargs
        )
        generator = torch.Generator().manual_seed(self.seed)

        def step():
            optimizer.zero_grad(set_to_none=True)
            loss = total_loss(components.fluxes_from(params), params=params,
                              generator=generator)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return step, params, components, total_loss

    def run(self, datasets, datasets_validation=None, components=None,
            calibrations=None, resume_from=None, total_loss=None):
        """Run the MAP deconvolution.

        Parameters
        ----------
        datasets : dict of [str, dict]
            Per-dataset dicts with ``counts``, ``psf``, ``exposure`` and
            ``background`` numpy arrays.
        components : `FluxComponents`, dict or `SpatialFluxComponent`
            Required (the JAX package's default, ``None``, fails there
            too).
        datasets_validation, calibrations, resume_from, total_loss :
            Accepted for signature parity; anything but ``None`` raises
            ``NotImplementedError``.

        Returns
        -------
        result : `MAPDeconvolverResult`
        """
        unported = {"datasets_validation": datasets_validation,
                    "calibrations": calibrations, "resume_from": resume_from,
                    "total_loss": total_loss}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(
                    f"MAPDeconvolver.run({name}=...) is not ported yet"
                )
        if components is None:
            raise ValueError("MAPDeconvolver.run needs components")
        step, params, components, total_loss = self.make_step(datasets,
                                                              components)
        t0 = time.perf_counter()
        losses = [step() for _ in range(self.n_epochs)]
        # one host fetch at the end: no per-step synchronisation
        loss_per_step = (
            torch.stack(losses).cpu().numpy() if losses
            else np.zeros(0, np.float32)
        )
        train_seconds = time.perf_counter() - t0
        if self.display_progress and len(loss_per_step):
            log.info(f"MAPDeconvolver: {self.n_epochs} steps in "
                     f"{train_seconds:.3f} s, loss {loss_per_step[0]:.6g} "
                     f"-> {loss_per_step[-1]:.6g}")

        components.set_parameters(params)
        if not all(bool(torch.isfinite(p).all()) for p in _leaves(params)):
            log.warning(
                "Training produced non-finite parameters. Check the flux "
                "initialisation (strictly positive for log-flux "
                "components), the learning rate, and the data."
            )

        error_seconds = 0.0
        if self.compute_error:
            t1 = time.perf_counter()
            fluxes = components.fluxes_from(params)
            components.set_flux_errors(total_loss.fluxes_error(fluxes))
            if fluxes and fluxes[0].is_cuda:
                torch.cuda.synchronize(fluxes[0].device)
            error_seconds = time.perf_counter() - t1

        return MAPDeconvolverResult(
            config=self.to_dict(),
            components=components,
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
    loss_per_step : numpy array ``(n_epochs,)``
        Total loss at the parameters each step started from.
    train_seconds : float
        Host wall time of the optimisation loop, ending with the fetch
        of the loss values (so it includes the device's work).
    error_seconds : float
        Host wall time of the flux-error probe, ending with a device
        synchronisation (0 without ``compute_error``).
    """

    def __init__(self, config, components, loss_per_step, train_seconds,
                 error_seconds=0.0):
        self.config = config
        self.components = components
        self.loss_per_step = np.asarray(loss_per_step)
        self.train_seconds = float(train_seconds)
        self.error_seconds = float(error_seconds)

    @property
    def flux_upsampled_total(self):
        """Summed upsampled flux as a 2-D numpy array."""
        return np.sum(list(self.components.to_numpy().values()), axis=0)
