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

Ported: ``update_strategy="joint"``, ``trace_every=0``,
``conv_mode="fft"``. The sequential strategy, the loss trace, early
stopping, checkpoints and flux errors raise ``NotImplementedError``.
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
        Where the run happens; default the first CUDA card, else CPU.
    conv_mode : {"auto", "fft"}
        PSF convolution backend. ``"auto"`` is the FFT (cuFFT on the
        card) until the matmul-DFT kernel is ported and measured.
    fft_shape : tuple of int, optional
        Padded FFT shape (at least image + kernel - 1 per axis).
    compute_error, stop_early, checkpoint_path :
        Accepted for signature parity; anything but the defaults raises
        ``NotImplementedError``.
    """

    _default_flux_component = "flux"

    def __init__(self, n_epochs=1_000, beta=1, learning_rate=0.1,
                 compute_error=False, stop_early=False,
                 optimizer_type="adam", optimizer_kwargs=None,
                 checkpoint_path=None, update_strategy="sequential",
                 trace_every=1, seed=0, device=None, conv_mode="auto",
                 fft_shape=None):
        unported = {
            "compute_error": compute_error,
            "stop_early": stop_early,
            "checkpoint_path": checkpoint_path is not None,
            f"update_strategy={update_strategy!r}":
                update_strategy != "joint",
            f"trace_every={trace_every}": int(trace_every) != 0,
            f"conv_mode={conv_mode!r}": conv_mode not in ("auto", "fft"),
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
            "optimizer_type": self.optimizer_type,
            "optimizer_kwargs": {
                k: v for k, v in self.optimizer_kwargs.items()
                if k != "learning_rate"
            },
            "update_strategy": self.update_strategy,
            "trace_every": self.trace_every,
            "seed": self.seed,
            "device": None if self.device is None else str(self.device),
            "conv_mode": self.conv_mode,
            "fft_shape": None if self.fft_shape is None
            else list(self.fft_shape),
        }

    def build_loss(self, datasets, components, device):
        """The joint strategy's total loss on ``device``."""
        poisson = StackedPoissonLoss.from_datasets(
            datasets=datasets, components=components,
            fft_shape=self.fft_shape, conv_mode=self.conv_mode,
            device=device,
        )
        return TotalLoss(poisson_loss=poisson,
                         prior_loss=PriorLoss(components.priors),
                         beta=self.beta)

    def make_step(self, datasets, components):
        """Build the loss, parameters and optimiser of a run.

        Returns ``(step, params, components)``: ``step()`` takes one
        optimiser step and returns the loss at the parameters it started
        from (a device scalar, not fetched); ``params`` is the nested
        dict of trainable tensors it updates in place.
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

        return step, params, components

    def run(self, datasets, components):
        """Run the MAP deconvolution.

        Parameters
        ----------
        datasets : dict of [str, dict]
            Per-dataset dicts with ``counts``, ``psf``, ``exposure`` and
            ``background`` numpy arrays.
        components : `FluxComponents`, dict or `SpatialFluxComponent`

        Returns
        -------
        result : `MAPDeconvolverResult`
        """
        step, params, components = self.make_step(datasets, components)
        t0 = time.perf_counter()
        losses = [step() for _ in range(self.n_epochs)]
        # one host fetch at the end: no per-step synchronisation
        loss_per_step = (
            torch.stack(losses).cpu().numpy() if losses
            else np.zeros(0, np.float32)
        )
        train_seconds = time.perf_counter() - t0

        components.set_parameters(params)
        if not all(bool(torch.isfinite(p).all()) for p in _leaves(params)):
            log.warning(
                "Training produced non-finite parameters. Check the flux "
                "initialisation (strictly positive for log-flux "
                "components), the learning rate, and the data."
            )
        return MAPDeconvolverResult(
            config=self.to_dict(),
            components=components,
            loss_per_step=loss_per_step,
            train_seconds=train_seconds,
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
    """

    def __init__(self, config, components, loss_per_step, train_seconds):
        self.config = config
        self.components = components
        self.loss_per_step = np.asarray(loss_per_step)
        self.train_seconds = float(train_seconds)

    @property
    def flux_upsampled_total(self):
        """Summed upsampled flux as a 2-D numpy array."""
        return np.sum(list(self.components.to_numpy().values()), axis=0)
