"""Poisson likelihood, prior loss and total loss (the JAX package's ``loss.py``).

`PoissonLoss` holds per-dataset forward models (``models/npred.py``),
the sequential strategy's loss; the joint strategy's is the stacked
``parallel.stacked.StackedPoissonLoss``. `TotalLoss` takes either, and
keeps the loss trace: one row per recorded epoch with the total, the
summed data and prior terms, each prior and each dataset, and the
validation data's total when there is a validation loss. The trace
records raw, unweighted NLLs, under the JAX package's column names and
in its order.
"""

import math
from contextlib import nullcontext

import torch
import torch.distributed as dist

from .config import force_fused, resolve_device
from .models.npred import NPredModels, as_image
from .utils.table import Table

__all__ = ["PoissonLoss", "PriorLoss", "TotalLoss", "poisson_nll",
           "stirling_term_mean"]


def stirling_term_mean(counts):
    """Mean Stirling term of the full Poisson NLL.

    ``mean(counts log counts - counts + 0.5 log(2 pi counts))`` over
    pixels with ``counts > 1`` (``PoissonNLLLoss(full=True)``). Constant
    in the model parameters: precompute it once per dataset.
    """
    counts = torch.as_tensor(counts)
    clipped = torch.clamp(counts, min=1.0)
    stirling = (
        counts * torch.log(clipped)
        - counts
        + 0.5 * torch.log(2.0 * math.pi * clipped)
    )
    return torch.where(counts > 1, stirling, torch.zeros_like(stirling)).mean()


def poisson_nll(npred, counts, eps=1e-25, full=True, stirling=None):
    """Mean Poisson negative log-likelihood.

    ``mean(npred - counts log(npred + eps))`` plus, with ``full``, the
    Stirling term (pass a precomputed ``stirling`` to skip recomputing
    it).
    """
    loss = torch.mean(npred - counts * torch.log(npred + eps))
    if full:
        if stirling is None:
            stirling = stirling_term_mean(counts)
        loss = loss + stirling
    return loss


def _all_losses(poisson_loss, fluxes, calibration_params):
    """Every dataset's loss: a sharded stacked loss's gathered from the
    ranks (``StackedPoissonLoss.gather``)."""
    losses = poisson_loss.evaluate(fluxes, calibration_params)
    gather = getattr(poisson_loss, "gather", None)
    return losses if gather is None else gather(losses)


class PoissonLoss:
    """Per-dataset Poisson likelihood terms over per-dataset forward models.

    Parameters
    ----------
    counts_all : sequence of tensors ``(1, 1, H, W)``
    npred_models_all : sequence of `NPredModels`
    names_all : sequence of str
    """

    def __init__(self, counts_all, npred_models_all, names_all):
        if not len(counts_all) == len(npred_models_all) == len(names_all):
            raise ValueError(
                "counts_all, npred_models_all and names_all must have "
                f"the same length, got {len(counts_all)}/"
                f"{len(npred_models_all)}/{len(names_all)}"
            )
        self.counts_all = tuple(counts_all)
        self.npred_models_all = tuple(npred_models_all)
        self.names_all = tuple(names_all)
        # the Stirling term of the full NLL does not depend on the fluxes
        self.stirling_all = tuple(stirling_term_mean(c)
                                  for c in self.counts_all)
        # the calibrations' static likelihood weights (1 without one)
        self.weights = torch.tensor(
            [1.0 if models.calibration is None
             else models.calibration.weight
             for models in self.npred_models_all],
            dtype=torch.float32, device=self.counts_all[0].device)

    @property
    def n_datasets(self):
        return len(self.counts_all)

    def iter_by_dataset(self):
        """Iterate over ``(counts, npred_models)`` pairs."""
        yield from zip(self.counts_all, self.npred_models_all)

    def evaluate_dataset(self, idx, fluxes, calibration_params=None):
        """Mean Poisson NLL of dataset ``idx`` (differentiable);
        ``calibration_params`` is keyed by dataset name."""
        params = None
        if calibration_params is not None:
            params = calibration_params.get(self.names_all[idx])
        npred = self.npred_models_all[idx].evaluate(fluxes, params)
        return poisson_nll(npred, self.counts_all[idx],
                           stirling=self.stirling_all[idx])

    def evaluate(self, fluxes, calibration_params=None):
        """Per-dataset losses: ``(N,)`` tensor."""
        return torch.stack([
            self.evaluate_dataset(idx, fluxes, calibration_params)
            for idx in range(self.n_datasets)])

    def __call__(self, fluxes, calibration_params=None):
        """Weighted sum of the dataset losses."""
        return torch.sum(self.evaluate(fluxes, calibration_params)
                         * self.weights)

    @classmethod
    def from_datasets(cls, datasets, components, calibrations=None,
                      fft_shape=None, device=None):
        """Per-dataset models from numpy dataset dicts (``counts``,
        ``psf``, ``exposure``, ``background``) on ``device`` (default the
        first CUDA card); ``calibrations`` keyed like ``datasets``."""
        device = resolve_device(device)
        npred_models_all, counts_all = [], []
        for name, dataset in datasets.items():
            npred_models_all.append(NPredModels.from_dataset_numpy(
                dataset=dataset, components=components,
                calibration=calibrations[name] if calibrations else None,
                fft_shape=fft_shape, device=device,
            ))
            counts_all.append(as_image(dataset["counts"], device))
        return cls(counts_all=counts_all, npred_models_all=npred_models_all,
                   names_all=list(datasets))


class PriorLoss:
    """Sum of per-component prior terms."""

    def __init__(self, priors):
        self.priors = priors

    def draw_shifts(self, generator=None, shapes=None):
        """The random draws of one evaluation of every prior, made in the
        priors' order at the matching flux ``shapes``: ``{name: draws}``
        for ``shifts=``."""
        shapes = shapes or [None] * len(self.priors)
        return {name: prior.draw_shifts(generator, shape)
                for (name, prior), shape in zip(self.priors.items(), shapes)}

    def evaluate(self, fluxes, params=None, generator=None, shifts=None):
        """Per-component log-prior values.

        ``shifts`` maps component names to their priors' draws (default:
        each prior draws its own).
        """
        values = []
        for flux, (name, prior) in zip(fluxes, self.priors.items()):
            prior_params = None
            if params is not None and name in params:
                prior_params = params[name].get("prior")
            values.append(prior(flux, params=prior_params,
                                generator=generator,
                                shifts=(shifts or {}).get(name)))
        return values

    def evaluate_sharded(self, fluxes, params=None, generator=None,
                         shifts=None, n_shards=1, shard_index=0):
        """Per-component shard parts of the log-prior
        (``Prior.shard_partial``): summed over the shards, each called
        with the same draws, they equal :meth:`evaluate`'s values."""
        values = []
        for flux, (name, prior) in zip(fluxes, self.priors.items()):
            prior_params = None
            if params is not None and name in params:
                prior_params = params[name].get("prior")
            values.append(prior.shard_partial(
                flux, params=prior_params, generator=generator,
                shifts=(shifts or {}).get(name), n_shards=n_shards,
                shard_index=shard_index))
        return values

    def __call__(self, fluxes, params=None, generator=None, shifts=None):
        """Summed log-prior."""
        return sum(self.evaluate(fluxes, params=params, generator=generator,
                                 shifts=shifts))


class TotalLoss:
    """Weighted Poisson terms minus the beta-weighted log-prior, with the
    loss trace.

    Parameters
    ----------
    poisson_loss : `PoissonLoss` or `StackedPoissonLoss`
    prior_loss : `PriorLoss`
    poisson_loss_validation : optional
        The validation data's loss (same kind), traced as
        ``datasets-validation-total``; early stopping reads it.
    beta : float
    """

    def __init__(self, poisson_loss, prior_loss, poisson_loss_validation=None,
                 beta=1):
        self.poisson_loss = poisson_loss
        self.poisson_loss_validation = poisson_loss_validation
        self.prior_loss = prior_loss
        self.beta = float(beta)
        self._trace = None

    @property
    def trace(self):
        """Loss trace `Table` (built on first use)."""
        if self._trace is None:
            names = ["total", "datasets-total", "priors-total"]
            names += [f"prior-{name}" for name in self.prior_loss.priors]
            names += [f"dataset-{name}"
                      for name in self.poisson_loss.names_all]
            if self.poisson_loss_validation:
                names += ["datasets-validation-total"]
            names += ["filename"]
            dtypes = [float] * (len(names) - 1) + [str]
            self._trace = Table(names=names, dtype=dtypes)
        return self._trace

    @property
    def prior_weight(self):
        """Prior normalisation: the number of datasets. As in the JAX
        package (and upstream), ``__call__`` does not apply it: the
        sequential step divides the prior by it."""
        return self.poisson_loss.n_datasets

    def reset_trace(self):
        """Start a fresh trace (a reused loss gets one per run)."""
        self._trace = None

    def trace_row_values(self, fluxes, params=None, generator=None,
                         shifts=None, calibration_params=None):
        """One trace row as a dict of device scalars, in the trace's
        column order (without ``filename``). Raw, unweighted NLLs; on a
        mesh every dataset's, the same on every rank (the priors are
        computed whole on each)."""
        loss_datasets = _all_losses(self.poisson_loss, fluxes,
                                    calibration_params)
        loss_priors = self.prior_loss.evaluate(
            fluxes, params=params, generator=generator, shifts=shifts
        )
        loss_datasets_total = torch.sum(loss_datasets)
        loss_priors_total = self.beta * sum(loss_priors)
        row = {
            "total": loss_datasets_total - loss_priors_total,
            "datasets-total": loss_datasets_total,
            "priors-total": -loss_priors_total,
        }
        for name, value in zip(self.prior_loss.priors, loss_priors):
            row[f"prior-{name}"] = -self.beta * value
        for name, value in zip(self.poisson_loss.names_all, loss_datasets):
            row[f"dataset-{name}"] = value
        if self.poisson_loss_validation:
            row["datasets-validation-total"] = torch.sum(_all_losses(
                self.poisson_loss_validation, fluxes, calibration_params))
        return row

    def append_trace_device_row(self, row, filename=""):
        """Append a row of computed scalars (fetched here, one by one)."""
        host_row = {k: float(v) for k, v in row.items()}
        host_row["filename"] = str(filename)
        self.trace.add_row(host_row)

    @classmethod
    def from_datasets_and_components(cls, datasets, components,
                                     datasets_validation=None, beta=1,
                                     calibrations=None, fft_shape=None,
                                     device=None):
        """The per-dataset total loss (the sequential strategy's)."""
        poisson_loss = PoissonLoss.from_datasets(
            datasets=datasets, components=components,
            calibrations=calibrations, fft_shape=fft_shape, device=device,
        )
        poisson_loss_validation = None
        if datasets_validation:
            poisson_loss_validation = PoissonLoss.from_datasets(
                datasets=datasets_validation, components=components,
                calibrations=calibrations, fft_shape=fft_shape,
                device=device,
            )
        return cls(poisson_loss=poisson_loss,
                   prior_loss=PriorLoss(components.priors),
                   poisson_loss_validation=poisson_loss_validation,
                   beta=beta)

    def __call__(self, fluxes, params=None, generator=None, shifts=None,
                 calibration_params=None):
        """Total loss as a function of the flux tuple (differentiable):
        the Poisson terms weighted by the calibrations' weights, minus
        beta times the log-prior."""
        losses = self.poisson_loss.evaluate(fluxes, calibration_params)
        prior = self.prior_loss(fluxes, params=params, generator=generator,
                                shifts=shifts)
        return (
            torch.sum(losses * self.poisson_loss.weights) - self.beta * prior
        )

    def hessian_diagonals(self, fluxes, generator=None, shifts=None,
                          calibration_params=None):
        """Hessian of the total loss times a ones vector, per component.

        The same probe as the JAX package's (``H · 1`` at ``fluxes``,
        the Poisson term included), taken reverse over reverse: the
        gradient with ``create_graph=True``, then the gradient of its
        dot product with ones. The Hessian is symmetric, so that is
        ``H · 1``. A prior whose scorer has no second derivative at its
        shape (the fused GMM scorer, ``second_order_ok``) makes the
        probe turn the fused switch off, so that the patch-level scorer
        runs instead. ``generator`` and ``shifts`` are passed to the
        priors as in :meth:`__call__`. The Hessian is taken with respect
        to the fluxes, the calibrations held at ``calibration_params``
        (their trained values).

        With a sharded stacked loss (on a mesh) each rank takes the
        Hessian of its data terms, rank 0 adds the prior's once, and the
        diagonals are summed over the ranks: every rank returns the
        whole.
        """
        if calibration_params is not None:
            calibration_params = {
                name: {k: v.detach() for k, v in leaves.items()}
                for name, leaves in calibration_params.items()}
        fluxes = tuple(f.detach().requires_grad_(True) for f in fluxes)
        second_order = all(
            prior.second_order_ok(tuple(flux.shape))
            for prior, flux in zip(self.prior_loss.priors.values(), fluxes)
        )
        sharded = getattr(self.poisson_loss, "mesh", None) is not None
        if sharded and shifts is None:
            # every rank draws, so that the priors' generators stay alike
            shifts = self.prior_loss.draw_shifts(
                generator, [tuple(f.shape) for f in fluxes])
        with nullcontext() if second_order else force_fused("off"):
            if not sharded:
                loss = self(fluxes, generator=generator, shifts=shifts,
                            calibration_params=calibration_params)
            else:
                loss = torch.sum(self.poisson_loss.evaluate(
                    fluxes, calibration_params) * self.poisson_loss.weights)
                if dist.get_rank() == 0:
                    loss = loss - self.beta * self.prior_loss(fluxes,
                                                              shifts=shifts)
            grads = torch.autograd.grad(loss, fluxes, create_graph=True)
            hessians = torch.autograd.grad(
                grads, fluxes, grad_outputs=[torch.ones_like(f) for f in fluxes]
            )
        if not sharded:
            return hessians
        flat = torch.cat([h.reshape(-1) for h in hessians])
        dist.all_reduce(flat)
        return tuple(part.view_as(h) for part, h in zip(
            flat.split([h.numel() for h in hessians]), hessians))

    def fluxes_error(self, fluxes, generator=None, shifts=None,
                     calibration_params=None):
        """Flux errors ``sqrt(1 / (H · 1))`` per component name."""
        hessians = self.hessian_diagonals(
            fluxes, generator=generator, shifts=shifts,
            calibration_params=calibration_params)
        return {
            name: torch.sqrt(1.0 / hessian)
            for name, hessian in zip(self.prior_loss.priors, hessians)
        }
