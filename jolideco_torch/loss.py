"""Poisson likelihood, prior loss and total loss (the JAX package's ``loss.py``)."""

import math
from contextlib import nullcontext

import torch

from .config import force_fused

__all__ = ["PriorLoss", "TotalLoss", "poisson_nll", "stirling_term_mean"]


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


class PriorLoss:
    """Sum of per-component prior terms."""

    def __init__(self, priors):
        self.priors = priors

    def evaluate(self, fluxes, params=None, generator=None, shifts=None):
        """Per-component log-prior values.

        ``shifts`` maps component names to fixed cycle spins ``(sy, sx)``
        (default: each prior draws its own).
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

    def __call__(self, fluxes, params=None, generator=None, shifts=None):
        """Summed log-prior."""
        return sum(self.evaluate(fluxes, params=params, generator=generator,
                                 shifts=shifts))


class TotalLoss:
    """Weighted Poisson terms minus the beta-weighted log-prior."""

    def __init__(self, poisson_loss, prior_loss, beta=1):
        self.poisson_loss = poisson_loss
        self.prior_loss = prior_loss
        self.beta = float(beta)

    def __call__(self, fluxes, params=None, generator=None, shifts=None):
        """Total loss as a function of the flux tuple (differentiable)."""
        losses = self.poisson_loss.evaluate(fluxes)
        prior = self.prior_loss(fluxes, params=params, generator=generator,
                                shifts=shifts)
        return (
            torch.sum(losses * self.poisson_loss.weights) - self.beta * prior
        )

    def hessian_diagonals(self, fluxes, generator=None, shifts=None):
        """Hessian of the total loss times a ones vector, per component.

        The same probe as the JAX package's (``H · 1`` at ``fluxes``,
        the Poisson term included), taken reverse over reverse: the
        gradient with ``create_graph=True``, then the gradient of its
        dot product with ones. The Hessian is symmetric, so that is
        ``H · 1``. A prior whose scorer has no second derivative at its
        shape (the fused GMM scorer, ``second_order_ok``) makes the
        probe turn the fused switch off, so that the patch-level scorer
        runs instead. ``generator`` and ``shifts`` are passed to the
        priors as in :meth:`__call__`.
        """
        fluxes = tuple(f.detach().requires_grad_(True) for f in fluxes)
        second_order = all(
            prior.second_order_ok(tuple(flux.shape))
            for prior, flux in zip(self.prior_loss.priors.values(), fluxes)
        )
        with nullcontext() if second_order else force_fused("off"):
            loss = self(fluxes, generator=generator, shifts=shifts)
            grads = torch.autograd.grad(loss, fluxes, create_graph=True)
            return torch.autograd.grad(
                grads, fluxes, grad_outputs=[torch.ones_like(f) for f in fluxes]
            )

    def fluxes_error(self, fluxes, generator=None, shifts=None):
        """Flux errors ``sqrt(1 / (H · 1))`` per component name."""
        hessians = self.hessian_diagonals(fluxes, generator=generator,
                                          shifts=shifts)
        return {
            name: torch.sqrt(1.0 / hessian)
            for name, hessian in zip(self.prior_loss.priors, hessians)
        }
