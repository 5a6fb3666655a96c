"""Poisson likelihood, prior loss and total loss (the JAX package's ``loss.py``)."""

import math

import torch

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

    def evaluate(self, fluxes, params=None, generator=None):
        """Per-component log-prior values."""
        values = []
        for flux, (name, prior) in zip(fluxes, self.priors.items()):
            prior_params = None
            if params is not None and name in params:
                prior_params = params[name].get("prior")
            values.append(prior(flux, params=prior_params,
                                generator=generator))
        return values

    def __call__(self, fluxes, params=None, generator=None):
        """Summed log-prior."""
        return sum(self.evaluate(fluxes, params=params, generator=generator))


class TotalLoss:
    """Weighted Poisson terms minus the beta-weighted log-prior."""

    def __init__(self, poisson_loss, prior_loss, beta=1):
        self.poisson_loss = poisson_loss
        self.prior_loss = prior_loss
        self.beta = float(beta)

    def __call__(self, fluxes, params=None, generator=None):
        """Total loss as a function of the flux tuple (differentiable)."""
        losses = self.poisson_loss.evaluate(fluxes)
        prior = self.prior_loss(fluxes, params=params, generator=generator)
        return (
            torch.sum(losses * self.poisson_loss.weights) - self.beta * prior
        )
