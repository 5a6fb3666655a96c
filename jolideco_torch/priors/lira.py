"""LIRA-style Dirichlet multiscale prior (the JAX package's
``priors/lira.py``).

Per level, the image is split into non-overlapping 2x2 blocks, each
block normalised to proportions and scored under a symmetric Dirichlet
of concentration ``alpha``; the image is then summed over the blocks
and the next level scores the result.
"""

import torch

from ..ops.image import cycle_spin, draw_cycle_spin, sum_pool
from ..ops.patches import view_as_overlapping_patches
from .core import Prior

__all__ = ["LIRAPrior"]


def _dirichlet_logpdf(p, alpha):
    """Symmetric Dirichlet log-pdf over the rows of ``p``; the
    normalisation in float32, as the JAX package computes it."""
    k = p.shape[-1]
    a = torch.tensor(alpha, dtype=torch.float32)
    log_norm = float(torch.lgamma(k * a) - k * torch.lgamma(a))
    return log_norm + (alpha - 1.0) * torch.sum(torch.log(p), dim=-1)


class LIRAPrior(Prior):
    """Multiscale Dirichlet prior over 2x2 flux-split proportions.

    Parameters
    ----------
    alphas : sequence of float
        Dirichlet concentration per level (coarsest last).
    cycle_spin : bool
        Random roll before evaluation (of at most 2 // 4 = 0 pixels, as
        in the JAX package).
    """

    def __init__(self, alphas, cycle_spin=True, seed=0):
        super().__init__(seed=seed)
        self.alphas = tuple(float(a) for a in alphas)
        self.cycle_spin = bool(cycle_spin)

    def draw_shifts(self, generator=None, shape=None):
        """The cycle spin ``(sy, sx)`` (``None`` without one)."""
        if not self.cycle_spin:
            return None
        return draw_cycle_spin(
            (2, 2), self.generator if generator is None else generator)

    def __call__(self, flux, params=None, generator=None, shifts=None):
        if self.cycle_spin:
            if shifts is None:
                shifts = self.draw_shifts(generator)
            flux, _ = cycle_spin(flux, (2, 2), shifts=shifts)

        log_prior = 0.0
        level_flux = flux
        for alpha in self.alphas:
            patches = view_as_overlapping_patches(level_flux, (2, 2),
                                                  stride=2)
            totals = torch.sum(patches, dim=1, keepdim=True)
            proportions = patches / torch.clamp(totals, min=1e-25)
            values = _dirichlet_logpdf(torch.clamp(proportions, min=1e-25),
                                       alpha)
            log_prior = log_prior + torch.sum(values) / flux.numel()
            level_flux = sum_pool(level_flux, 2)
        return log_prior

    def to_dict(self):
        data = super().to_dict()
        data["alphas"] = list(self.alphas)
        data["cycle_spin"] = bool(self.cycle_spin)
        return data

