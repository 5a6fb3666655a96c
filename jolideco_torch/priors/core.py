"""Prior base class and the flat prior (the JAX package's ``priors/core.py``).

A prior's ``__call__(flux, params=None, generator=None)`` returns the
scalar log-prior of one flux component. Randomness (cycle spins) comes
from a ``torch.Generator``: the training loop passes its own; a call
without one draws from the prior's generator, seeded at construction.
"""

import torch

__all__ = ["Prior", "UniformPrior"]


class Prior:
    """Prior base class."""

    def __init__(self, seed=0):
        self.generator = torch.Generator().manual_seed(int(seed))

    def parameters(self):
        """Trainable hyper-parameters (dict of tensors); default none."""
        return {}

    def set_parameters(self, params):
        """Write back trained hyper-parameters."""


class UniformPrior(Prior):
    """Flat prior: log-prior identically zero."""

    def __call__(self, flux, params=None, generator=None):
        return torch.zeros((), dtype=flux.dtype, device=flux.device)
