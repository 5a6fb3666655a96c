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

    def draw_shifts(self, generator=None):
        """Draw the random shifts of one evaluation ahead of it, to pass
        back as ``shifts=``; ``None`` for a prior that draws none."""
        return None

    def second_order_ok(self, flux_shape):
        """Whether the log-prior has a second derivative at this shape
        under the current dispatch (default: yes)."""
        return True


class UniformPrior(Prior):
    """Flat prior: log-prior identically zero."""

    def __call__(self, flux, params=None, generator=None, shifts=None):
        return torch.zeros((), dtype=flux.dtype, device=flux.device)
