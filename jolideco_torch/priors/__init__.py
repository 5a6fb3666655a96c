"""Priors: log-prior terms on flux components."""

from .core import Prior, UniformPrior  # noqa: F401
from .patches import GaussianMixtureModel, GMMPatchPrior  # noqa: F401

__all__ = ["GaussianMixtureModel", "GMMPatchPrior", "Prior", "UniformPrior"]
