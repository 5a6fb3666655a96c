"""Flux components (the learnable latent images) and forward models."""

from .core import FluxComponents, SpatialFluxComponent  # noqa: F401
from .npred import NPredModel, NPredModels  # noqa: F401
