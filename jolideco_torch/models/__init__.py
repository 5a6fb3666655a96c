"""Flux components: the learnable latent images."""

from .core import FluxComponents, SpatialFluxComponent  # noqa: F401
