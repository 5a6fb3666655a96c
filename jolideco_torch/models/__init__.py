"""Flux components (the learnable latent images) and forward models."""

from .core import (  # noqa: F401
    FluxComponents,
    SparseSpatialFluxComponent,
    SpatialFluxComponent,
)
from .npred import (  # noqa: F401
    NPredCalibration,
    NPredCalibrations,
    NPredModel,
    NPredModels,
)
