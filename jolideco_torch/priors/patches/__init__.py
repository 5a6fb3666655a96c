"""GMM patch prior, its multiscale wrapper and its mixture model."""

from .core import GMMPatchPrior, MultiScalePrior, ZERO_FLUX_SENTINEL  # noqa: F401
from .gmm import (  # noqa: F401
    GMM_REGISTRY,
    GaussianMixtureModel,
    GaussianMixtureModelMeta,
)
