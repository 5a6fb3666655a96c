"""GMM patch prior and its mixture model."""

from .core import GMMPatchPrior, ZERO_FLUX_SENTINEL  # noqa: F401
from .gmm import GaussianMixtureModel, GaussianMixtureModelMeta  # noqa: F401
