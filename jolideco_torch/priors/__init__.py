"""Priors: log-prior terms on flux components."""

from .core import (  # noqa: F401
    ExponentialPrior,
    ImagePrior,
    InverseGammaPrior,
    Prior,
    Priors,
    SmoothnessPrior,
    UniformPrior,
)
from .lira import LIRAPrior  # noqa: F401
from .patches import (  # noqa: F401
    GaussianMixtureModel,
    GMMPatchPrior,
    MultiScalePrior,
)

PRIOR_REGISTRY = {
    "uniform": UniformPrior,
    "gmm-patches": GMMPatchPrior,
    "smooth": SmoothnessPrior,
    "inverse-gamma": InverseGammaPrior,
    "exponential": ExponentialPrior,
    "lira": LIRAPrior,
    "multiscale-prior": MultiScalePrior,
}

__all__ = [
    "GaussianMixtureModel",
    "GMMPatchPrior",
    "MultiScalePrior",
    "ExponentialPrior",
    "UniformPrior",
    "SmoothnessPrior",
    "ImagePrior",
    "LIRAPrior",
    "InverseGammaPrior",
    "Priors",
    "Prior",
    "PRIOR_REGISTRY",
]
