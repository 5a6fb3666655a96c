"""jolideco-torch: the PyTorch/CUDA port of jolideco-tpu (JAX).

MAP deconvolution of Poisson-count images under the GMM patch prior, on
PyTorch, with the GMM prior's scorer as CUDA kernels written by hand for
Hopper (``csrc/``). The JAX package beside it is the reference; this
package imports torch and numpy and never JAX. Module layout and public
names follow the JAX package.
"""

from . import config  # noqa: F401
from .core import MAPDeconvolver, MAPDeconvolverResult  # noqa: F401
from .loss import PoissonLoss, PriorLoss, TotalLoss  # noqa: F401
from .models import (  # noqa: F401
    FluxComponents,
    NPredCalibration,
    NPredCalibrations,
    NPredModel,
    NPredModels,
    SparseSpatialFluxComponent,
    SpatialFluxComponent,
)
from .priors import (  # noqa: F401
    ExponentialPrior,
    GaussianMixtureModel,
    GMMPatchPrior,
    ImagePrior,
    InverseGammaPrior,
    LIRAPrior,
    MultiScalePrior,
    Prior,
    Priors,
    SmoothnessPrior,
    UniformPrior,
)
from .utils.norms import (  # noqa: F401
    ASinhImageNorm,
    ATanImageNorm,
    FixedMaxImageNorm,
    IdentityImageNorm,
    InverseCDFImageNorm,
    LogImageNorm,
    MaxImageNorm,
    PowerImageNorm,
    SigmoidImageNorm,
    StandardizedSubtractMeanPatchNorm,
    SubtractMeanPatchNorm,
)

__version__ = "0.1.0"
