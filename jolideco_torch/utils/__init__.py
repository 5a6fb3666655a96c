"""Host-side helpers: analytic kernels, norms, kernel builds, interop."""

from .datasets import split_datasets_validation  # noqa: F401
from .norms import NORMS_PATCH_REGISTRY, NORMS_REGISTRY  # noqa: F401
