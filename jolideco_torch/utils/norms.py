"""Image and patch normalisations (the JAX package's ``utils/norms.py``).

Only the two norms the GMM patch prior's main path uses are ported:
the identity image norm and the subtract-mean patch norm. The other
seven image norms and the standardized patch norm are still to come.
"""

import torch

__all__ = ["IdentityImageNorm", "SubtractMeanPatchNorm"]


class IdentityImageNorm:
    """Identity image norm (no trainable parameters)."""

    def parameters(self):
        return {}

    def __call__(self, image, params=None):
        return image

    def inverse(self, image, params=None):
        return image

    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self).__name__)


class SubtractMeanPatchNorm:
    """Subtract the per-patch mean (the EPLL convention)."""

    def __call__(self, patches):
        return patches - torch.nanmean(patches, dim=1, keepdim=True)

    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self).__name__)
