"""Image and patch normalisations (the JAX package's ``utils/norms.py``).

Nine image norms (identity, max, fixed-max, sigmoid, atan, inverse-cdf,
asinh, log, power) and two patch norms (subtract-mean, standardized),
under the JAX package's registry names. An image norm keeps its
trainable scalars as Python floats (``_param_names``) and exposes them
through :meth:`ImageNorm.parameters` as ``(1,)`` float32 tensors, the
leaves the optimiser trains; every transfer function takes an optional
``params`` dict of such leaves in their place. Without it the stored
values are used, as float32 scalars on the image's device, made once
per device and value; a norm's tensors move with :meth:`ImageNorm.to`.
Norms compare by value (class, parameters, ``frozen``), as in the JAX
package.
"""

import abc

import numpy as np
import torch

from .misc import format_class_str

__all__ = [
    "ImageNorm",
    "IdentityImageNorm",
    "MaxImageNorm",
    "FixedMaxImageNorm",
    "SigmoidImageNorm",
    "ATanImageNorm",
    "InverseCDFImageNorm",
    "ASinhImageNorm",
    "LogImageNorm",
    "PowerImageNorm",
    "PatchNorm",
    "SubtractMeanPatchNorm",
    "StandardizedSubtractMeanPatchNorm",
    "NORMS_REGISTRY",
    "NORMS_PATCH_REGISTRY",
]


class PatchNorm(abc.ABC):
    """Patch normalisation base class, on ``(n_patches, p*p)`` rows;
    compared by value."""

    def _config_key(self):
        return (type(self).__name__,)

    def __eq__(self, other):
        return (
            type(other) is type(self)
            and other._config_key() == self._config_key()
        )

    def __hash__(self):
        return hash(self._config_key())

    @abc.abstractmethod
    def __call__(self, patches):
        """Normalise patches."""

    def inverse(self, patches_normed):
        """Inverse normalisation (not defined for mean subtraction)."""
        raise NotImplementedError

    def evaluate_numpy(self, patches):
        """Evaluate on a numpy array, returning numpy."""
        return self(torch.as_tensor(np.asarray(patches, np.float32))).numpy()

    def to_dict(self):
        data = {}
        for name, cls in NORMS_PATCH_REGISTRY.items():
            if isinstance(self, cls):
                data["type"] = name
                break
        return data

    @classmethod
    def from_dict(cls, data):
        kwargs = data.copy()
        if "type" in data:
            cls = NORMS_PATCH_REGISTRY[kwargs.pop("type")]
            return cls.from_dict(kwargs)
        return cls(**kwargs)

    def __str__(self):
        return format_class_str(instance=self)


class SubtractMeanPatchNorm(PatchNorm):
    """Subtract the per-patch mean (the EPLL convention)."""

    def __call__(self, patches):
        return patches - torch.nanmean(patches, dim=1, keepdim=True)


class StandardizedSubtractMeanPatchNorm(PatchNorm):
    """Subtract and divide by the per-patch mean."""

    def __call__(self, patches):
        patches_mean = torch.nanmean(patches, dim=1, keepdim=True)
        return (patches - patches_mean) / patches_mean


class ImageNorm:
    """Image normalisation base class.

    Subclasses name their trainable scalars in ``_param_names``;
    :meth:`parameters` gives them as ``(1,)`` float32 tensors (none when
    ``frozen``), and every transfer function accepts ``params``, a dict
    of such tensors that replaces the stored values.
    """

    _param_names = ()

    def __init__(self, frozen=False):
        self.frozen = frozen
        self._constants = {}

    def _config_key(self):
        return (
            type(self).__name__,
            bool(self.frozen),
            tuple(float(getattr(self, name)) for name in self._param_names),
        )

    def __eq__(self, other):
        return (
            type(other) is type(self)
            and other._config_key() == self._config_key()
        )

    def __hash__(self):
        return hash(self._config_key())

    def parameters(self):
        """Trainable parameters: a dict of ``(1,)`` float32 tensors."""
        if self.frozen:
            return {}
        return {
            name: torch.tensor([float(getattr(self, name))],
                               dtype=torch.float32)
            for name in self._param_names
        }

    def to(self, device):
        """Move the norm's tensors to ``device`` (in place)."""
        return self

    def set_parameters(self, params):
        """Write back trained parameter values."""
        for name, value in (params or {}).items():
            setattr(self, name,
                    float(torch.as_tensor(value).detach().reshape(())))

    def _get(self, params, name, device):
        """The parameter ``name``: its leaf in ``params``, else the stored
        value as a float32 scalar on ``device`` (made once per value)."""
        if params is not None and name in params:
            return params[name].reshape(())
        value = float(getattr(self, name))
        key = (name, str(device))
        cached = self._constants.get(key)
        if cached is None or cached[0] != value:
            cached = (value, torch.tensor(value, dtype=torch.float32,
                                          device=device))
            self._constants[key] = cached
        return cached[1]

    @abc.abstractmethod
    def __call__(self, image, params=None):
        """Apply the norm."""

    def inverse(self, image, params=None):
        raise NotImplementedError

    def evaluate_numpy(self, image):
        return self(torch.as_tensor(np.asarray(image, np.float32))).numpy()

    def inverse_numpy(self, image):
        return self.inverse(
            torch.as_tensor(np.asarray(image, np.float32))).numpy()

    def to_dict(self):
        data = {}
        for name, cls in NORMS_REGISTRY.items():
            if isinstance(self, cls):
                data["type"] = name
                break
        for name in self._param_names:
            data[name] = float(getattr(self, name))
        return data

    @classmethod
    def from_dict(cls, data):
        kwargs = data.copy()
        if "type" in data:
            cls = NORMS_REGISTRY[kwargs.pop("type")]
            return cls.from_dict(kwargs)
        return cls(**kwargs)

    def __str__(self):
        return format_class_str(instance=self)

    def plot(self, ax=None, xrange=None, **kwargs):
        """Plot the transfer function (matplotlib)."""
        import matplotlib.pyplot as plt

        if xrange is None:
            if isinstance(self, InverseCDFImageNorm):
                xrange = float(self.x[0]), float(self.x[-2])
            else:
                xrange = 0, 1

        ax = plt.gca() if ax is None else ax
        kwargs.setdefault("label", self.__class__.__name__)

        x = np.linspace(xrange[0], xrange[1], 1000)
        y = self.evaluate_numpy(image=x)
        ax.plot(x, y, **kwargs)
        ax.set_xlabel("Pixel value")
        ax.set_ylabel("Scaled pixel value / A.U.")
        ax.set_ylim(0, 1)
        plt.legend()
        return ax


class IdentityImageNorm(ImageNorm):
    """Identity norm."""

    def __call__(self, image, params=None):
        return image

    def inverse(self, image, params=None):
        return image


class ASinhImageNorm(ImageNorm):
    """Inverse hyperbolic sine norm with trainable alpha and beta."""

    _param_names = ("alpha", "beta")

    def __init__(self, alpha=1.0, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def __call__(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        beta = self._get(params, "beta", image.device)
        return torch.asinh(image / alpha) / torch.asinh(beta / alpha)

    def inverse(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        beta = self._get(params, "beta", image.device)
        return alpha * torch.sinh(image * torch.asinh(beta / alpha))


class MaxImageNorm(ImageNorm):
    """Normalise by the image maximum (ties share the gradient)."""

    def __call__(self, image, params=None):
        return image / image.amax()


class FixedMaxImageNorm(ImageNorm):
    """Normalise by a fixed maximum, clipped to [0, 1]."""

    _param_names = ("max_value",)

    def __init__(self, max_value, **kwargs):
        super().__init__(**kwargs)
        self.max_value = float(max_value)

    def __call__(self, image, params=None):
        max_value = self._get(params, "max_value", image.device)
        return torch.clip(image / max_value, 0.0, 1.0)

    def inverse(self, image, params=None):
        return image * self._get(params, "max_value", image.device)


class SigmoidImageNorm(ImageNorm):
    """Sigmoid norm with trainable alpha and beta."""

    _param_names = ("alpha", "beta")

    def __init__(self, alpha=1.0, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def __call__(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        beta = self._get(params, "beta", image.device)
        return 1.0 / (1.0 + torch.exp(-(image - beta / 2.0) / alpha))

    def inverse(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        beta = self._get(params, "beta", image.device)
        return alpha * torch.log(image / (1.0 - image)) + beta / 2.0


class ATanImageNorm(ImageNorm):
    """Arctangent norm with trainable alpha."""

    _param_names = ("alpha",)

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def __call__(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        return 2.0 * torch.arctan(image / alpha) / np.pi

    def inverse(self, image, params=None):
        # the exact inverse of 2 atan(x / alpha) / pi, as in the JAX
        # package (the upstream inverse ignores alpha)
        alpha = self._get(params, "alpha", image.device)
        return alpha * torch.tan(0.5 * np.pi * image)


class InverseCDFImageNorm(ImageNorm):
    """Histogram-equalising norm from a tabulated CDF (no trainable
    parameters; the tables move with :meth:`to`)."""

    def __init__(self, x, cdf):
        super().__init__()
        x = torch.as_tensor(np.array(x, np.float32))
        cdf = torch.as_tensor(np.array(cdf, np.float32))
        if not x.shape == cdf.shape:
            raise ValueError(
                f"'x' and 'cdf' must have same shape, got {tuple(x.shape)} "
                f"and {tuple(cdf.shape)}"
            )
        self.x = x
        self.cdf = cdf

    @classmethod
    def from_image(cls, image, bins=1000):
        """Build from the histogram of an image."""
        image = np.asarray(image)
        weights, x = np.histogram(image.ravel(), bins=bins)
        cdf = np.cumsum(weights)
        shifted = cdf - cdf.min()
        cdf = shifted / shifted.max()
        x_mean = (x[1:] + x[:-1]) / 2
        return cls(x=x_mean, cdf=cdf)

    def to(self, device):
        self.x, self.cdf = self.x.to(device), self.cdf.to(device)
        return self

    def __call__(self, image, params=None):
        from ..ops.image import interp1d

        return interp1d(image, self.x.to(image.device),
                        self.cdf.to(image.device))

    def _config_key(self):
        return (
            type(self).__name__,
            self.x.cpu().numpy().tobytes(),
            self.cdf.cpu().numpy().tobytes(),
        )

    def to_dict(self):
        """The tabulated CDF (the JAX package's format)."""
        return {
            "type": "inverse-cdf",
            "x": self.x.cpu().numpy().tolist(),
            "cdf": self.cdf.cpu().numpy().tolist(),
        }


class LogImageNorm(ImageNorm):
    """Logarithmic norm with trainable alpha."""

    _param_names = ("alpha",)

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def __call__(self, image, params=None):
        return torch.log(image / self._get(params, "alpha", image.device))

    def inverse(self, image, params=None):
        return self._get(params, "alpha", image.device) * torch.exp(image)


class PowerImageNorm(ImageNorm):
    """Power-law norm with trainable alpha; ``beta`` is fixed."""

    _param_names = ("alpha",)

    def __init__(self, alpha=1.0, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def __call__(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        return torch.pow(image / self.beta, alpha)

    def inverse(self, image, params=None):
        alpha = self._get(params, "alpha", image.device)
        return self.beta * torch.pow(image, 1.0 / alpha)

    def _config_key(self):
        return super()._config_key() + (float(self.beta),)

    def to_dict(self):
        data = super().to_dict()
        data["beta"] = float(self.beta)
        return data


NORMS_REGISTRY = {
    "max": MaxImageNorm,
    "fixed-max": FixedMaxImageNorm,
    "sigmoid": SigmoidImageNorm,
    "atan": ATanImageNorm,
    "inverse-cdf": InverseCDFImageNorm,
    "asinh": ASinhImageNorm,
    "log": LogImageNorm,
    "power": PowerImageNorm,
    "identity": IdentityImageNorm,
}

NORMS_PATCH_REGISTRY = {
    "std-subtract-mean": StandardizedSubtractMeanPatchNorm,
    "subtract-mean": SubtractMeanPatchNorm,
}
