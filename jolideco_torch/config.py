"""Runtime configuration: device resolution, kernel dispatch, precision.

Counterpart of the JAX package's ``config.py``. Three things live here:

- :func:`resolve_device` turns a user's ``device`` argument into a
  ``torch.device`` (``None`` picks the first CUDA card when there is
  one, else the CPU). There is no global device: every entry point
  takes its own ``device`` argument.
- :func:`dispatch` is the kernel dispatch rule. A tensor on a CUDA
  card goes to the hand-written kernel, a tensor on the CPU to the
  kernel's plain PyTorch version. Nothing falls back: a kernel that
  cannot build or launch raises.
- The precision dial (``"highest" | "high" | "default"``, the names of
  the JAX package's ``config.set_gmm_precision``). The CUDA kernels compute
  in full float32 whatever the dial says, which meets the strictest
  bar. At import and on every dial change the float32 matmul and cuDNN
  paths are pinned to full float32: PyTorch lets cuDNN convolutions run
  in TF32 by default, which keeps only about three decimal digits.
"""

import torch

__all__ = [
    "dispatch",
    "gmm_precision",
    "resolve_device",
    "set_gmm_precision",
]

_PRECISIONS = ("highest", "high", "default")
_GMM_PRECISION = "high"


def _pin_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def set_gmm_precision(mode):
    """Set the GMM-scoring precision dial: highest|high|default."""
    global _GMM_PRECISION
    if mode not in _PRECISIONS:
        raise ValueError(f"invalid precision mode {mode!r}")
    _GMM_PRECISION = mode
    _pin_float32()


def gmm_precision():
    """Current precision dial setting (a name, not a torch object)."""
    return _GMM_PRECISION


def resolve_device(device=None):
    """``torch.device`` for a user's ``device`` argument."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def dispatch(tensor):
    """``"kernel"`` for a CUDA tensor, ``"plain"`` for a CPU tensor."""
    kind = tensor.device.type
    if kind == "cuda":
        return "kernel"
    if kind == "cpu":
        return "plain"
    raise NotImplementedError(
        f"no kernel and no plain path for device type {kind!r}"
    )


_pin_float32()
