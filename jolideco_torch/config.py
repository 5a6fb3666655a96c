"""Runtime configuration: device resolution, kernel dispatch, precision.

Counterpart of the JAX package's ``config.py``. Four things live here:

- :func:`resolve_device` turns a user's ``device`` argument into a
  ``torch.device``. ``None`` means the first CUDA card, and raises when
  there is none: the CPU runs only when the caller asks for it
  (``device="cpu"``). There is no global device: every entry point
  takes its own ``device`` argument.
- :func:`dispatch` is the kernel dispatch rule. A tensor on a CUDA
  card goes to the hand-written kernel, a tensor on the CPU to the
  kernel's plain PyTorch version. Nothing falls back: a kernel that
  cannot build or launch raises.
- The fused-scorer switch (``"auto" | "off"``, :func:`use_fused`,
  :func:`set_use_fused`, :func:`force_fused`, :func:`fused_enabled`):
  ``"off"`` sends the GMM patch prior to its patch-level scorer, which
  the Hessian probe needs because the fused scorer has no second
  derivative.
- The precision dial (``"highest" | "high" | "default"``, the names of
  the JAX package's ``config.set_gmm_precision``), and the modes it
  names: the matmul-DFT convolution's (:func:`pfft_mode`) and the GMM
  scorers' (:func:`gmm_mode`), each ``"f32"``, ``"split"`` or
  ``"bf16"``. Under ``"split"`` (the default dial, ``"high"``) the
  matrix-DFT convolution's passes and the fused scorer's logits (its
  MAP and logsumexp forwards and its marginalise backward), and the
  logits of the Hessian probe's patch-level scorer, MAP and logsumexp,
  and of its marginalise gradient and first Hessian stage, run on the
  tensor cores as bf16 hi/lo products with float32 sums. Under
  ``"bf16"`` (the ``"default"`` setting) the same kernels take one bf16
  product each, with float32 sums: the JAX package's
  ``Precision.DEFAULT`` on the TPU. Every other kernel, and those in
  ``"f32"`` mode (``"highest"``), computes in full float32. At import
  and on every dial change the float32 matmul and cuDNN paths are
  pinned to full float32: PyTorch lets cuDNN convolutions run in TF32
  by default, which keeps only about three decimal digits.
"""

from contextlib import contextmanager

import torch

__all__ = [
    "dispatch",
    "force_fused",
    "fused_enabled",
    "gmm_mode",
    "gmm_precision",
    "pfft_mode",
    "resolve_device",
    "set_gmm_precision",
    "set_use_fused",
    "use_fused",
]

_PRECISIONS = ("highest", "high", "default")
# the JAX package's modes of its matmul-DFT convolution per dial setting:
# full float32, bf16 hi/lo splits (about 3.1e-5 of the result's max-abs),
# single bf16 products
_PFFT_MODES = {"highest": "f32", "high": "split", "default": "bf16"}
# the GMM scorers' logits per dial setting: full float32, the JAX
# package's "split3" logits (bf16 hi/lo products, about 1e-5 relative),
# or its "default" ones (single bf16 products, about 4e-3)
_GMM_MODES = {"highest": "f32", "high": "split", "default": "bf16"}
_GMM_PRECISION = "high"
_USE_FUSED = "auto"


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


def pfft_mode():
    """The matmul-DFT convolution's mode under the current dial."""
    return _PFFT_MODES[_GMM_PRECISION]


def gmm_mode():
    """The GMM scorers' mode (of their logits, MAP or marginalise, fused
    or patch-level) under the current dial."""
    return _GMM_MODES[_GMM_PRECISION]


def resolve_device(device=None):
    """``torch.device`` for a user's ``device`` argument.

    ``None`` is the first CUDA card; without one it raises instead of
    falling back to the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def use_fused():
    """Current fused-scorer switch: ``"auto"`` or ``"off"``."""
    return _USE_FUSED


def set_use_fused(mode):
    """Set the fused-scorer switch: ``"auto"`` or ``"off"``."""
    global _USE_FUSED
    if mode not in ("auto", "off"):
        raise ValueError(f"invalid fused mode {mode!r}")
    _USE_FUSED = mode


def fused_enabled():
    """Whether the GMM patch prior may take the fused scorer (shapes it
    takes are checked where it is called). The JAX package also needs its
    Pallas switch on; the port dispatches by the tensor's device
    (:func:`dispatch`), so only the fused switch decides."""
    return _USE_FUSED != "off"


@contextmanager
def force_fused(mode):
    """Set the fused-scorer switch for the duration of a ``with`` block.

    A process-wide setting, read when a prior is evaluated: not
    thread-safe.
    """
    global _USE_FUSED
    saved = _USE_FUSED
    set_use_fused(mode)
    try:
        yield
    finally:
        _USE_FUSED = saved


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
