"""Split-float building block (the JAX package's ``ops/splitfp.py``).

A float32 tensor ``x`` splits into a bf16-representable high part
``bf16_round(x)`` and the low residual ``x - bf16_round(x)``; products of
the parts, summed in float32, give float32-grade products from bf16
operands (``ops/fft_mxu.py``, ``ops/ct_conv.py``, and the precision
dial's ``"split"`` mode, ``ops.linalg.bf16_split``).
"""

import torch

__all__ = ["bf16_round"]

# the matrix DFTs' precisions: split-float products, or float32 ones
PRECISIONS = ("split3", "highest")


def bf16_round(x):
    """Round a float tensor to bf16 precision (to nearest even), returned
    in its own dtype: float32 for float32, as in the JAX package.

    PyTorch runs the round trip as written, so it needs no counterpart of
    the JAX version's ``optimization_barrier``, which stops XLA from
    eliding it. Its gradient, as there, is the cotangent rounded to bf16.
    """
    return x.to(torch.bfloat16).to(x.dtype)


def check_precision(precision):
    """Raise ``ValueError`` unless ``precision`` is one of
    :data:`PRECISIONS`."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
