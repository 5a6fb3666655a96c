"""Image-space ops (the JAX package's ``ops/image.py``): sum pool, cycle spin."""

import torch

__all__ = ["cycle_spin", "sum_pool"]


def sum_pool(image, factor):
    """Flux-conserving downsampling: sum over ``factor²`` blocks."""
    if not factor or factor == 1:
        return image
    h, w = image.shape[-2], image.shape[-1]
    lead = image.shape[:-2]
    x = image.reshape(lead + (h // factor, factor, w // factor, factor))
    return x.sum(dim=(-3, -1))


def cycle_spin(image, patch_shape, generator=None, shifts=None):
    """Integer cyclic roll of up to ``patch // 4`` pixels per axis.

    Draws ``(shift_y, shift_x)`` uniformly from ``[-p//4, p//4]`` with
    ``generator`` (a CPU ``torch.Generator``, so drawing never waits on
    the device), or takes explicit ``shifts`` so that tests can inject
    the shifts the JAX package's ``ops.image.cycle_spin`` drew.

    Returns
    -------
    image : tensor
        Rolled image.
    shifts : tuple of int
        The ``(shift_y, shift_x)`` applied.
    """
    if shifts is None:
        x_max, y_max = patch_shape
        x_width, y_width = x_max // 4, y_max // 4
        shift_x = int(torch.randint(-x_width, x_width + 1, (),
                                    generator=generator))
        shift_y = int(torch.randint(-y_width, y_width + 1, (),
                                    generator=generator))
        shifts = (shift_y, shift_x)
    shifts = (int(shifts[0]), int(shifts[1]))
    return torch.roll(image, shifts=shifts, dims=(-2, -1)), shifts
