"""The prior layer's image, patch and FFT ops in the port against
``jolideco_tpu``.

Patch extractions and counts are exact (the same float32 values
gathered); the subpixel spin, the interpolated spin and the FFT
convolution rtol 1e-6 with a floor of 1e-6 of the max-abs (float32 sums
in other orders), the spins' image gradient likewise.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from jolideco_torch.ops import fft as tfft
from jolideco_torch.ops import image as timage
from jolideco_torch.ops import patches as tpatch
from jolideco_tpu.ops import fft as jfft
from jolideco_tpu.ops import image as jimage
from jolideco_tpu.ops import patches as jpatch

torch.set_num_threads(1)


def image(shape, seed=0):
    return np.random.RandomState(seed).uniform(
        0.1, 2.0, shape).astype(np.float32)


def close(got, want, rel=1e-6):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("stride", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("shape", [(40, 64), (37, 29)])
def test_overlapping_patches_any_stride(shape, stride):
    x = image(shape)
    got = tpatch.view_as_overlapping_patches(torch.as_tensor(x), (8, 8),
                                             stride).numpy()
    assert_array_equal(got, np.asarray(jpatch.view_as_overlapping_patches(
        jnp.asarray(x), (8, 8), stride)))


@pytest.mark.parametrize("shape", [(40, 64), (37, 29)])
def test_grouped_corners_groups_and_reconstruction(shape):
    x = image(shape)
    xt = torch.as_tensor(x)
    corners = tpatch.grouped_patch_corners(shape, (8, 8), 4)
    assert_array_equal(corners, jpatch.grouped_patch_corners(shape, (8, 8),
                                                             4))
    grouped = tpatch.view_as_overlapping_patches_grouped(xt, (8, 8), 4)
    assert len(corners) == grouped.shape[0] == \
        tpatch.count_overlapping_patches(shape, (8, 8), 4) == \
        jpatch.count_overlapping_patches(shape, (8, 8), 4)
    assert_array_equal(grouped.numpy(), tpatch.extract_patches_at(
        xt, torch.as_tensor(corners[:, 0]), torch.as_tensor(corners[:, 1]),
        (8, 8)).numpy())
    for group in range(4):
        got, n_kept = tpatch.view_as_single_group_patches(
            xt, (8, 8), 4, group, pad_value=-2e5)
        want, n_want = jpatch.view_as_single_group_patches(
            jnp.asarray(x), (8, 8), 4, group, pad_value=-2e5)
        assert n_kept == int(n_want)
        assert_array_equal(got.numpy(), np.asarray(want))
    patches = image((len(corners), 8, 8), seed=3)
    assert_array_equal(
        tpatch.reconstruct_from_overlapping_patches_at(patches, corners,
                                                       shape),
        jpatch.reconstruct_from_overlapping_patches_at(patches, corners,
                                                       shape))


@pytest.mark.parametrize("shape", [(40, 64), (64, 36)])
def test_jittered_patches(shape):
    """The separable gather against the JAX package's gather at the same
    drawn jitters, and against the port's own per-pixel gather."""
    x = image(shape)
    key = jax.random.PRNGKey(6)
    want = jpatch.view_as_random_overlapping_patches(key, jnp.asarray(x),
                                                     (8, 8), 4)
    idy_j, idx_j = jpatch.random_patch_indices(key, shape, (8, 8), 4)
    kx, ky = jax.random.split(key)
    n_y, n_x = len(np.arange(4, shape[0] - 8, 4)), len(
        np.arange(4, shape[1] - 8, 4))
    jitter_x = np.array(jax.random.randint(kx, (n_x,), -4, 5))
    jitter_y = np.array(jax.random.randint(ky, (n_y,), -4, 5))
    xt = torch.as_tensor(x)
    got = tpatch.view_as_random_overlapping_patches(xt, (8, 8), 4, jitter_y,
                                                    jitter_x)
    assert_array_equal(got.numpy(), np.asarray(want))
    idy, idx = tpatch.random_patch_indices(shape, (8, 8), 4, jitter_y,
                                           jitter_x)
    assert_array_equal(idy.numpy(), np.asarray(idy_j))
    assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert_array_equal(tpatch.extract_patches_at(xt, idy, idx, (8, 8))
                       .numpy(), got.numpy())
    assert tpatch.count_random_patches(shape, (8, 8), 4) == got.shape[0]

    weights = image(tuple(got.shape), seed=2)
    g_j = jax.grad(lambda im: jnp.sum(jpatch.view_as_random_overlapping_patches(
        key, im, (8, 8), 4) * weights))(jnp.asarray(x))
    xg = xt.clone().requires_grad_(True)
    torch.sum(tpatch.view_as_random_overlapping_patches(
        xg, (8, 8), 4, jitter_y, jitter_x) * torch.as_tensor(weights)
    ).backward()
    close(xg.grad.numpy(), g_j)


def test_subpixel_spin_and_grid_weights():
    key = jax.random.PRNGKey(12)
    x = image((1, 1, 24, 30))
    kx, ky = jax.random.split(key)
    x0 = float(jax.random.uniform(kx, ()) - 0.5)
    y0 = float(jax.random.uniform(ky, ()) - 0.5)
    weights = image((1, 1, 24, 30), seed=4)
    out_j = jimage.cycle_spin_subpixel(key, jnp.asarray(x))
    g_j = jax.grad(lambda im: jnp.sum(jimage.cycle_spin_subpixel(key, im)
                                      * weights))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out_t = timage.cycle_spin_subpixel(xt, x0, y0)
    close(out_t.detach().numpy(), out_j)
    torch.sum(out_t * torch.as_tensor(weights)).backward()
    close(xt.grad.numpy(), g_j)

    grid = np.arange(-1, 2, dtype=np.float32)
    yy, xx = np.meshgrid(grid, grid, indexing="ij")
    close(timage.grid_weights(torch.as_tensor(xx), torch.as_tensor(yy),
                              0.3, -0.2).numpy(),
          jimage.grid_weights(jnp.asarray(xx), jnp.asarray(yy), 0.3, -0.2))
    draws = [timage.draw_subpixel(torch.Generator().manual_seed(s))
             for s in range(20)]
    assert all(-0.5 <= v < 0.5 for pair in draws for v in pair)


def test_cycle_spin_interp():
    key = jax.random.PRNGKey(2)
    x = image((1, 1, 20, 24))
    want, shifts_j = jimage.cycle_spin_interp(key, jnp.asarray(x), (8, 8),
                                              scale=2.0)
    shifts = tuple(float(v) for v in np.asarray(shifts_j) / 2.0)
    got, shifts_t = timage.cycle_spin_interp(torch.as_tensor(x), (8, 8),
                                             shifts=shifts, scale=2.0)
    close(got.numpy(), want)
    close(shifts_t.numpy(), shifts_j)
    _, drawn = timage.cycle_spin_interp(torch.as_tensor(x), (8, 8),
                                        generator=torch.Generator())
    assert bool((drawn.abs() <= 2).all())


@pytest.mark.parametrize("kernel_size", [3, 7, 17])
def test_convolve_fft(kernel_size):
    from jolideco_torch.utils.kernels import gaussian_kernel_2d

    x = image((1, 1, 40, 52))
    kernel = gaussian_kernel_2d(kernel_size / 8.0, x_size=kernel_size)
    kernel = kernel.astype(np.float32)[None, None]
    want = jfft.convolve_fft(jnp.asarray(x), jnp.asarray(kernel))
    got = tfft.convolve_fft(torch.as_tensor(x), torch.as_tensor(kernel))
    close(got.numpy(), want)
