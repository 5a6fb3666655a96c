"""FFT convolution of the port against ``jolideco_tpu.ops.fft``.

64² images, 9² PSFs, float32 on the CPU. Tolerances: values and VJPs
to rtol 1e-5 with an absolute floor of 1e-6 of the output's max-abs
(pocketfft in XLA and in PyTorch round differently; near-zero outputs
of a convolution carry that rounding as absolute, not relative, error).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from jolideco_torch.ops import fft as tfft
from jolideco_torch.utils.kernels import gaussian_kernel_2d
from jolideco_tpu.ops import fft as jfft

torch.set_num_threads(1)
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    """``got`` against ``want`` (complex arrays compare as such, with
    the floor taken from the largest spectrum magnitude)."""
    want = np.asarray(want)
    assert_allclose(np.asarray(got), want, rtol=rtol,
                    atol=1e-6 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def problem():
    rs = np.random.RandomState(3)
    n = 3
    kernels = np.stack([
        gaussian_kernel_2d(1.0 + 0.4 * i, x_size=9, y_size=9)
        for i in range(n)
    ]).astype(np.float32)[:, None, None]
    exposures = rs.uniform(0.5, 2.0, (n, 1, 1, 64, 64)).astype(np.float32)
    image = rs.uniform(0.0, 3.0, (n, 1, 1, 64, 64)).astype(np.float32)
    return kernels, exposures, image


@pytest.mark.parametrize("correct_edges", [True, False])
def test_build_kernel_stack(problem, correct_edges):
    kernels, exposures, _ = problem
    fft_shape = (72, 72)
    kft_t, exp_t = tfft.build_kernel_stack(
        torch.as_tensor(kernels), torch.as_tensor(exposures), factor=1,
        fft_shape=fft_shape, correct_edges=correct_edges,
    )
    kft_j, exp_j, _, _ = jfft.build_kernel_stack(
        jnp.asarray(kernels), jnp.asarray(exposures), factor=1,
        fft_shape=fft_shape, correct_edges=correct_edges, n_pairs=0,
    )
    close(kft_t.numpy(), kft_j)
    close(exp_t.numpy(), exp_j)


def test_upsample_center_pad_kernels_ragged():
    k = gaussian_kernel_2d(1.5, x_size=7, y_size=5).astype(np.float32)
    got = tfft.upsample_center_pad_kernels(
        torch.as_tensor(k)[None, None, None], factor=1, out_shape=(9, 9)
    )
    want = jfft.upsample_center_pad_kernels(
        jnp.asarray(k)[None, None, None], factor=1, out_shape=(9, 9)
    )
    assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)


def test_convolve_value_and_vjp(problem):
    kernels, _, image = problem
    fft_shape = (72, 72)
    kft_j = jfft.kernel_fft(jnp.asarray(kernels), (64, 64), fft_shape)
    kft_t = tfft.kernel_fft(torch.as_tensor(kernels), (64, 64), fft_shape)

    rs = np.random.RandomState(4)
    cot = rs.randn(*image.shape).astype(np.float32)

    x = torch.as_tensor(image).requires_grad_(True)
    out_t = tfft.convolve_fft_precomputed(x, kft_t, fft_shape)
    out_t.backward(torch.as_tensor(cot))

    out_j, vjp = jax.vjp(
        lambda im: jfft.convolve_fft_precomputed(im, kft_j, fft_shape),
        jnp.asarray(image),
    )
    (grad_j,) = vjp(jnp.asarray(cot))
    close(out_t.detach().numpy(), out_j)
    close(x.grad.numpy(), grad_j)


def test_broadcast_spectrum_cotangent_sums_back(problem):
    """A (1, 1, H, W) flux against an (N, 1, 1, ...) spectrum stack: the
    cotangent sums back over the broadcast axes, as in the JAX VJP."""
    kernels, _, image = problem
    fft_shape = (72, 72)
    kft_j = jfft.kernel_fft(jnp.asarray(kernels), (64, 64), fft_shape)
    kft_t = tfft.kernel_fft(torch.as_tensor(kernels), (64, 64), fft_shape)
    flux = image[0, 0][None, None]            # (1, 1, 64, 64)
    cot = np.random.RandomState(5).randn(3, 1, 1, 64, 64).astype(np.float32)

    x = torch.as_tensor(flux).requires_grad_(True)
    out_t = tfft.convolve_fft_precomputed(x, kft_t, fft_shape)
    out_t.backward(torch.as_tensor(cot))

    _, vjp = jax.vjp(
        lambda im: jfft.convolve_fft_precomputed(im, kft_j, fft_shape),
        jnp.asarray(flux),
    )
    (grad_j,) = vjp(jnp.asarray(cot))
    assert tuple(x.grad.shape) == flux.shape == tuple(grad_j.shape)
    close(x.grad.numpy(), grad_j)
