"""Upsampled flux components in the port against ``jolideco_tpu``.

The image ops (``upsample_bilinear``, ``shift_image``, ``rescale_image``),
the upsampled and ``psf_scale``-zoomed kernel build, ``NPredModel`` at
``upsampling_factor=2``, and ``SpatialFluxComponent``'s upsampling
constructors and data-resolution fluxes, on the same numpy inputs made
from seeds. Tolerances, each with its reason:

- bilinear resampling and the warps: 1e-6 of the input's max-abs (the
  same float32 coordinates, weights rounded in other orders; 5.4e-7
  measured);
- the warps' image gradient 1e-6 of its max-abs, the shift's gradient
  rtol 1e-5 (a sum over every pixel in another order; 6e-7 measured),
  at shifts 0 and ±1 too, where both take the forward difference;
- the kernel build, ``NPredModel`` and its gradient: 1e-6 of the
  max-abs (float32 FFTs of the same kernels);
- the components: exact where both copy or sum the same float32 values,
  1e-6 where the upsampling rounds.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.models import NPredModel
from jolideco_torch.ops import fft as tfft
from jolideco_torch.ops import image as timage
from jolideco_torch.utils.kernels import gaussian_kernel_2d
from jolideco_tpu.models import NPredModel as JNPredModel
from jolideco_tpu.ops import fft as jfft
from jolideco_tpu.ops import image as jimage

torch.set_num_threads(1)
SHAPES = [(16, 16), (15, 17)]
SHIFTS = [0.0, 1.0, -1.0, 0.37, -0.37, 2.6]


def image(shape, seed=0):
    return np.random.RandomState(seed).uniform(
        0.1, 1.0, (1, 1) + shape).astype(np.float32)


def close(got, want, rel=1e-6):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=0,
                    atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("factor", [2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=["even", "odd"])
def test_upsample_bilinear_matches_jax(shape, factor):
    x = image(shape)
    got = timage.upsample_bilinear(torch.as_tensor(x), factor)
    want = jimage.upsample_bilinear(jnp.asarray(x), factor)
    assert tuple(got.shape) == want.shape
    close(got.numpy(), want)
    # flux-conserving back to the data grid: the block means are the image
    close(timage.avg_pool(got, factor).numpy(),
          jimage.avg_pool(want, factor))


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("shift", SHIFTS)
def test_shift_image_value_and_gradients_match_jax(shift, scale):
    x = image((15, 17), seed=1)
    shift_xy = np.array([[shift, -0.5 * shift]], np.float32)
    weights = np.random.RandomState(2).normal(size=x.shape).astype(np.float32)

    def loss_j(im, s):
        return jnp.sum(jimage.shift_image(im, s, scale=scale) * weights)

    value_j = jimage.shift_image(jnp.asarray(x), jnp.asarray(shift_xy),
                                 scale=scale)
    grad_im_j, grad_s_j = jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(shift_xy))

    im = torch.as_tensor(x).requires_grad_(True)
    s = torch.as_tensor(shift_xy).requires_grad_(True)
    value_t = timage.shift_image(im, s, scale=scale)
    (value_t * torch.as_tensor(weights)).sum().backward()

    close(value_t.detach().numpy(), value_j)
    close(im.grad.numpy(), grad_im_j)
    assert_allclose(s.grad.numpy(), np.asarray(grad_s_j), rtol=1e-5)
    # the batched form stacks the single shifts
    stack = timage.shift_images(torch.as_tensor(x),
                                torch.as_tensor(np.stack([shift_xy] * 2)),
                                scale=scale)
    assert_array_equal(stack[1].numpy(), value_t.detach().numpy())


@pytest.mark.parametrize("factor", [0.8, 1.3])
def test_rescale_image_matches_jax(factor):
    x = image((15, 17), seed=3)
    close(timage.rescale_image(torch.as_tensor(x), factor).numpy(),
          jimage.rescale_image(jnp.asarray(x), factor))
    assert timage.maybe_rescale_image(x, 1.0) is x


def test_kernel_build_upsampled_and_zoomed_matches_jax():
    psfs = [gaussian_kernel_2d(1.0 + 0.4 * i, x_size=5 + 2 * (i % 2),
                               y_size=5 + 2 * (i % 2)).astype(np.float32)
            for i in range(3)]
    kmax, scales = (14, 14), np.array([1.0, 1.2, 0.9], np.float32)
    exposures = np.stack([np.full((8, 8), 1 + 0.1 * i, np.float32)
                          for i in range(3)])[:, None, None]
    padded_t, padded_j = [], []
    for scale_values in (None, scales):
        got, want = [], []
        for i, psf in enumerate(psfs):
            k = psf[None, None, None]
            s = None if scale_values is None else scale_values[i:i + 1]
            got.append(tfft.upsample_center_pad_kernels(
                torch.as_tensor(k), factor=2, out_shape=kmax,
                scales=s)[0])
            want.append(jfft.upsample_center_pad_kernels(
                jnp.asarray(k), factor=2, out_shape=kmax,
                scales=None if s is None else jnp.asarray(s))[0])
        padded_t.append(torch.stack(got))
        padded_j.append(jnp.stack(want))
        close(padded_t[-1].numpy(), padded_j[-1])
    fft_shape = (16 + 14 - 1,) * 2
    kft_t, exp_t = tfft.build_kernel_stack(
        padded_t[0], torch.as_tensor(exposures), factor=2,
        fft_shape=fft_shape, correct_edges=True, conv_kernels=padded_t[1])
    kft_j, exp_j, _, _ = jfft.build_kernel_stack(
        padded_j[0], jnp.asarray(exposures), factor=2, fft_shape=fft_shape,
        correct_edges=True, n_pairs=0, conv_kernels=padded_j[1])
    close(exp_t.numpy(), exp_j)
    kft_j = np.asarray(kft_j)
    scale = float(np.abs(kft_j).max())
    for part in ("real", "imag"):
        assert_allclose(getattr(kft_t, part).numpy(), getattr(kft_j, part),
                        rtol=0, atol=1e-6 * scale)


def test_npred_model_factor_2_with_psf_scale_matches_jax():
    rs = np.random.RandomState(4)
    exposure = rs.uniform(0.8, 1.2, (16, 16)).astype(np.float32)
    psf = gaussian_kernel_2d(1.3, x_size=7, y_size=7).astype(np.float32)
    flux = rs.uniform(0.5, 2.0, (1, 1, 32, 32)).astype(np.float32)
    weights = rs.normal(size=(1, 1, 16, 16)).astype(np.float32)
    model_j = JNPredModel.from_numpy(exposure, psf, upsampling_factor=2)
    model_t = NPredModel.from_numpy(exposure, psf, upsampling_factor=2,
                                    device="cpu")
    close(model_t.exposure.numpy(), model_j.exposure)
    close(model_t.psf.numpy(), model_j.psf)
    assert model_t.shape == model_j.shape == (1, 1, 16, 16)
    for psf_scale in (None, 1.2):
        value_j, grad_j = jax.value_and_grad(lambda f: jnp.sum(
            model_j(f, psf_scale=psf_scale) * weights))(jnp.asarray(flux))
        f = torch.as_tensor(flux).requires_grad_(True)
        value_t = (model_t(f, psf_scale=psf_scale)
                   * torch.as_tensor(weights)).sum()
        value_t.backward()
        assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
        close(f.grad.numpy(), grad_j)
        close(model_t(torch.as_tensor(flux), psf_scale).numpy(),
              model_j(jnp.asarray(flux), psf_scale=psf_scale))
    # the zoomed spectrum is made once
    assert list(model_t._scaled_psf_ffts) == [1.2]


def test_upsampled_component_matches_jax():
    rs = np.random.RandomState(5)
    flux = rs.uniform(0.5, 2.0, (12, 12)).astype(np.float32)
    mask = rs.uniform(size=(12, 12)) > 0.3
    comp_j = jj.SpatialFluxComponent.from_numpy(flux, mask=mask,
                                                upsampling_factor=2)
    comp_t = jt.SpatialFluxComponent.from_numpy(flux, mask=mask,
                                                upsampling_factor=2)
    assert comp_t.upsampling_factor == comp_j.upsampling_factor == 2
    assert_array_equal(comp_t.mask.numpy(), np.asarray(comp_j.mask))
    close(comp_t.flux_upsampled_numpy, comp_j.flux_upsampled_numpy)
    close(comp_t.flux_numpy, comp_j.flux_numpy)
    comps_j = jj.FluxComponents({"a": comp_j, "b": comp_j})
    comps_t = jt.FluxComponents({"a": comp_t, "b": comp_t})
    close(comps_t.flux_upsampled_total.numpy(),
          comps_j.flux_upsampled_total)
    close(comps_t.flux_total_numpy, comps_j.flux_total_numpy)
    assert set(comps_t.fluxes_numpy) == {"a", "b"}
    close(comps_t.fluxes_numpy["a"], comps_j.fluxes_numpy["a"])


@pytest.mark.parametrize("use_log_flux", [True, False])
def test_from_flux_init_datasets_matches_jax(use_log_flux):
    rs = np.random.RandomState(6)
    datasets = [{"counts": rs.poisson(3.0, (10, 10)).astype(np.float32),
                 "exposure": np.full((10, 10), 1.5, np.float32),
                 "background": np.ones((10, 10), np.float32)}
                for _ in range(3)]
    want = jj.SpatialFluxComponent.from_flux_init_datasets(
        datasets, upsampling_factor=2, use_log_flux=use_log_flux)
    got = jt.SpatialFluxComponent.from_flux_init_datasets(
        datasets, upsampling_factor=2, use_log_flux=use_log_flux)
    flux = got.flux_upsampled_numpy
    # under the log, over-subtracted pixels are clipped to the smallest
    # positive value; without it they stay negative
    assert (flux > 0).all() == use_log_flux
    close(flux, want.flux_upsampled_numpy)
    assert_allclose(got.parameters()["flux"].numpy(),
                    np.asarray(want.parameters()["flux"]), rtol=0,
                    atol=1e-6)
