"""Stacked Poisson loss of the port against ``jolideco_tpu`` (conv "fft").

4 observations (the JAX package pair-packs them) and 3 (two packed, one
odd tail through the single rFFT). The port runs one batched rFFT per
observation, which has the same semantics. 64² counts, PSFs of two
sizes (9² and 7²), float32 on the CPU. Tolerance: rtol 1e-5 for the
per-observation losses and for the flux gradient.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from jolideco_torch import FluxComponents as TFluxComponents
from jolideco_torch import SpatialFluxComponent as TComponent
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_torch.utils.kernels import gaussian_kernel_2d
from jolideco_tpu import FluxComponents as JFluxComponents
from jolideco_tpu import SpatialFluxComponent as JComponent
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

torch.set_num_threads(1)
RTOL = 1e-5
SIZE = 64


def make_datasets(n_obs, seed=0):
    rs = np.random.RandomState(seed)
    truth = rs.gamma(2.0, 1.0, (SIZE, SIZE)).astype(np.float32)
    datasets = {}
    for i in range(n_obs):
        psf_size = 9 if i % 2 == 0 else 7
        psf = gaussian_kernel_2d(1.2 + 0.3 * i, x_size=psf_size,
                                 y_size=psf_size).astype(np.float32)
        exposure = rs.uniform(0.8, 1.5, (SIZE, SIZE)).astype(np.float32)
        background = np.full((SIZE, SIZE), 0.5, np.float32)
        counts = rs.poisson(background + truth * exposure).astype(np.float32)
        datasets[f"obs-{i}"] = {"counts": counts, "psf": psf,
                                "exposure": exposure,
                                "background": background}
    return datasets


@pytest.mark.parametrize("n_obs", [4, 3])
def test_losses_and_flux_gradient(n_obs):
    datasets = make_datasets(n_obs)
    flux = np.random.RandomState(9).uniform(0.5, 2.0, (SIZE, SIZE)).astype(
        np.float32
    )

    j_comps = JFluxComponents({"flux": JComponent.from_numpy(flux)})
    j_loss = JStacked.from_datasets(datasets, j_comps, conv_mode="fft")
    f_j = jnp.asarray(flux)[None, None]
    losses_j = np.asarray(j_loss.evaluate((f_j,)))
    grad_j = np.asarray(jax.grad(lambda f: j_loss((f,)))(f_j))

    t_comps = TFluxComponents({"flux": TComponent.from_numpy(flux)})
    t_loss = TStacked.from_datasets(datasets, t_comps, conv_mode="fft",
                                    device="cpu")
    f_t = torch.as_tensor(flux)[None, None].requires_grad_(True)
    losses_t = t_loss.evaluate((f_t,))
    t_loss((f_t,)).backward()

    assert t_loss.fft_shape == j_loss.fft_shape
    assert_allclose(losses_t.detach().numpy(), losses_j, rtol=RTOL)
    assert_allclose(f_t.grad.numpy(), grad_j, rtol=RTOL,
                    atol=1e-6 * float(np.abs(grad_j).max()))


def test_unported_conv_modes_raise():
    """Every conv mode of the JAX package is ported (values against it:
    ``tests/test_torch_conv_modes.py``); the loss records it, and a mode
    the JAX package does not document raises ``ValueError``."""
    datasets = make_datasets(2)
    comps = TFluxComponents(
        {"flux": TComponent.from_numpy(np.ones((SIZE, SIZE), np.float32))}
    )
    for mode in ("ct", "mxu", "direct"):
        loss = TStacked.from_datasets(datasets, comps, conv_mode=mode,
                                      device="cpu")
        assert loss.conv_mode == mode
    with pytest.raises(ValueError, match="conv_mode"):
        TStacked.from_datasets(datasets, comps, conv_mode="cufft",
                               device="cpu")
