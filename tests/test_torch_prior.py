"""GMM patch prior of the port against ``jolideco_tpu``.

The JAX prior runs with its default CPU dispatch (grouped patches and
the XLA scorer); the port takes its fused branch for the shipped 8x8
GMMs and its grouped branch for a 4x4 GMM built from random arrays.
The test learns the cycle spin JAX draws, by calling
``jolideco_tpu.ops.image.cycle_spin`` with the key the prior splits
off, and passes those shifts to the port.
Tolerances: the log-prior to rtol 1e-5; its flux gradient to 1e-5 of
its max-abs (float32 sums in different orders; JAX scores whitened
residuals where the port evaluates the expanded quadratic form).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_torch.priors import GMMPatchPrior as TPrior
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.ops.image import cycle_spin
from jolideco_tpu.priors import GaussianMixtureModel as JGMM
from jolideco_tpu.priors import GMMPatchPrior as JPrior
from jolideco_tpu.priors.patches.gmm import GaussianMixtureModelMeta

torch.set_num_threads(1)


def jax_shifts(key, patch_shape):
    key_spin = jax.random.split(key, 4)[0]
    _, shifts = cycle_spin(key_spin, jnp.zeros((8, 8)),
                           patch_shape=patch_shape)
    return tuple(int(s) for s in np.asarray(shifts))


def gmm_pair(name):
    """The same GMM in both packages: a shipped 8x8 one, or a random
    4x4 one (K = 6, stride 2) that the fused scorer does not take."""
    if name != "random-4x4":
        return JGMM.from_registry(name), TGMM.from_registry(name), 4
    rs = np.random.RandomState(2)
    means = 0.3 * rs.randn(6, 16)
    covariances = np.stack([
        a @ a.T / 16 + 0.1 * np.eye(16) for a in rs.randn(6, 16, 16)
    ])
    weights = rs.dirichlet(np.ones(6))
    gmm_j = JGMM.from_numpy(means, covariances, weights,
                            meta=GaussianMixtureModelMeta(stride=2))
    return gmm_j, gmm_from_arrays(means, covariances, weights, 2), 2


@pytest.mark.parametrize("name,shape", [
    ("builtin-8x8-v1", (32, 128)), ("astro-snr-v1", (32, 128)),
    ("builtin-8x8-v1", (40, 64)), ("astro-snr-v1", (40, 64)),
    ("random-4x4", (40, 64)),
])
@pytest.mark.parametrize("spin", [True, False])
def test_prior_value_and_gradient(name, shape, spin):
    rs = np.random.RandomState(8)
    flux = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)[None, None]
    key = jax.random.PRNGKey(5)
    gmm_j, gmm_t, stride = gmm_pair(name)

    prior_j = JPrior(gmm=gmm_j, stride=stride, cycle_spin=spin)
    value_j, grad_j = jax.value_and_grad(
        lambda f: prior_j(f, key=key)
    )(jnp.asarray(flux))

    prior_t = TPrior(gmm=gmm_t, stride=stride, cycle_spin=spin)
    assert prior_t._fused_ok(shape) == (name != "random-4x4")
    x = torch.as_tensor(flux).requires_grad_(True)
    shifts = jax_shifts(key, prior_t.patch_shape) if spin else None
    value_t = prior_t(x, shifts=shifts)
    value_t.backward()

    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-5 * float(np.abs(grad_j).max()))


def test_generator_draws_are_reproducible():
    flux = torch.rand((1, 1, 32, 128), generator=torch.Generator().manual_seed(0))
    prior = TPrior(gmm=TGMM.from_registry("builtin-8x8-v1"))
    a = prior(flux, generator=torch.Generator().manual_seed(4))
    b = prior(flux, generator=torch.Generator().manual_seed(4))
    assert a.item() == b.item()


@pytest.mark.parametrize("kwargs", [
    {"jitter": True}, {"marginalize": True}, {"patch_fraction": 0.25},
    {"cycle_spin_subpix": True},
])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        TPrior(gmm=TGMM.from_registry("builtin-8x8-v1"), **kwargs)
