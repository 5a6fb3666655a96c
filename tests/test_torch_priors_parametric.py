"""The port's parametric priors, LIRA, ``Priors`` and ``PRIOR_REGISTRY``
against ``jolideco_tpu``.

Values rtol 1e-5 and flux gradients to 1e-5 of their max-abs (float32
sums in other orders; the smoothness prior's FFT convolutions are
torch's and XLA's). A subpixel spin is injected as the offsets the JAX
package draws from the same key.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch.priors as tp
import jolideco_tpu.priors as jp

torch.set_num_threads(1)


def jax_subpix(key):
    """The ``(x0, y0)`` ``cycle_spin_subpixel(key, ...)`` draws."""
    kx, ky = jax.random.split(key)
    return (float(jax.random.uniform(kx, ()) - 0.5),
            float(jax.random.uniform(ky, ()) - 0.5))


def flux(shape=(1, 1, 24, 32), seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(0.2, 3.0, size=shape).astype(np.float32)


def value_and_grad(prior_j, prior_t, x, key=None, shifts=None):
    value_j, grad_j = jax.value_and_grad(lambda f: prior_j(f, key=key))(
        jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    value_t = prior_t(xt, shifts=shifts)
    value_t.backward()
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(xt.grad.numpy(), grad_j, rtol=0,
                    atol=1e-5 * float(np.abs(grad_j).max()))


CASES = {
    "inverse-gamma": lambda m, s: m.InverseGammaPrior(alpha=3.0, beta=0.8,
                                                      cycle_spin_subpix=s),
    "exponential": lambda m, s: m.ExponentialPrior(alpha=2.5,
                                                   cycle_spin_subpix=s),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("subpix", [False, True])
def test_sparsity_priors(name, subpix):
    key = jax.random.PRNGKey(7)
    prior_j, prior_t = CASES[name](jp, subpix), CASES[name](tp, subpix)
    value_and_grad(prior_j, prior_t, flux(), key=key,
                   shifts=jax_subpix(key) if subpix else None)
    assert_allclose(float(prior_t.log_constant_term),
                    float(prior_j.log_constant_term), rtol=1e-6)
    assert_allclose(prior_t.mean.numpy(), np.asarray(prior_j.mean),
                    rtol=1e-6)


@pytest.mark.parametrize("width", [1.0, 2.0])
def test_smoothness_prior(width):
    value_and_grad(jp.SmoothnessPrior(width=width),
                   tp.SmoothnessPrior(width=width), flux())


def test_image_prior():
    target, error = flux(seed=1), flux(seed=2)
    value_and_grad(jp.ImagePrior(target, error), tp.ImagePrior(target, error),
                   flux())
    value_and_grad(jp.ImagePrior(target), tp.ImagePrior(target), flux())


@pytest.mark.parametrize("spin", [False, True])
def test_lira_prior(spin):
    from jolideco_tpu.ops.image import cycle_spin

    key = jax.random.PRNGKey(3)
    alphas = (2.0, 1.5, 3.0)
    shifts = None
    if spin:
        _, sub = jax.random.split(key)
        _, drawn = cycle_spin(sub, jnp.zeros((4, 4)), patch_shape=(2, 2))
        shifts = tuple(int(s) for s in np.asarray(drawn))
    value_and_grad(jp.LIRAPrior(alphas, cycle_spin=spin),
                   tp.LIRAPrior(alphas, cycle_spin=spin), flux((1, 1, 32, 48)),
                   key=key, shifts=shifts)


def test_priors_sum_and_registry():
    assert list(tp.PRIOR_REGISTRY) == list(jp.PRIOR_REGISTRY)
    key = jax.random.PRNGKey(1)
    fa, fb = flux(seed=3), flux(seed=4)
    priors_j = jp.Priors(a=jp.SmoothnessPrior(1.0), b=jp.ExponentialPrior())
    priors_t = tp.Priors(a=tp.SmoothnessPrior(1.0), b=tp.ExponentialPrior())
    value_j = priors_j((jnp.asarray(fa), jnp.asarray(fb)),
                       keys=jax.random.split(key, 2))
    value_t = priors_t((torch.as_tensor(fa), torch.as_tensor(fb)))
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)


@pytest.mark.parametrize("make", [
    lambda m: m.UniformPrior(),
    lambda m: m.SmoothnessPrior(width=1.5),
    lambda m: m.InverseGammaPrior(alpha=4, beta=2, cycle_spin_subpix=True),
    lambda m: m.ExponentialPrior(alpha=3),
    lambda m: m.LIRAPrior((1.0, 2.0), cycle_spin=False),
], ids=["uniform", "smooth", "inverse-gamma", "exponential", "lira"])
def test_prior_dicts_match_and_round_trip(make):
    data = make(tp).to_dict()
    assert data == make(jp).to_dict()
    back = tp.Prior.from_dict(data)
    assert type(back) is type(make(tp)) and back.to_dict() == data


def test_image_prior_has_no_dict():
    with pytest.raises(NotImplementedError):
        tp.ImagePrior(flux()).to_dict()
