"""The port's image and patch norms and ``interp1d`` against ``jolideco_tpu``.

Each of the eleven norms: forward, inverse (where the JAX package has
one) and the autograd gradient of a weighted sum, with respect to the
image and the trainable parameters, against ``jax.grad``, all rtol 1e-6
(float32 elementwise functions; the two packages' libm may differ in
the last bit); ``to_dict`` equal to the JAX package's dict, the
``from_dict`` round trip, and ``frozen``.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_torch.utils.norms as tn
import jolideco_tpu.utils.norms as jn
from jolideco_torch.ops.image import interp1d as t_interp1d
from jolideco_tpu.ops.image import interp1d as j_interp1d

torch.set_num_threads(1)

RTOL = 1e-6


def cdf_table():
    rs = np.random.RandomState(3)
    return jn.InverseCDFImageNorm.from_image(rs.gamma(2.0, 0.5, 4000),
                                             bins=50)


NORMS = {
    "identity": ({}, 0.1, 2.0),
    "max": ({}, 0.1, 2.0),
    "fixed-max": ({"max_value": 1.7}, 0.1, 2.0),
    "sigmoid": ({"alpha": 0.8, "beta": 1.3}, 0.05, 0.95),
    "atan": ({"alpha": 0.6}, 0.05, 0.95),
    "asinh": ({"alpha": 0.7, "beta": 2.5}, 0.1, 2.0),
    "log": ({"alpha": 0.9}, 0.1, 2.0),
    "power": ({"alpha": 0.7, "beta": 1.4}, 0.1, 2.0),
    "inverse-cdf": (None, 0.0, 3.0),
}


def norm_pair(name):
    kwargs, lo, hi = NORMS[name]
    if name == "inverse-cdf":
        norm_j = cdf_table()
        norm_t = tn.InverseCDFImageNorm(np.asarray(norm_j.x),
                                        np.asarray(norm_j.cdf))
    else:
        norm_j = jn.NORMS_REGISTRY[name](**kwargs)
        norm_t = tn.NORMS_REGISTRY[name](**kwargs)
    return norm_j, norm_t, lo, hi


def image(lo, hi, seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(lo, hi, size=(1, 1, 12, 16)).astype(np.float32)


@pytest.mark.parametrize("name", list(NORMS))
def test_image_norm_forward_inverse_and_gradient(name):
    norm_j, norm_t, lo, hi = norm_pair(name)
    x = image(lo, hi)
    weights = image(-1.0, 1.0, seed=1)

    assert_allclose(norm_t(torch.as_tensor(x)).numpy(),
                    np.asarray(norm_j(jnp.asarray(x))), rtol=RTOL, atol=1e-7)
    try:
        inv_j = np.asarray(norm_j.inverse(jnp.asarray(x)))
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            norm_t.inverse(torch.as_tensor(x))
    else:
        assert_allclose(norm_t.inverse(torch.as_tensor(x)).numpy(), inv_j,
                        rtol=RTOL, atol=1e-7)

    params_j = norm_j.parameters()
    params_t = norm_t.parameters()
    assert sorted(params_j) == sorted(params_t)
    for key, value in params_t.items():
        assert tuple(value.shape) == (1,) == params_j[key].shape
        assert value.dtype == torch.float32

    grads_j = jax.grad(
        lambda im, p: jnp.sum(norm_j(im, params=p) * weights),
        argnums=(0, 1))(jnp.asarray(x), params_j)
    xt = torch.as_tensor(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params_t.items()}
    torch.sum(norm_t(xt, params=leaves) * torch.as_tensor(weights)).backward()
    g = np.asarray(grads_j[0])
    assert_allclose(xt.grad.numpy(), g, rtol=RTOL,
                    atol=1e-6 * float(np.abs(g).max()))
    for key, leaf in leaves.items():
        assert_allclose(leaf.grad.numpy(), np.asarray(grads_j[1][key]),
                        rtol=1e-5)


@pytest.mark.parametrize("name", list(NORMS))
def test_image_norm_dict_round_trip_and_frozen(name):
    norm_j, norm_t, _, _ = norm_pair(name)
    data = norm_t.to_dict()
    assert data == norm_j.to_dict()
    back = tn.ImageNorm.from_dict(data)
    assert type(back) is type(norm_t) and back == norm_t
    assert back.to_dict() == data
    if name in ("inverse-cdf", "identity", "max"):
        assert norm_t.parameters() == {}
        return
    kwargs = dict(NORMS[name][0], frozen=True)
    frozen = tn.NORMS_REGISTRY[name](**kwargs)
    assert frozen.parameters() == {} == jn.NORMS_REGISTRY[name](
        **kwargs).parameters()
    assert frozen != norm_t
    x = torch.as_tensor(image(0.1, 0.9))
    torch.testing.assert_close(frozen(x), norm_t(x), rtol=0, atol=0)


def test_set_parameters_writes_floats_back():
    norm = tn.ASinhImageNorm(alpha=0.5, beta=2.0)
    x = torch.as_tensor(image(0.1, 2.0))
    before = norm(x)
    norm.set_parameters({"alpha": torch.tensor([0.25]),
                         "beta": torch.tensor([3.0])})
    assert (norm.alpha, norm.beta) == (0.25, 3.0)
    expected = tn.ASinhImageNorm(alpha=0.25, beta=3.0)(x)
    torch.testing.assert_close(norm(x), expected, rtol=0, atol=0)
    assert not torch.equal(norm(x), before)


@pytest.mark.parametrize("name", ["subtract-mean", "std-subtract-mean"])
def test_patch_norms(name):
    rs = np.random.RandomState(4)
    patches = rs.uniform(0.2, 2.0, (50, 16)).astype(np.float32)
    norm_j = jn.NORMS_PATCH_REGISTRY[name]()
    norm_t = tn.NORMS_PATCH_REGISTRY[name]()
    assert_allclose(norm_t(torch.as_tensor(patches)).numpy(),
                    np.asarray(norm_j(jnp.asarray(patches))), rtol=RTOL,
                    atol=1e-6)
    weights = rs.randn(50, 16).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda p: jnp.sum(norm_j(p) * weights))(
        jnp.asarray(patches)))
    pt = torch.as_tensor(patches).requires_grad_(True)
    torch.sum(norm_t(pt) * torch.as_tensor(weights)).backward()
    assert_allclose(pt.grad.numpy(), g_j, rtol=RTOL,
                    atol=1e-6 * float(np.abs(g_j).max()))
    assert norm_t.to_dict() == norm_j.to_dict() == {"type": name}
    assert tn.PatchNorm.from_dict(norm_t.to_dict()) == norm_t
    with pytest.raises(NotImplementedError):
        norm_t.inverse(torch.as_tensor(patches))


def test_interp1d_matches_the_jax_arithmetic():
    """Below, inside and above a linear table (JAX's own numbers), then
    a table that is not linear."""
    xp = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    x = np.array([-1.0, 0.0, 0.5, 2.5, 3.0, 4.0], np.float32)
    got = t_interp1d(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(10 * xp)).numpy()
    assert_allclose(got, [-10.0, 0.0, 5.0, 25.0, 30.0, 40.0], rtol=1e-6)
    assert_allclose(got, np.asarray(j_interp1d(
        jnp.asarray(x), jnp.asarray(xp), jnp.asarray(10 * xp))), rtol=1e-6)

    xp = np.array([0.0, 0.5, 1.5, 3.0, 3.2], np.float32)
    fp = np.array([0.0, 0.1, 0.7, 0.8, 1.0], np.float32)
    x = np.array([-0.7, 0.0, 0.2, 0.5, 1.0, 2.9, 3.1, 3.2, 5.0], np.float32)
    got = t_interp1d(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(fp)).numpy()
    assert_allclose(got, np.asarray(j_interp1d(
        jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))), rtol=1e-6,
        atol=1e-7)


def test_norms_registry_names():
    assert list(tn.NORMS_REGISTRY) == list(jn.NORMS_REGISTRY)
    assert list(tn.NORMS_PATCH_REGISTRY) == list(jn.NORMS_PATCH_REGISTRY)
