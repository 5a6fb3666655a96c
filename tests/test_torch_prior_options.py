"""``GMMPatchPrior``'s options in the port against ``jolideco_tpu``.

The subpixel spin, jitter, both kinds of patch subsampling (one offset
class, a random subset), strides that do not divide the patch edge, the
standardized patch norm, ``prior_image`` and ``prior_image_average`` and
``to_dict``. Every random draw is the JAX package's: ``jax_draws``
repeats the prior's key schedule (``split(key, 4)`` into spin, subpixel,
jitter and subsample keys) and the port takes the draws as ``shifts=``.
The JAX prior runs with its default CPU dispatch, as in
``test_torch_prior.py``; its tolerances: values rtol 1e-5, flux
gradients 1e-5 of their max-abs.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_torch.utils.norms as tn
import jolideco_tpu as jj
import jolideco_tpu.utils.norms as jn
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.priors.patches.gmm import (
    GaussianMixtureModelMeta as TMeta,
)
from jolideco_torch.utils.norms import (
    StandardizedSubtractMeanPatchNorm as TStd,
)
from jolideco_tpu.ops.image import cycle_spin
from jolideco_tpu.ops.patches import count_overlapping_patches
from jolideco_tpu.priors.patches.gmm import GaussianMixtureModelMeta as JMeta
from jolideco_tpu.utils.norms import StandardizedSubtractMeanPatchNorm as JStd
from test_torch_prior import gmm_pair

torch.set_num_threads(1)


def jax_draws(key, prior, shape):
    """The JAX prior's draws of one evaluation under ``key``, in the
    port's ``shifts=`` form (``prior`` is the port's twin)."""
    key_spin, key_subpix, key_jitter, key_sub = jax.random.split(key, 4)
    draws = {"spin": None}
    if prior.cycle_spin:
        _, s = cycle_spin(key_spin, jnp.zeros((8, 8)), prior.patch_shape)
        draws["spin"] = tuple(int(v) for v in np.asarray(s))
    if prior.cycle_spin_subpix:
        kx, ky = jax.random.split(key_subpix)
        draws["subpix"] = (float(jax.random.uniform(kx, ()) - 0.5),
                           float(jax.random.uniform(ky, ()) - 0.5))
    h, w = shape[-2:]
    ov, s = prior.overlap, prior.stride
    n_x = len(np.arange(ov, w - s - ov, s))
    n_y = len(np.arange(ov, h - s - ov, s))
    if prior.jitter:
        kx, ky = jax.random.split(key_jitter)
        jx = jax.random.randint(kx, (n_x,), -ov, ov + 1)
        jy = jax.random.randint(ky, (n_y,), -ov, ov + 1)
        draws["jitter"] = (torch.as_tensor(np.array(jy), dtype=torch.int64),
                           torch.as_tensor(np.array(jx), dtype=torch.int64))
    if prior.patch_fraction < 1.0:
        if prior._group_sampling:
            draws["group"] = int(jax.random.randint(key_sub, (), 0,
                                                    prior._n_groups))
        else:
            if prior.jitter:
                n_total = n_x * n_y
            elif prior._grouped_ok:
                n_total = count_overlapping_patches(shape, prior.patch_shape,
                                                    s)
            else:
                ph = prior.patch_shape[0]
                n_total = ((h - ph) // s + 1) * ((w - ph) // s + 1)
            n_keep = max(1, int(round(prior.patch_fraction * n_total)))
            perm = jax.random.permutation(key_sub, n_total)[:n_keep]
            draws["subset"] = torch.as_tensor(np.array(perm),
                                              dtype=torch.int64)
    return draws


def make_flux(shape, seed=8):
    rs = np.random.RandomState(seed)
    return rs.uniform(0.1, 2.0, size=shape).astype(np.float32)[None, None]


def compare(prior_j, prior_t, flux, key):
    value_j, grad_j = jax.value_and_grad(lambda f: prior_j(f, key=key))(
        jnp.asarray(flux))
    x = torch.as_tensor(flux).requires_grad_(True)
    draws = jax_draws(key, prior_t, flux.shape)
    value_t = prior_t(x, shifts=draws)
    value_t.backward()
    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-5 * float(np.abs(grad_j).max()))
    return draws


OPTIONS = {
    "subpix": dict(cycle_spin_subpix=True),
    "subpix-no-spin": dict(cycle_spin_subpix=True, cycle_spin=False),
    "jitter": dict(jitter=True),
    "jitter-subset": dict(jitter=True, patch_fraction=0.5),
    "group": dict(patch_fraction=0.25),
    "subset": dict(patch_fraction=0.5),
}


@pytest.mark.parametrize("name,shape", [
    ("astro-snr-v1", (40, 64)), ("random-4x4", (40, 64)),
    ("builtin-8x8-v1", (36, 52)),
])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_value_and_gradient(name, shape, option):
    gmm_j, gmm_t, stride = gmm_pair(name)
    kwargs = OPTIONS[option]
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride, **kwargs)
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=stride, **kwargs)
    fused = prior_t._fused_ok(shape)
    assert fused == (option.startswith("subpix") and name != "random-4x4")
    tf.reset_counters()
    draws = compare(prior_j, prior_t, make_flux(shape), jax.random.PRNGKey(9))
    assert (tf.fused_backward_plain.calls == 1) == fused
    if option == "group":
        assert draws["group"] in range(prior_t._n_groups)


@pytest.mark.parametrize("stride", [3, 5])
def test_strides_that_do_not_divide_the_patch(stride):
    gmm_j, gmm_t, _ = gmm_pair("builtin-8x8-v1")
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride)
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=stride)
    assert not prior_t._fused_ok((40, 64)) and not prior_t._grouped_ok
    compare(prior_j, prior_t, make_flux((40, 64)), jax.random.PRNGKey(2))


@pytest.mark.parametrize("where", ["gmm-meta", "prior"])
def test_standardized_patch_norm(where):
    """The standardized norm as the GMM's meta patch norm (the raise of
    the port's GMM is gone) and as the prior's; the patch-level
    branch."""
    gmm_j, gmm_t, stride = gmm_pair("random-4x4")
    kwargs_j, kwargs_t = {}, {}
    if where == "gmm-meta":
        gmm_j = jj.GaussianMixtureModel.from_numpy(
            np.asarray(gmm_j.means), np.asarray(gmm_j.covariances),
            np.asarray(gmm_j.weights),
            meta=JMeta(stride=stride, patch_norm=JStd()))
        gmm_t = jt.GaussianMixtureModel.from_numpy(
            gmm_t.means, gmm_t.covariances, gmm_t.weights,
            meta=TMeta(stride=stride, patch_norm=TStd()))
    else:
        gmm_j, gmm_t, stride = gmm_pair("astro-snr-v1")
        kwargs_j, kwargs_t = {"patch_norm": JStd()}, {"patch_norm": TStd()}
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride, **kwargs_j)
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=stride, **kwargs_t)
    assert type(prior_t.patch_norm) is TStd
    assert not prior_t._fused_ok((40, 64))
    compare(prior_j, prior_t, make_flux((40, 64)), jax.random.PRNGKey(4))


def jax_eval_key(prior_j):
    """The key the JAX prior's next eager call draws (``next_key``)."""
    return jax.random.split(prior_j._key)[1]


@pytest.mark.parametrize("name,stride,subpix", [
    ("builtin-8x8-v1", 4, False), ("builtin-8x8-v1", 4, True),
    ("builtin-8x8-v1", 3, False), ("random-4x4", 2, False),
])
def test_prior_image(name, stride, subpix):
    gmm_j, gmm_t, _ = gmm_pair(name)
    norm_kwargs = dict(alpha=0.8, beta=1.5)
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride,
                               cycle_spin_subpix=subpix,
                               norm=jn.ASinhImageNorm(**norm_kwargs))
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=stride,
                               cycle_spin_subpix=subpix,
                               norm=jt.ASinhImageNorm(**norm_kwargs))
    flux = make_flux((40, 48))[0, 0]
    draws = jax_draws(jax_eval_key(prior_j), prior_t, flux.shape)
    image_j = prior_j.prior_image(flux)
    image_t = prior_t.prior_image(flux, shifts=draws)
    assert image_t.shape == image_j.shape == flux.shape
    assert_allclose(image_t, image_j, rtol=1e-4,
                    atol=1e-5 * float(np.abs(image_j).max()))


def test_prior_image_average():
    gmm_j, gmm_t, stride = gmm_pair("random-4x4")
    prior_j = jj.GMMPatchPrior(gmm=gmm_j, stride=stride)
    prior_t = jt.GMMPatchPrior(gmm=gmm_t, stride=stride)
    flux = make_flux((24, 32))[0, 0]
    # the keys of the JAX package's next three eager calls
    key, draws = prior_j._key, []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(sub, prior_t, (1, 1) + flux.shape))
    avg_j = prior_j.prior_image_average(flux, n_average=3)
    avg_t = prior_t.prior_image_average(flux, n_average=3, shifts=draws)
    assert avg_t.shape == avg_j.shape
    assert_allclose(avg_t, avg_j, rtol=1e-4,
                    atol=1e-5 * float(np.abs(avg_j).max()))


@pytest.mark.parametrize("kwargs", [{"jitter": True},
                                    {"patch_fraction": 0.5}])
def test_prior_image_refuses_random_patches(kwargs):
    gmm_t = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    with pytest.raises(ValueError):
        jt.GMMPatchPrior(gmm=gmm_t, **kwargs).prior_image(
            make_flux((32, 32))[0, 0])


@pytest.mark.parametrize("kwargs", [
    {},
    {"stride": 2, "cycle_spin_subpix": True, "jitter": True,
     "marginalize": True, "patch_fraction": 0.5, "cycle_spin": False},
    {"norm": "asinh"},
    {"patch_norm": "std"},
])
def test_to_dict_matches_jax_and_round_trips(kwargs):
    def build(pkg, norms):
        kw = dict(kwargs)
        if kw.get("norm") == "asinh":
            kw["norm"] = norms.ASinhImageNorm(alpha=0.3, beta=2.0)
        if kw.get("patch_norm") == "std":
            kw["patch_norm"] = norms.StandardizedSubtractMeanPatchNorm()
        gmm = pkg.GaussianMixtureModel.from_registry("builtin-8x8-v1")
        return pkg.GMMPatchPrior(gmm=gmm, **kw)

    data = build(jt, tn).to_dict()
    assert data == build(jj, jn).to_dict()
    back = jt.priors.Prior.from_dict(data)
    assert type(back) is jt.GMMPatchPrior and back.to_dict() == data
    assert_array_equal(back.gmm.means, build(jt, tn).gmm.means)


def test_inline_gmm_dict_round_trip():
    _, gmm_t, _ = gmm_pair("random-4x4")
    data = gmm_t.to_dict()
    assert data["type"] == "inline" and data["stride"] == 2
    back = jt.GaussianMixtureModel.from_dict(data)
    assert_array_equal(back.covariances, gmm_t.covariances)
    assert back.meta == gmm_t.meta


def test_eigen_images_match_jax():
    gmm_j, gmm_t, _ = gmm_pair("random-4x4")
    assert_allclose(gmm_t.eigen_images, np.asarray(gmm_j.eigen_images),
                    rtol=1e-6, atol=1e-7)
