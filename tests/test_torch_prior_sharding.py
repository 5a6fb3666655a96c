"""The prior's work split over shards, in the port against ``jolideco_tpu``.

- ``ops.gmm_fused.gmm_score_fused_partial_sum``: the shards' partial sums
  over 1 to 4 (and 9, more shards than some images have strip rows)
  contiguous strip blocks, MAP and marginalised, under the default dial
  (``"split"`` logits), against the whole image's
  ``sum(values[valid])`` in the port, and, over 3 shards (uneven blocks:
  the JAX package pads its strip count), against the JAX package's
  partial sums in Pallas interpret mode (its own tests' reference).
  Images of 32 x 128 (4 strip rows) and, in the port, 61 x 45 with a
  block of zero-flux sentinel pixels.
- ``parallel.sharded_prior_fn`` on four CPU ranks of one gloo group
  (``jolideco_torch.parallel.launch.run_ranks``; the workers in
  ``tests/torch_mesh_workers.py`` import no JAX), against the unsharded
  prior of the port: the fused GMM prior (48², and 56 x 40 with uneven
  blocks), with a learnable asinh norm, marginalised, and the priors
  that take the fallback (``value / n_shards`` on every rank): jitter, a
  uniform and a smoothness prior beside a GMM one, ``MultiScalePrior``;
  and, for the asinh norm, jitter, the three priors and
  ``MultiScalePrior``, against the JAX package's ``sharded_prior_fn`` on
  ``make_obs_mesh(4)`` under the same key, whose draws the port is given.

Bars: values rtol 1e-6 and gradients 1e-6 of their max-abs against the
port's unsharded evaluation (the same patches summed in another order;
the JAX package's own bar, ``tests/test_prior_sharding.py:50-75``);
against the JAX package rtol 1e-5 and 1e-5 of the max-abs (its scorer's
float32 sums in another order, ``tests/test_torch_prior.py``).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import jolideco_tpu as jj
from jolideco_torch.ops.gmm_fused import (
    gmm_score_fused_image,
    gmm_score_fused_partial_sum,
)
from jolideco_torch.parallel.launch import run_ranks
from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_tpu.loss import PriorLoss as JPriorLoss
from jolideco_tpu.utils.norms import ASinhImageNorm
from jolideco_tpu.ops.gmm_fused import (
    gmm_score_fused_partial_sum as j_partial_sum,
)
from jolideco_tpu.parallel import make_obs_mesh as j_make_obs_mesh
from jolideco_tpu.parallel import sharded_prior_fn as j_sharded_prior_fn
from test_torch_multiscale import jax_multiscale_draws
from test_torch_prior_options import jax_draws
from torch_mesh_workers import prior_cases, prior_fluxes, prior_worker

torch.set_num_threads(1)
RANKS = 4
SENTINEL = -1e5
KEY = 42


def sentinel_image(shape, seed=0):
    image = np.random.RandomState(seed).uniform(0.1, 2.0, shape).astype(
        np.float32)
    if shape == (61, 45):
        image[10:14, 5:20] = 2 * SENTINEL
    return image


def port_sum(image, n_shards, marginalize, bufs):
    """The shards' partial sums and the gradient of their sum."""
    x = torch.as_tensor(image).requires_grad_(True)
    total = sum(gmm_score_fused_partial_sum(
        x, (8, 8), 4, bufs, SENTINEL, n_shards, index,
        marginalize=marginalize, mode="split") for index in range(n_shards))
    total.backward()
    return float(total.detach()), x.grad.numpy()


def close(got, want, rtol):
    assert_allclose(got[0], want[0], rtol=rtol)
    assert_allclose(got[1], want[1], rtol=0,
                    atol=rtol * float(np.abs(want[1]).max()))


@pytest.mark.parametrize("marginalize", [False, True])
@pytest.mark.parametrize("shape", [(32, 128), (61, 45)])
def test_partial_sums_add_up_to_the_whole_image(shape, marginalize):
    bufs = TGMM.from_registry("builtin-8x8-v1").kernel_buffers(
        torch.device("cpu"))
    image = sentinel_image(shape)
    x = torch.as_tensor(image).requires_grad_(True)
    values, _, valid = gmm_score_fused_image(
        x, (8, 8), 4, bufs, SENTINEL, marginalize=marginalize, mode="split")
    whole = torch.where(valid, values, torch.zeros_like(values)).sum()
    whole.backward()
    want = (float(whole.detach()), x.grad.numpy())
    for n_shards in (1, 2, 3, 4, 9):
        close(port_sum(image, n_shards, marginalize, bufs), want, 1e-6)


@pytest.mark.parametrize("marginalize", [False, True])
def test_partial_sums_match_jax(marginalize):
    shape, n_shards = (32, 128), 3
    image = sentinel_image(shape)
    gmm_j = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")

    def shard(x, index):
        return j_partial_sum(x, (8, 8), 4, gmm_j.packed, SENTINEL, n_shards,
                             index, interpret=True, marginalize=marginalize)

    # one trace for every shard: the index is a traced integer
    value, grad = jax.jit(shard), jax.jit(jax.grad(shard))
    x_j = jnp.asarray(image)
    value_j = sum(float(value(x_j, jnp.int32(i))) for i in range(n_shards))
    grad_j = sum(np.asarray(grad(x_j, jnp.int32(i)))
                 for i in range(n_shards))
    bufs = TGMM.from_registry("builtin-8x8-v1").kernel_buffers(
        torch.device("cpu"))
    close(port_sum(image, n_shards, marginalize, bufs), (value_j, grad_j),
          1e-5)


def jax_priors(name):
    """The JAX package's twin of ``prior_cases()[name]``."""
    gmm = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")

    def gmm_prior(**kwargs):
        return jj.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True, **kwargs)

    return {
        "asinh_norm": lambda: {"flux": gmm_prior(
            norm=ASinhImageNorm())},
        "jitter": lambda: {"flux": gmm_prior(jitter=True)},
        "mixed": lambda: {"a": gmm_prior(), "b": jj.UniformPrior(),
                          "c": jj.SmoothnessPrior()},
        "multiscale": lambda: {"flux": jj.MultiScalePrior(gmm_prior(),
                                                          n_levels=2)},
    }[name]()


# the cases held against the JAX package as well: a GMM prior's split
# (with an asinh norm's leaves), the fallback (jitter), several priors,
# the levels. The uneven blocks and the marginalised prior (whose JAX
# reference is its Pallas kernels, tests/test_torch_marginalise.py) are
# held against the port's unsharded prior, which the other tests hold
# to the JAX package.
JAX_CASES = ("asinh_norm", "jitter", "mixed", "multiscale")


def port_draws(key, priors, shapes):
    """The JAX keys' draws in the port's ``shifts=`` form: the prior
    loss splits ``key`` per prior."""
    keys = jax.random.split(key, len(priors))
    draws = {}
    for k, (name, prior), shape in zip(keys, priors.items(), shapes):
        full = (1, 1) + tuple(shape)
        if hasattr(prior, "n_levels"):
            draws[name] = jax_multiscale_draws(k, prior, full)
        elif hasattr(prior, "gmm"):
            draws[name] = jax_draws(k, prior, full)
    return draws


def jax_values(name, shapes):
    priors = jax_priors(name)
    prior_loss = JPriorLoss(priors)
    fn = j_sharded_prior_fn(j_make_obs_mesh(RANKS))
    fluxes = tuple(jnp.asarray(f)[None, None]
                   for f in prior_fluxes(shapes))
    params = {n: {"prior": p.parameters()} for n, p in priors.items()
              if p.parameters()}
    key = jax.random.PRNGKey(KEY)

    def value(fluxes, params):
        return fn(prior_loss, fluxes, params=params, key=key)

    total = float(jax.jit(value)(fluxes, params))
    grads = jax.jit(jax.grad(value, argnums=(0, 1)))(fluxes, params)
    flux_grads = [np.asarray(g)[0, 0] for g in grads[0]]
    leaf_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads[1])]
    return total, flux_grads + leaf_grads


@pytest.fixture(scope="module")
def ranks():
    draws = {}
    for name in JAX_CASES:
        priors, shapes = prior_cases()[name]
        draws[name] = port_draws(jax.random.PRNGKey(KEY), priors, shapes)
    return run_ranks(prior_worker, RANKS, args=(draws,), threads=1,
                     timeout=600)


def grads_close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g).reshape(-1), np.asarray(w).reshape(-1)
        assert_allclose(g, w, rtol=0,
                        atol=rtol * float(np.abs(w).max()) + 1e-30)


@pytest.mark.parametrize("name", list(prior_cases()))
def test_sharded_prior_matches_unsharded(ranks, name):
    for out in ranks:
        sharded, whole = out[name]["sharded"], out[name]["whole"]
        assert_allclose(sharded[0], whole[0], rtol=1e-6)
        grads_close(sharded[1], whole[1], 1e-6)
    if name in ("fused", "fused_ragged", "marginalised", "asinh_norm"):
        # one strip block a rank, scored once
        assert [out[name]["forward_calls"] for out in ranks] == [1] * RANKS


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_prior_matches_jax(ranks, name):
    shapes = prior_cases()[name][1]
    value_j, grads_j = jax_values(name, shapes)
    for out in ranks:
        sharded = out[name]["sharded"]
        assert_allclose(sharded[0], value_j, rtol=1e-5)
        grads_close(sharded[1], grads_j, 1e-5)


def test_sharded_prior_needs_the_draws(ranks):
    for out in ranks:
        assert "requires the priors' draws" in out["no_draws"]
