"""The marginalised probe's ``"split"`` mode against the JAX package.

Under its default dial the JAX package's flux-error probe runs the
marginalised patch scorer ``gmm_score_pallas(..., marginalize=True)`` at
``precision=HIGH``: its logsumexp, unit gradient (``_unit_marg_kernel``)
and Hessian weights (``_hvp_marg_weights_kernel``) on the ``"split3"``
logits. The JAX side runs those kernels in the Pallas interpreter on the
CPU; the port runs the split plain versions (``score_split_marg_plain``,
``marg_unit_split_plain``, ``hvp_marg_weights_split_plain``, then the
float32 ``hvp_marg_mix_plain``: a CPU tensor), the references of the
card's K5 lse split, K8 split and K9a split (``csrc/gmm_score_wg.cu``'s
three-product instances), which form the same bf16 products of the
logits. The port mixes in float32 where the JAX kernels split ``p`` and
``A`` into bf16 hi and lo, and computes ``g_k = t . (b_k - A_k x)`` in
float32 where the JAX kernel takes a split cross form (``ROADMAP.md``
section 3).

Rows: the probe's rows of a random image (its grouped patches,
mean-subtracted, two of them zero as masked patches). GMMs: a random SPD
GMM whose weights are mixed, ``builtin-8x8-v1`` (about one nonzero
weight a row) and ``chip_smoke.wide_gmm`` (256 components, two of the
kernels' tiles of 200). Tolerances:

- the gradient of ``sum(values)`` and its Hessian action along a random
  tangent: 1e-4 of their max-abs, the bar of
  ``tests/test_torch_marginalise.py`` at HIGHEST. On these rows the
  port's split plain pipeline lies 8.3e-6 and 8.1e-6 of the max-abs
  from the JAX kernels at HIGH under the random SPD GMM (its float32
  pipeline 3.1e-5 and 2.9e-5), 3.4e-6 and 2.9e-6 under
  ``builtin-8x8-v1``, 2.3e-6 and 3.4e-6 under ``wide_gmm()``;
- the split plain weights' ``dp`` exactly 0 on a row whose weight sits
  on one component (the kernels' rule).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp
from jax import lax

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.ops import gmm_pallas as tp
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from test_torch_gmm_patch import random_spd_arrays

torch.set_num_threads(1)
GMM_NAMES = ["random-spd", "builtin-8x8-v1", "wide-256"]


def gmm_pair(name):
    """The JAX package's GMM and the port's, from the same arrays."""
    if name == "wide-256":
        from chip_smoke import wide_gmm, wide_gmm_arrays
        from jolideco_tpu.priors.patches.gmm import GaussianMixtureModelMeta

        *arrays, stride = wide_gmm_arrays()
        meta = GaussianMixtureModelMeta(stride=stride)
        return (jj.GaussianMixtureModel.from_numpy(*arrays, meta=meta),
                wide_gmm())
    if name == "random-spd":
        arrays = random_spd_arrays()
        return (jj.GaussianMixtureModel.from_numpy(*arrays),
                gmm_from_arrays(*arrays, None))
    return (jj.GaussianMixtureModel.from_registry(name),
            jt.GaussianMixtureModel.from_registry(name))


@pytest.fixture(scope="module")
def rows():
    """The probe's rows of a random 32 x 48 image: its 96 grouped
    patches, mean-subtracted; rows 0 and 61 zeroed as masked patches."""
    from jolideco_torch.ops.patches import (
        view_as_overlapping_patches_grouped,
    )

    img = np.random.RandomState(3).uniform(0.1, 2.0, (32, 48))
    patches = view_as_overlapping_patches_grouped(
        torch.as_tensor(img, dtype=torch.float32), (8, 8), 4)
    x = patches - patches.mean(dim=1, keepdim=True)
    x[::61] = 0.0
    return x.contiguous().numpy()


def jax_grad_and_hvp(gmm_j, x, t):
    """Gradient of ``sum(values)`` and its JVP along ``t``, the JAX
    kernels at HIGH in the Pallas interpreter."""
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def total(v):
        return jnp.sum(gmm_score_pallas(v, *args, True, lax.Precision.HIGH,
                                        True)[0])

    grad = jax.grad(total)
    _, hvp = jax.jvp(grad, (jnp.asarray(x),), (jnp.asarray(t),))
    return np.asarray(grad(jnp.asarray(x))), np.asarray(hvp)


def torch_grad_and_hvp(x, t, bufs, mode):
    x = torch.as_tensor(x).requires_grad_(True)
    values, _ = tp.gmm_score_patches(x, bufs, True, mode)
    (grad,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x, grad_outputs=torch.as_tensor(t))
    return grad.detach().numpy(), hvp.numpy()


@pytest.mark.parametrize("name", GMM_NAMES)
def test_patch_gradient_and_hvp_match_jax_high(rows, name):
    gmm_j, gmm_t = gmm_pair(name)
    bufs = gmm_t.kernel_buffers("cpu")
    tangent = np.random.RandomState(5).randn(*rows.shape).astype(np.float32)
    grad_j, hvp_j = jax_grad_and_hvp(gmm_j, rows, tangent)

    tp.reset_counters()
    tf.reset_counters()
    grad_t, hvp_t = torch_grad_and_hvp(rows, tangent, bufs, "split")
    assert (tf.score_split_marg_plain.calls, tf.marg_unit_split_plain.calls,
            tp.hvp_marg_weights_split_plain.calls,
            tp.hvp_marg_mix_plain.calls) == (1, 1, 1, 1)
    assert (tp.score_rows_plain.calls, tp.unit_marg_plain.calls,
            tp.hvp_marg_weights_plain.calls, tf.score_split_plain.calls,
            tf.score_plain.calls) == (0, 0, 0, 0, 0)

    x = torch.as_tensor(rows)
    lse, argmax = tf.score_split_marg_plain(x, bufs)
    p, _ = tp.hvp_marg_weights_split_plain(x, torch.as_tensor(tangent), lse,
                                           bufs)
    if name == "random-spd":
        # the mixture is exercised: weights are not one-hot
        assert float(p.max(dim=0).values.min()) < 0.99
    if name == "wide-256":
        # both tiles hold the heaviest components of some rows
        assert 0 < int((argmax >= tf.KP_WG).sum()) < len(rows)

    assert_allclose(grad_t, grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))
    assert_allclose(hvp_t, hvp_j, rtol=0,
                    atol=1e-4 * float(np.abs(hvp_j).max()))


@pytest.mark.parametrize("name", ["builtin-8x8-v1", "astro-snr-v1"])
def test_split_weights_are_exact_on_one_hot_rows(rows, name):
    """Under the shipped GMMs nearly every row's weight sits on one
    component: there ``p`` is one-hot and ``dp`` exactly 0, the rule K9a
    split keeps on the card; the rows' p sum to 1."""
    bufs = jt.GaussianMixtureModel.from_registry(name).kernel_buffers("cpu")
    x = torch.as_tensor(rows)
    t = torch.as_tensor(np.random.RandomState(6).randn(*rows.shape),
                        dtype=torch.float32)
    lse, _ = tf.score_split_marg_plain(x, bufs)
    p, dp = tp.hvp_marg_weights_split_plain(x, t, lse, bufs)
    assert p.shape == dp.shape == (bufs["rec"].shape[0], len(rows))
    one_hot = (p > 0).sum(dim=0) == 1
    assert int(one_hot.sum()) >= 0.9 * len(rows)
    assert bool((dp[:, one_hot] == 0).all())
    assert_allclose(p.sum(dim=0).numpy(), 1.0, rtol=1e-6)


def test_split_hessian_action_has_no_derivative(rows):
    """The marginalise Hessian action of the ``"split"`` mode raises when
    differentiated, as the float32 one does (neither package has a third
    derivative)."""
    bufs = jt.GaussianMixtureModel.from_registry(
        "builtin-8x8-v1").kernel_buffers("cpu")
    x = torch.as_tensor(rows[:32]).requires_grad_(True)
    t = torch.as_tensor(np.random.RandomState(9).randn(32, 64),
                        dtype=torch.float32)
    tp.reset_counters()
    values, _ = tp.gmm_score_patches(x, bufs, True, "split")
    (grad,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x, grad_outputs=t, create_graph=True)
    assert tp.hvp_marg_weights_split_plain.calls == 1
    with pytest.raises(RuntimeError, match="third derivative"):
        torch.autograd.grad(hvp.sum(), x)


def test_split_probe_wrappers_refuse_cpu_tensors(rows):
    """K8 split's and K9a split's wrappers launch on a card or raise: a
    CPU tensor takes the split plain versions only through the
    dispatch."""
    bufs = jt.GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers("cpu")
    x = torch.as_tensor(rows)
    lse = torch.zeros(len(rows))
    for call in (lambda: tp.gmm_unit_marg_tc_cuda(x, lse, bufs),
                 lambda: tp.gmm_hvp_marg_weights_tc_cuda(x, x, lse, bufs)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
