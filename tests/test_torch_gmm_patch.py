"""Patch-level GMM scorer of the port against ``jolideco_tpu.ops.gmm_pallas``.

The JAX side runs ``gmm_score_pallas`` in interpret mode on the CPU at
its default ``precision=HIGHEST``, as ``tests/test_gmm_pallas.py`` runs
it; the port runs the plain versions of its three kernels (a CPU
tensor). Inputs: 500 mean-subtracted random rows (the JAX tests' rows),
the ``builtin-8x8-v1`` GMM and a small random SPD GMM (K = 13, unit
pixel weights). Tolerances:

- values: rtol 1e-5 (float32 quadratic forms summed in different
  orders), for the max and the logsumexp;
- argmax: identical;
- the gradient of ``sum(values)``: 1e-4 of its max-abs (the JAX backward
  reads ``A`` as a bf16 hi/lo pair, about 16 significant bits);
- the Hessian action along a random tangent, the port's double
  backward against ``jax.jvp(jax.grad(...))``: 1e-4 of its max-abs (the
  JAX package's own bar, ``tests/test_gmm_pallas.py``).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from jolideco_torch.ops import gmm_pallas as tp
from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from jolideco_tpu.priors import GaussianMixtureModel as JGMM

torch.set_num_threads(1)
N_ROWS = 500


def random_spd_arrays(k=13, d=64, seed=1):
    from sklearn.datasets import make_spd_matrix

    rs = np.random.RandomState(seed)
    means = rs.rand(k, d)
    covariances = np.stack(
        [make_spd_matrix(d, random_state=i) for i in range(k)]
    )
    return means, covariances, rs.dirichlet(np.ones(k))


@pytest.fixture(scope="module", params=["builtin-8x8-v1", "random-spd"])
def gmms(request):
    if request.param == "random-spd":
        means, covariances, weights = random_spd_arrays()
        gmm_j = JGMM.from_numpy(means=means, covariances=covariances,
                                weights=weights)
        return gmm_j, gmm_from_arrays(means, covariances, weights, None)
    return (JGMM.from_registry(request.param),
            TGMM.from_registry(request.param))


@pytest.fixture(scope="module")
def rows():
    rs = np.random.RandomState(0)
    x = rs.rand(N_ROWS, 64).astype(np.float32) - 0.5
    return x - x.mean(axis=1, keepdims=True)


def jax_score(gmm_j, marginalize=False):
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def score(x):
        return gmm_score_pallas(x, *args, True, marginalize=marginalize)

    return score


@pytest.mark.parametrize("marginalize", [False, True])
def test_values_and_argmax_match_interpret_kernel(gmms, rows, marginalize):
    gmm_j, gmm_t = gmms
    values_j, argmax_j = jax_score(gmm_j, marginalize)(jnp.asarray(rows))
    values_t, argmax_t = tp.gmm_score_patches(
        torch.as_tensor(rows), gmm_t.kernel_buffers("cpu"),
        marginalize=marginalize,
    )
    assert values_t.shape == (N_ROWS,) and argmax_t.dtype == torch.int32
    assert_allclose(values_t.numpy(), np.asarray(values_j), rtol=1e-5)
    assert_array_equal(argmax_t.numpy(), np.asarray(argmax_j))


def test_gradient_and_hvp_match_jax(gmms, rows):
    gmm_j, gmm_t = gmms
    tangent = np.random.RandomState(5).randn(*rows.shape).astype(np.float32)
    score_j = jax_score(gmm_j)

    def total_j(x):
        return jnp.sum(score_j(x)[0])

    grad_j = np.asarray(jax.grad(total_j)(jnp.asarray(rows)))
    _, hvp_j = jax.jvp(jax.grad(total_j), (jnp.asarray(rows),),
                       (jnp.asarray(tangent),))
    hvp_j = np.asarray(hvp_j)

    tp.reset_counters()
    x = torch.as_tensor(rows).requires_grad_(True)
    values, _ = tp.gmm_score_patches(x, gmm_t.kernel_buffers("cpu"))
    (grad_t,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    (hvp_t,) = torch.autograd.grad(grad_t, x,
                                   grad_outputs=torch.as_tensor(tangent))
    assert (tp.score_rows_plain.calls, tp.unit_map_plain.calls,
            tp.hvp_map_plain.calls) == (1, 1, 1)

    assert_allclose(grad_t.detach().numpy(), grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))
    assert_allclose(hvp_t.numpy(), hvp_j, rtol=0,
                    atol=1e-4 * float(np.abs(hvp_j).max()))


def test_plain_unit_and_hvp_are_the_derivatives_of_the_logit(rows):
    """The plain unit gradient and Hessian action against torch autograd
    through the selected component's logit (float32; 1e-5 of max-abs)."""
    bufs = TGMM.from_registry("builtin-8x8-v1").kernel_buffers("cpu")
    _, argmax = tp.score_rows_plain(torch.as_tensor(rows), bufs)
    k = argmax.long()
    x = torch.as_tensor(rows).requires_grad_(True)
    a, b = bufs["a_full"][k], bufs["b_rows"][k]
    logit = -0.5 * torch.einsum("nr,nrc,nc->n", x, a, x) + (b * x).sum(1)
    (unit,) = torch.autograd.grad(logit.sum(), x, create_graph=True)
    t = torch.as_tensor(np.random.RandomState(6).randn(*rows.shape),
                        dtype=torch.float32)
    (hvp,) = torch.autograd.grad(unit, x, grad_outputs=t)

    got_unit = tp.unit_map_plain(x.detach(), argmax, bufs)
    got_hvp = tp.hvp_map_plain(t, argmax, bufs)
    for got, want in ((got_unit, unit.detach()), (got_hvp, hvp)):
        assert_allclose(got.numpy(), want.numpy(), rtol=0,
                        atol=1e-5 * float(want.abs().max()))


def test_third_order_and_marginalise_gradient(rows):
    """The Hessian action is linear in its tangent: its derivative along
    the tangent is the Hessian action again (float32; 1e-5 of max-abs).
    The marginalise gradient runs through the marginalise unit gradient
    (its plain version here), with the forward's logsumexp."""
    bufs = TGMM.from_registry("builtin-8x8-v1").kernel_buffers("cpu")
    rs = np.random.RandomState(7)
    x = torch.as_tensor(rows[:64]).requires_grad_(True)
    t = torch.as_tensor(rs.randn(64, 64), dtype=torch.float32)
    s = torch.as_tensor(rs.randn(64, 64), dtype=torch.float32)
    values, argmax = tp.gmm_score_patches(x, bufs)
    (grad,) = torch.autograd.grad(values.sum(), x, create_graph=True)
    t.requires_grad_(True)
    (hvp,) = torch.autograd.grad(grad, x, grad_outputs=t, create_graph=True)
    (third,) = torch.autograd.grad(hvp, t, grad_outputs=s)
    want = tp.hvp_map_plain(s, argmax, bufs)
    assert_allclose(third.numpy(), want.numpy(), rtol=0,
                    atol=1e-5 * float(want.abs().max()))

    tp.reset_counters()
    values, _ = tp.gmm_score_patches(x, bufs, marginalize=True)
    values.sum().backward()
    assert tp.unit_marg_plain.calls == 1
    want = tp.unit_marg_plain(x.detach(), values.detach(), bufs)
    assert_allclose(x.grad.numpy(), want.numpy(), rtol=0,
                    atol=1e-6 * float(want.abs().max()))


def test_empty_rows_and_cuda_wrappers_refuse_cpu_tensors():
    bufs = TGMM.from_registry("builtin-8x8-v1").kernel_buffers("cpu")
    values, argmax = tp.gmm_score_patches(torch.zeros((0, 64)), bufs)
    assert values.shape == (0,) and argmax.shape == (0,)
    x = torch.zeros((4, 64))
    argmax = torch.zeros(4, dtype=torch.int32)
    lse, p = torch.zeros(4), torch.zeros((bufs["rec"].shape[0], 4))
    for call in (lambda: tp.gmm_score_rows_cuda(x, bufs),
                 lambda: tp.gmm_unit_map_cuda(x, argmax, bufs),
                 lambda: tp.gmm_hvp_map_cuda(x, argmax, bufs),
                 lambda: tp.gmm_unit_marg_cuda(x, lse, bufs),
                 lambda: tp.gmm_hvp_marg_weights_cuda(x, x, lse, bufs),
                 lambda: tp.gmm_hvp_marg_mix_cuda(x, x, p, p, bufs)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
