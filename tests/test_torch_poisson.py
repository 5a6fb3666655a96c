"""Poisson likelihood of the port against ``jolideco_tpu.loss``.

Same numpy inputs through both packages; float32 on the CPU. Tolerance:
rtol 1e-5 for values and gradients (float32 means of a few thousand
terms summed in different orders).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from jolideco_torch.loss import poisson_nll, stirling_term_mean
from jolideco_tpu import loss as jloss

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    counts = rs.poisson(3.0, size=(1, 1, 48, 40)).astype(np.float32)
    # make sure the Stirling cut at counts <= 1 is exercised
    counts[0, 0, :4, :4] = 0.0
    counts[0, 0, 4:8, :4] = 1.0
    npred = rs.uniform(0.5, 6.0, size=counts.shape).astype(np.float32)
    return counts, npred


def test_stirling_term_mean(data):
    counts, _ = data
    got = stirling_term_mean(torch.as_tensor(counts)).item()
    want = float(jloss.stirling_term_mean(jnp.asarray(counts)))
    assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("precomputed", [False, True])
def test_poisson_nll_value_and_grad(data, precomputed):
    counts, npred = data
    stirling_t = (stirling_term_mean(torch.as_tensor(counts))
                  if precomputed else None)
    stirling_j = (jloss.stirling_term_mean(jnp.asarray(counts))
                  if precomputed else None)

    npred_t = torch.as_tensor(npred).requires_grad_(True)
    value_t = poisson_nll(npred_t, torch.as_tensor(counts),
                          stirling=stirling_t)
    value_t.backward()

    def f(x):
        return jloss.poisson_nll(x, jnp.asarray(counts), stirling=stirling_j)

    value_j, grad_j = jax.value_and_grad(f)(jnp.asarray(npred))
    assert_allclose(value_t.item(), float(value_j), rtol=RTOL)
    assert_allclose(npred_t.grad.numpy(), np.asarray(grad_j), rtol=RTOL)


def test_counts_zero_and_one_add_no_stirling_term():
    counts = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
    assert stirling_term_mean(counts).item() == 0.0
    npred = torch.full((2, 2), 2.0)
    want = float(jloss.poisson_nll(jnp.full((2, 2), 2.0),
                                   jnp.asarray(counts.numpy())))
    assert_allclose(poisson_nll(npred, counts).item(), want, rtol=RTOL)
