"""The marginalised fused GMM scorer's ``"split"`` mode against the JAX
package.

The JAX package runs its fused kernel with ``marginalize=True`` in the
Pallas interpreter on the CPU at ``precision=HIGH``: its ``"split3"``
logits feed both the logsumexp of the forward and the logits its
marginalise backward recomputes. The port runs the split plain versions
(a CPU tensor): the logsumexp of the same bf16 products
(``score_split_marg_plain``) and the marginalise backward whose softmax
runs over those logits against that logsumexp
(``marg_unit_split_plain``), the references of the card's tensor-core
kernels (``csrc/gmm_score_wg.cu``). Tolerances, the bars of
``tests/test_torch_gmm_fused_split.py``:

- ``valid`` identical to the JAX package's;
- the logsumexp: the port's max-abs error against the float64 logsumexp
  of the float64 logits at most twice the JAX kernel's, plus 1e-6 of the
  max-abs; the argmax the JAX package's wherever the float64 gap between
  the two largest logits exceeds ten times the larger of the two errors;
- the image gradient against ``jax.grad`` at HIGH to 1e-4 of its
  max-abs (the JAX backward mixes with the softmax weights and ``A`` as
  bf16 hi/lo pairs, about 16 significant bits; the port's mixture is
  float32).

The GMMs: the two of the registry (one-hot weights: logits of order 1e5
to 1e8), ``chip_smoke.wide_gmm`` (256 components, two of the tensor-core
kernels' tiles of 208) and a random SPD GMM whose weights are mixed
(``test_torch_marginalise.mixed_gmm_arrays``). Then the routing: the
backward follows the mode of the forward that saved the logsumexp,
whatever the dial says when it runs.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp
from jax import lax

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch import config
from jolideco_torch.ops import gmm_fused as tfused
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.ops.gmm_fused import gmm_score_fused_image
from jolideco_tpu.priors.patches.core import ZERO_FLUX_SENTINEL
from test_torch_gmm_fused_split import STRIDE, logits64, make_image
from test_torch_marginalise import mixed_gmm_arrays

torch.set_num_threads(1)
GMM_NAMES = ["builtin-8x8-v1", "astro-snr-v1", "wide-256", "random-spd"]
SHAPES = [(128, 128), (44, 136)]


@pytest.fixture(scope="module", params=GMM_NAMES)
def gmms(request):
    if request.param in ("wide-256", "random-spd"):
        from jolideco_tpu.priors.patches.gmm import GaussianMixtureModelMeta

        if request.param == "wide-256":
            from chip_smoke import wide_gmm_arrays

            *arrays, stride = wide_gmm_arrays()
            meta = GaussianMixtureModelMeta(stride=stride)
        else:
            arrays, stride, meta = mixed_gmm_arrays(), None, None
        gmm_j = (jj.GaussianMixtureModel.from_numpy(*arrays, meta=meta)
                 if meta is not None
                 else jj.GaussianMixtureModel.from_numpy(*arrays))
        return gmm_j, gmm_from_arrays(*arrays, stride)
    return (jj.GaussianMixtureModel.from_registry(request.param),
            jt.GaussianMixtureModel.from_registry(request.param))


def jax_fused(gmm_j, x):
    return gmm_score_fused_image(
        x, (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
        interpret=True, precision=lax.Precision.HIGH, marginalize=True)


def crop(a, shape):
    """The JAX package's patch grid, padded to its TPU tiling, cropped to
    the port's."""
    from jolideco_tpu.ops.gmm_fused import _padded_dims

    h, w = shape
    hp, wp, _ = _padded_dims(h, w)
    g = (8 // STRIDE) ** 2
    grid = np.asarray(a).reshape(g, hp // 8, wp // 8)
    return grid[:, :h // 8, :w // 8].reshape(-1)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_logsumexp_matches_jax_high(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape)
    v_j, a_j, valid_j = (crop(a, shape) for a in
                         jax_fused(gmm_j, jnp.asarray(img)))

    bufs = gmm_t.kernel_buffers("cpu")
    tfused.reset_counters()
    v_t, a_t, valid_t, xtn = tfused.fused_forward_plain(
        torch.as_tensor(img), bufs, STRIDE, ZERO_FLUX_SENTINEL, True,
        mode="split")
    assert (tfused.score_split_marg_plain.calls,
            tfused.score_split_plain.calls, tfused.score_plain.calls) \
        == (1, 0, 0)
    m = valid_t.numpy() > 0.5
    assert_array_equal(m, valid_j)
    assert 0 < m.sum() <= m.size
    if shape[0] != shape[1]:
        assert m.sum() < m.size

    ref = logits64(xtn.numpy()[m], gmm_t)
    top = ref.max(axis=1)
    lse64 = top + np.log(np.exp(ref - top[:, None]).sum(axis=1))
    err_t = float(np.abs(v_t.numpy()[m] - lse64).max())
    err_j = float(np.abs(v_j[m] - lse64).max())
    scale = float(np.abs(lse64).max())
    assert err_t <= 2 * err_j + 1e-6 * scale, (err_t, err_j, scale)

    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 10 * max(err_t, err_j)
    assert decided.any()
    assert_array_equal(a_t.numpy()[m][decided], a_j[m][decided])
    assert_array_equal(a_t.numpy()[m][decided], ref.argmax(axis=1)[decided])


@pytest.mark.parametrize("shape", SHAPES)
def test_split_marg_image_gradient_matches_jax_high(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape, seed=11)

    def scalar_j(x):
        values, _, valid = jax_fused(gmm_j, x)
        return jnp.sum(jnp.where(valid, values, 0.0))

    value_j, grad_j = jax.value_and_grad(scalar_j)(jnp.asarray(img))

    tfused.reset_counters()
    x = torch.as_tensor(img).requires_grad_(True)
    values, _, valid = tfused.gmm_score_fused_image(
        x, (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"), ZERO_FLUX_SENTINEL,
        marginalize=True, mode="split")
    value_t = torch.where(valid, values, torch.zeros_like(values)).sum()
    value_t.backward()
    assert (tfused.score_split_marg_plain.calls,
            tfused.marg_unit_split_plain.calls,
            tfused.fused_backward_marg_plain.calls) == (1, 1, 1)

    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))


def prior_gradient(gmm, flux, forward_dial, backward_dial):
    """The marginalised prior's value and gradient at ``flux``, the
    forward under one dial and ``.backward()`` under another."""
    prior = jt.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False,
                             marginalize=True)
    x = flux.clone().requires_grad_(True)
    saved = config.gmm_precision()
    try:
        config.set_gmm_precision(forward_dial)
        value = prior(x)
        config.set_gmm_precision(backward_dial)
        value.backward()
    finally:
        config.set_gmm_precision(saved)
    return value.item(), x.grad


@pytest.fixture(scope="module")
def routing_case():
    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    flux = torch.as_tensor(np.random.RandomState(3).uniform(
        0.1, 2.0, (1, 1, 32, 40)).astype(np.float32))
    return gmm, flux


@pytest.mark.parametrize("dial,mode", [("highest", "f32"), ("high", "split"),
                                       ("default", "bf16")])
def test_dial_routes_the_marginalised_prior(routing_case, dial, mode):
    """``"high"`` takes the split plain versions of the logsumexp forward
    and of the marginalise backward, once each, ``"default"`` the
    single-bf16 ones; ``"highest"`` the float32 ones."""
    gmm, flux = routing_case
    tfused.reset_counters()
    prior_gradient(gmm, flux, dial, dial)
    for m in ("split", "bf16"):
        assert (tfused.PLAIN_SCORES[m, True].calls,
                tfused.PLAIN_UNITS[m].calls) == (int(m == mode),
                                                 int(m == mode))
        assert tfused.PLAIN_SCORES[m, False].calls == 0
    assert tfused.score_plain.calls == int(mode == "f32")
    assert (tfused.fused_forward_plain.calls,
            tfused.fused_backward_marg_plain.calls,
            tfused.fused_backward_plain.calls) == (1, 1, 0)


@pytest.mark.parametrize("forward_dial,backward_dial",
                         [("high", "highest"), ("highest", "high")])
def test_backward_follows_the_forward_mode(routing_case, forward_dial,
                                          backward_dial):
    """The dial changes between the forward and ``.backward()``: the
    backward still recomputes the logits of the forward's mode, so that
    its weights are taken against a logsumexp of the same arithmetic,
    and the gradient is that of a run under the forward's dial alone."""
    gmm, flux = routing_case
    split = forward_dial != "highest"
    tfused.reset_counters()
    value, grad = prior_gradient(gmm, flux, forward_dial, backward_dial)
    assert (tfused.score_split_marg_plain.calls,
            tfused.marg_unit_split_plain.calls) == (int(split), int(split))
    assert tfused.score_plain.calls == int(not split)
    value_ref, grad_ref = prior_gradient(gmm, flux, forward_dial,
                                         forward_dial)
    assert value == value_ref
    assert torch.equal(grad, grad_ref)


def test_split_marg_kernels_need_a_card():
    """The wrappers of the two tensor-core kernels raise on a CPU tensor
    (no fallback)."""
    bufs = jt.GaussianMixtureModel.from_registry(
        "builtin-8x8-v1").kernel_buffers("cpu")
    image = torch.as_tensor(make_image((16, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        tfused.gmm_fused_fwd_marg_tc_cuda(image, bufs, STRIDE,
                                          ZERO_FLUX_SENTINEL)
    lse, _, valid, xtn = tfused.fused_forward_plain(
        image, bufs, STRIDE, ZERO_FLUX_SENTINEL, True, mode="split")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.gmm_fused_bwd_marg_tc_cuda(xtn, lse, valid, valid, bufs,
                                          (16, 128), STRIDE)
