"""Fused GMM scorer of the port against ``jolideco_tpu.ops.gmm_fused``.

The JAX side runs its Pallas kernel in interpret mode on the CPU at
``precision=HIGHEST``, as ``tests/test_gmm_fused.py`` runs it; the port
runs the kernel's plain PyTorch version (a CPU tensor). Tolerances:

- ``valid``: exact, after mapping the JAX package's padded grid onto the
  port's ``(H // 8, W // 8)`` grid (every patch outside it is invalid);
- ``values[valid]``: rtol 1e-5 (float32 quadratic forms summed in
  different orders);
- argmax: exact;
- the image gradient of ``sum(values * valid)``: 1e-4 of its max-abs
  (the JAX backward reads ``A`` as a bf16 hi/lo pair, about 16
  significant bits).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp
from jax import lax

from jolideco_torch.ops import gmm_fused as tfused
from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_tpu.ops.gmm_fused import _padded_dims, gmm_score_fused_image
from jolideco_tpu.priors import GaussianMixtureModel as JGMM
from jolideco_tpu.priors.patches.core import ZERO_FLUX_SENTINEL

torch.set_num_threads(1)
STRIDE = 4
GMM_NAMES = ["builtin-8x8-v1", "astro-snr-v1"]
SHAPES = [(16, 128), (20, 136)]


@pytest.fixture(scope="module", params=GMM_NAMES)
def gmms(request):
    return JGMM.from_registry(request.param), TGMM.from_registry(request.param)


def make_image(shape, seed=7):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:8, :16] = 2.0 * ZERO_FLUX_SENTINEL       # a zero-flux block
    return img


def jax_scores(gmm_j, img, marginalize=False):
    values, argmax, valid = gmm_score_fused_image(
        jnp.asarray(img), (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
        interpret=True, precision=lax.Precision.HIGHEST,
        marginalize=marginalize,
    )
    h, w = img.shape
    hp, wp, _ = _padded_dims(h, w)
    g = (8 // STRIDE) ** 2
    ny, nx = h // 8, w // 8

    def crop(a):
        grid = np.asarray(a).reshape(g, hp // 8, wp // 8)
        outside = np.ones(grid.shape, bool)
        outside[:, :ny, :nx] = False
        return grid[:, :ny, :nx].reshape(-1), grid[outside]

    return crop(values), crop(argmax), crop(valid)


def test_pack_gmm_buffers_matches_jax(gmms):
    gmm_j, gmm_t = gmms
    k = gmm_t.n_components
    for name in ("aq", "bq", "const2"):
        want = np.asarray(gmm_j.packed[name])[:, :k]
        assert_array_equal(gmm_t.packed[name], want, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_interpret_kernel(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape)
    (v_j, _), (a_j, _), (valid_j, valid_j_outside) = jax_scores(gmm_j, img)

    values, argmax, valid = tfused.gmm_score_fused_image(
        torch.as_tensor(img), (8, 8), STRIDE,
        gmm_t.kernel_buffers("cpu"), ZERO_FLUX_SENTINEL,
    )
    assert not valid_j_outside.any()
    assert_array_equal(valid.numpy(), valid_j)
    m = valid.numpy()
    assert 0 < m.sum() < m.size
    assert_allclose(values.numpy()[m], v_j[m], rtol=1e-5)
    assert_array_equal(argmax.numpy()[m], a_j[m])


@pytest.mark.parametrize("shape", SHAPES)
def test_partial_sum_and_image_gradient(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape, seed=11)

    def scalar_j(x):
        values, _, valid = gmm_score_fused_image(
            x, (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
            interpret=True, precision=lax.Precision.HIGHEST,
        )
        return jnp.sum(jnp.where(valid, values, 0.0))

    value_j, grad_j = jax.value_and_grad(scalar_j)(jnp.asarray(img))

    x = torch.as_tensor(img).requires_grad_(True)
    values, _, valid = tfused.gmm_score_fused_image(
        x, (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"), ZERO_FLUX_SENTINEL,
    )
    value_t = torch.where(valid, values, torch.zeros_like(values)).sum()
    value_t.backward()

    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written backward against torch autograd through the
    plain forward's own arithmetic (float32; 1e-5 of the max-abs)."""
    gmm_t = TGMM.from_registry("builtin-8x8-v1")
    bufs = gmm_t.kernel_buffers("cpu")
    img = make_image((24, 128), seed=3)
    x = torch.as_tensor(img).requires_grad_(True)

    padded, masks = tfused._group_slices(x, STRIDE)
    ny, nx = img.shape[0] // 8, img.shape[1] // 8
    patches = torch.cat([
        padded[a:a + 8 * ny, b:b + 8 * nx].reshape(ny, 8, nx, 8)
        .permute(0, 2, 1, 3).reshape(-1, 64)
        for a, b in tfused._offsets(STRIDE)
    ])
    valid = masks.reshape(-1) & (patches > ZERO_FLUX_SENTINEL).all(dim=1)
    z = torch.where(valid[:, None], patches, torch.zeros_like(patches))
    z = z - z.mean(dim=1, keepdim=True)
    u = (z[:, :, None] * z[:, None, :]).reshape(-1, 64 * 64)
    logits = -0.5 * (u @ bufs["aq"]) + z @ bufs["bq"] + bufs["const2"]
    dv = torch.as_tensor(np.random.RandomState(2).randn(len(z)), dtype=torch.float32)
    (logits.max(dim=1).values * valid * dv).sum().backward()

    _, argmax, valid_f, xtn = tfused.fused_forward_plain(
        x.detach(), bufs, STRIDE, ZERO_FLUX_SENTINEL
    )
    grad = tfused.fused_backward_plain(xtn, argmax, valid_f, dv * valid_f,
                                       bufs, img.shape, STRIDE)
    want = x.grad.numpy()
    assert_allclose(grad.numpy(), want, rtol=0,
                    atol=1e-5 * float(np.abs(want).max()))


def test_sym_rows_reproduce_the_quadratic_form():
    """The CUDA kernel's row-padded triangle gives x^T A x (float64)."""
    gmm_t = TGMM.from_registry("builtin-8x8-v1")
    a_quad = gmm_t.packed["a_quad"][:3]
    sym = tfused._sym_rows(a_quad)
    x = np.random.RandomState(0).randn(64)
    got, off = np.zeros(3), 0
    for r in range(64):
        c0 = r & ~3
        got += x[r] * (sym[:, off:off + 64 - c0] @ x[c0:])
        off += 64 - c0
    want = np.einsum("i,kij,j->k", x, a_quad, x)
    assert_allclose(got, want, rtol=1e-12)


def test_fused_supported_is_the_jax_rule_without_its_width_floor():
    """Same rule as the JAX package, except that the JAX package also asks
    for an image at least 128 px wide (its TPU lane tiling)."""
    from jolideco_tpu.ops.gmm_fused import fused_supported as j_supported

    for shape in [(16, 128), (8, 1024), (7, 256), (64, 120), (8, 8),
                  (1000, 904)]:
        for stride in (1, 2, 3, 4, 8):
            want = j_supported((shape[0], max(shape[1], 128)), (8, 8),
                               stride, 64) and shape[1] >= 8
            assert tfused.fused_supported(shape, (8, 8), stride, 64) == want
    assert not tfused.fused_supported((16, 128), (4, 4), 2, 16)
