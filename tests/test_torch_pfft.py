"""The port's matrix-DFT convolution against the JAX package's.

The JAX side runs its three Pallas kernels in the interpreter, in the
``"f32"`` mode, as ``tests/test_pallas_fft.py`` does; the port runs its
plain version (CPU tensors). Inputs are made with numpy from a seed.
Tolerances, each with its reason:

- the stage tables (complex128) reproduce numpy's DFT and its inverse
  to float64 rounding (rtol 1e-10), and their float32 planes equal the
  JAX package's exactly; the host spectra equal the JAX package's exactly
  (the same float64 numpy); the device spectra (``torch.fft`` in float64)
  match them to float32 rounding (6e-8 of the max-abs);
- the convolution, its gradient and its second derivative: within
  ``2e-5 × max|y|`` of the JAX kernels' (the JAX tests' own bar for the
  values; both sides are float32 sums in other orders);
- the adjoint identity and ``gradgradcheck`` in float64.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from jolideco_torch.ops import pallas_fft as pf
from jolideco_torch.ops.fft import convolve_fft_packed_pair, kernel_fft_pair
from jolideco_tpu.ops import pallas_fft as jpf

torch.set_num_threads(1)
BAR = 2e-5


def test_pfft_size_and_permutation_match_jax():
    for n in (1, 128, 129, 1056, 1152):
        assert pf.pfft_size(n) == jpf.pfft_size(n)
    for n in (128, 384, 1152):
        assert_array_equal(pf._perm(n), jpf._perm(n))
    # storage position 128 k2 + k1 holds frequency m k1 + k2
    p = pf._perm(384)
    for pos in (0, 1, 127, 128, 130, 383):
        k2, k1 = divmod(pos, 128)
        assert p[pos] == 3 * k1 + k2


@pytest.mark.parametrize("m", [1, 2, 3])
def test_stage_tables_reconstruct_the_dft(m):
    """Stage A then stage B gives numpy's forward DFT in permuted order,
    and stage B then stage A its inverse in natural order; the planes
    are the JAX package's."""
    n = 128 * m
    t = pf._stage_tables(m)
    rng = np.random.default_rng(m)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    s = t["wf"].T @ x.reshape(m, 128)                 # s[k2] = sum_n2 ...
    fwd = np.stack([s[k2] @ t["mf"][k2] for k2 in range(m)]).ravel()
    assert_allclose(fwd, np.fft.fft(x)[pf._perm(n)], rtol=1e-10,
                    atol=1e-9 * n)
    g = np.stack([fwd.reshape(m, 128)[k2] @ t["mi"][k2] for k2 in range(m)])
    assert_allclose((t["wi"] @ g).ravel(), x, rtol=1e-10, atol=1e-12 * n)

    j = jpf._stage_tables(m)
    assert_array_equal(t["mf"].real.astype(np.float32), j["mf"][0])
    assert_array_equal(t["mf"].imag.astype(np.float32), j["mf"][1])
    assert_array_equal(t["mi"].real.astype(np.float32), j["mi"][0])
    assert_array_equal(t["mi"].imag.astype(np.float32), j["mi"][1])
    assert_allclose(t["wf"], np.array(j["wf"])[..., 0]
                    + 1j * np.array(j["wf"])[..., 1], atol=1e-15)


def setup(seed, p_=2, h=128, w=128, k=9):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((p_, h, w)).astype(np.float32)
    x1 = rng.standard_normal((p_, h, w)).astype(np.float32)
    kernels = [(rng.random((k, k)), rng.random((k, k))) for _ in range(p_)]
    n = pf.pfft_size(max(h, w) + k - 1)
    planes = [pf.pfft_pair_spectra(k0, k1, (h, w), n) for k0, k1 in kernels]
    spectra = [np.stack([p[j] for p in planes]) for j in range(4)]
    return x0, x1, kernels, n, spectra


def test_pair_spectra_match_jax():
    rng = np.random.default_rng(1)
    k0, k1 = rng.random((9, 9)), rng.random((7, 7))
    for shape, n in (((128, 128), 256), ((128, 256), 384)):
        port = pf.pfft_pair_spectra(k0, k1, shape, n)
        for got, want in zip(port, jpf.pfft_pair_spectra(k0, k1, shape, n)):
            assert_array_equal(got, want)
    stack0 = np.stack([rng.random((9, 9)) for _ in range(3)])
    stack1 = np.stack([rng.random((9, 9)) for _ in range(3)])
    device = pf.pfft_pair_spectra_device(torch.as_tensor(stack0)[:, None],
                                         torch.as_tensor(stack1)[:, None],
                                         (128, 256), 384)
    host = [np.stack([pf.pfft_pair_spectra(a, b, (128, 256), 384)[j]
                      for a, b in zip(stack0, stack1)]) for j in range(4)]
    scale = max(np.abs(h).max() for h in host)
    for got, want in zip(device, host):
        assert got.shape == (3, 1, 384, 384) and got.dtype == torch.float32
        assert_allclose(got[:, 0].numpy(), want, rtol=0, atol=6e-8 * scale)
    with pytest.raises(ValueError, match="multiple of"):
        pf.pfft_pair_spectra(k0, k1, (128, 128), 200)
    with pytest.raises(ValueError, match="too small"):
        pf.pfft_pair_spectra(k0, k1, (128, 128), 128)


@pytest.mark.parametrize("p_,h,w,k", [
    (2, 128, 128, 9), (2, 256, 256, 33), (1, 128, 256, 9),
])
def test_plain_matches_jax_kernels(p_, h, w, k):
    x0, x1, kernels, n, spectra = setup(0, p_, h, w, k)
    j0, j1 = jpf.conv_packed_pfft(jnp.asarray(x0), jnp.asarray(x1),
                                  *map(jnp.asarray, spectra), n, "f32", True)
    pf.reset_counters()
    y0, y1 = pf.conv_packed_pfft(torch.as_tensor(x0), torch.as_tensor(x1),
                                 *map(torch.as_tensor, spectra), n)
    assert pf.conv_packed_pfft_plain.calls == 1
    assert pf.pfft_cols_fwd_cuda.launches == 0
    scale = float(np.abs(np.asarray(j0)).max())
    assert_allclose(y0.numpy(), np.asarray(j0), rtol=0, atol=BAR * scale)
    assert_allclose(y1.numpy(), np.asarray(j1), rtol=0, atol=BAR * scale)

    # the cuFFT yardstick computes the same function
    for i, (k0, k1) in enumerate(kernels):
        a, b = kernel_fft_pair(torch.as_tensor(k0), torch.as_tensor(k1),
                               (h, w), (n, n))
        r0, r1 = convolve_fft_packed_pair(torch.as_tensor(x0[i]),
                                          torch.as_tensor(x1[i]), a, b,
                                          (n, n))
        assert_allclose(r0.numpy(), y0[i].numpy(), rtol=0,
                        atol=BAR * scale)
        assert_allclose(r1.numpy(), y1[i].numpy(), rtol=0,
                        atol=BAR * scale)


def loss_terms(y0, y1, sin):
    return (y0 * y0).sum() + sin(y1).sum()


def test_gradient_matches_jax_vjp():
    x0, x1, _, n, spectra = setup(1)
    js = tuple(map(jnp.asarray, spectra))

    def loss_j(a, b):
        return loss_terms(*jpf.conv_packed_pfft(a, b, *js, n, "f32", True),
                          jnp.sin)

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(x1))
    xs = [torch.as_tensor(x).requires_grad_(True) for x in (x0, x1)]
    y0, y1 = pf.conv_packed_pfft(*xs, *map(torch.as_tensor, spectra), n)
    loss_terms(y0, y1, torch.sin).backward()
    scale = float(np.abs(np.asarray(g_j[0])).max())
    for x, g in zip(xs, g_j):
        assert_allclose(x.grad.numpy(), np.asarray(g), rtol=0,
                        atol=BAR * scale)


def test_adjoint_identity():
    """``<conv(x), g> = <x, conv_adj(g)>`` in float64, for the plain
    version (``conj_spec``) and for the autograd rule."""
    x0, x1, _, n, spectra = setup(2, p_=1, h=128, w=256)
    rng = np.random.default_rng(3)
    x = [torch.as_tensor(v, dtype=torch.float64) for v in (x0, x1)]
    g = [torch.as_tensor(rng.standard_normal(x0.shape)) for _ in range(2)]
    planes = list(map(torch.as_tensor, spectra))
    y = pf.conv_packed_pfft_plain(*x, *planes, n, dtype=torch.float64)
    d = pf.conv_packed_pfft_plain(*g, *planes, n, conj_spec=True,
                                  dtype=torch.float64)
    lhs = sum(float((a * b).sum()) for a, b in zip(y, g))
    rhs = sum(float((a * b).sum()) for a, b in zip(x, d))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)

    xs = [v.clone().requires_grad_(True) for v in x]
    out = pf.conv_packed_pfft(*xs, *planes, n)
    grads = torch.autograd.grad(out, xs, grad_outputs=g)
    for got, want in zip(grads, d):
        assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_second_derivative_matches_jax():
    """Reverse over reverse in the port, ``jvp`` of ``vjp`` in the JAX
    package: the probe's Hessian action along ones."""
    x0, x1, _, n, spectra = setup(4, p_=1)
    c = np.random.default_rng(5).random((1, 128, 128)).astype(np.float32)
    js = tuple(map(jnp.asarray, spectra))

    def loss_j(a):
        y0, y1 = jpf.conv_packed_pfft(a, jnp.asarray(x1), *js, n, "f32",
                                      True)
        return jnp.mean(c * jnp.sin(y0)) + jnp.mean(y1 * y1)

    ones = jnp.ones_like(jnp.asarray(x0))
    hvp_j = np.asarray(jax.jvp(jax.grad(loss_j), (jnp.asarray(x0),),
                               (ones,))[1])

    x = torch.as_tensor(x0).requires_grad_(True)
    pf.reset_counters()
    y0, y1 = pf.conv_packed_pfft(x, torch.as_tensor(x1),
                                 *map(torch.as_tensor, spectra), n)
    loss = (torch.as_tensor(c) * torch.sin(y0)).mean() + (y1 * y1).mean()
    (grad,) = torch.autograd.grad(loss, x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x, grad_outputs=torch.ones_like(x))
    # forward, its adjoint, then the adjoint's adjoint and the adjoint
    assert pf.conv_packed_pfft_plain.calls == 4
    scale = float(np.abs(hvp_j).max())
    assert scale > 0
    assert_allclose(hvp.numpy(), hvp_j, rtol=0, atol=BAR * scale)


def test_twice_differentiable_in_float64():
    x0, x1, _, n, spectra = setup(6, p_=1)
    planes = list(map(torch.as_tensor, spectra))
    xs = tuple(torch.as_tensor(v[:, :, :]).double().requires_grad_(True)
               for v in (x0, x1))

    def fn(a, b):
        y0, y1 = pf.conv_packed_pfft(a, b, *planes, n)
        return y0 * y1

    assert torch.autograd.gradgradcheck(fn, xs, eps=1e-6, atol=1e-6,
                                        nondet_tol=0.0, fast_mode=True)


def test_validation():
    x = torch.zeros((1, 100, 128))
    s = torch.zeros((1, 256, 256))
    with pytest.raises(ValueError, match="multiples of"):
        pf.conv_packed_pfft(x, x, s, s, s, s, 256)
    x = torch.zeros((1, 128, 128))
    with pytest.raises(ValueError, match="invalid pfft mode"):
        pf.conv_packed_pfft(x, x, s, s, s, s, 256, mode="tf32")
    for launch in (lambda: pf.pfft_cols_fwd_cuda(x, x, 256),
                   lambda: pf.pfft_cols_inv_cuda(
                       torch.zeros((1, 256, 128), dtype=torch.complex64),
                       torch.zeros((1, 256, 128), dtype=torch.complex64),
                       128)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()


def test_precision_dial_names_the_mode():
    from jolideco_torch import config

    try:
        for dial, mode in (("highest", "f32"), ("high", "split"),
                           ("default", "bf16")):
            config.set_gmm_precision(dial)
            assert pf.default_pfft_mode() == mode
    finally:
        config.set_gmm_precision("high")
