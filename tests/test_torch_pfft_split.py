"""The matrix-DFT convolution's ``"split"`` mode against the JAX package's.

``"split"`` is the precision dial's default (``"high"``): each stage-B
product of the three passes as three bf16 products with float32 sums.
The port's plain version computes them as its tensor-core kernels do, as
a real product of interleaved complex rows with the interleaved real
form ``R`` of each stage matrix; the JAX package runs its Pallas kernels
in the interpreter, in its ``"split"`` mode (Karatsuba's 3 complex
products). Tolerances, each with its reason:

- ``R`` reproduces the complex product to float64 rounding (1e-12) (the
  kernels' tables, the planes of ``R``'s bf16 hi and lo parts, are held in
  ``tests/test_torch_pfft_wg.py``);
- the convolution and its gradient within ``3.1e-5 x`` their max-abs of
  the JAX package's: split's documented error at the benchmark shape
  (``jolideco_tpu/ops/pallas_fft.py:86-102``), split against split
  (about 1e-5 measured at these sizes). The second derivative (the
  probe's Hessian action) applies a convolution and then its adjoint to
  the first one's result, so the two split errors add: twice that bar
  (5.4e-5 measured);
- the mode is honoured: against float64, the split plain version's error
  is at least 3x the float32 one's (about 15x measured).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from jolideco_torch.ops import pallas_fft as pf
from jolideco_tpu.ops import pallas_fft as jpf

torch.set_num_threads(1)
SPLIT_BAR = 3.1e-5
CASES = [(2, 128, 128, 9), (2, 256, 256, 33), (1, 128, 256, 9)]


def setup(seed, p_=2, h=128, w=128, k=9):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((p_, h, w)).astype(np.float32)
    x1 = rng.standard_normal((p_, h, w)).astype(np.float32)
    n = pf.pfft_size(max(h, w) + k - 1)
    planes = [pf.pfft_pair_spectra(rng.random((k, k)), rng.random((k, k)),
                                   (h, w), n) for _ in range(p_)]
    spectra = [np.stack([p[j] for p in planes]) for j in range(4)]
    return x0, x1, n, spectra


@pytest.mark.parametrize("m", [2, 3])
def test_interleaved_matrices_reproduce_the_complex_product(m):
    t = pf._stage_tables(m)
    for name in ("mf", "mi"):
        mat = t[name]
        r = pf.interleaved_stage_matrices(m)[name]
        assert r.shape == (m, 256, 256) and r.dtype == np.float32
        # R's entries are the complex table's planes in float32
        assert_array_equal(r[:, 0::2, 0::2], mat.real.astype(np.float32))
        assert_array_equal(r[:, 1::2, 0::2], -mat.imag.astype(np.float32))
        # the same layout in float64 gives x . M for a complex row
        rr = np.empty((m, 256, 256))
        rr[:, 0::2, 0::2], rr[:, 0::2, 1::2] = mat.real, mat.imag
        rr[:, 1::2, 0::2], rr[:, 1::2, 1::2] = -mat.imag, mat.real
        assert_array_equal(rr.astype(np.float32), r)
        rng = np.random.default_rng(m)
        x = rng.standard_normal((m, 5, 128)) + 1j * rng.standard_normal(
            (m, 5, 128))
        want = np.einsum("kri,kij->krj", x, mat)
        xi = x.view(np.float64).reshape(m, 5, 256)
        got = (xi @ rr).view(np.complex128).reshape(m, 5, 128)
        assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_bf16_split():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9 + 2.0 ** -20,
                      -3.14159265, 1e-30])
    hi, lo = pf.bf16_split(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(lo, (x - hi).to(torch.bfloat16).float())
    assert float((hi + lo - x).abs().max()) <= 2.0 ** -16 * 3.2


@pytest.mark.parametrize("p_,h,w,k", CASES)
def test_split_plain_matches_jax_split(p_, h, w, k):
    x0, x1, n, spectra = setup(0, p_, h, w, k)
    j0, j1 = jpf.conv_packed_pfft(jnp.asarray(x0), jnp.asarray(x1),
                                  *map(jnp.asarray, spectra), n, "split",
                                  True)
    pf.reset_counters()
    xs = [torch.as_tensor(v) for v in (x0, x1)]
    planes = list(map(torch.as_tensor, spectra))
    y0, y1 = pf.conv_packed_pfft(*xs, *planes, n, mode="split")
    assert pf.conv_packed_pfft_plain.calls == 1
    assert pf.pfft_rows_combine_tc_cuda.launches == 0
    scale = float(np.abs(np.asarray(j0)).max())
    assert_allclose(y0.numpy(), np.asarray(j0), rtol=0,
                    atol=SPLIT_BAR * scale)
    assert_allclose(y1.numpy(), np.asarray(j1), rtol=0,
                    atol=SPLIT_BAR * scale)

    # the mode is honoured: split's error against float64 is bf16's
    y64 = pf.conv_packed_pfft_plain(*(v.double() for v in xs), *planes, n,
                                    dtype=torch.float64)
    y32 = pf.conv_packed_pfft_plain(*xs, *planes, n)
    err = {name: max(float((a.double() - b).abs().max())
                     for a, b in zip(ys, y64))
           for name, ys in (("split", (y0, y1)), ("f32", y32))}
    assert err["split"] >= 3.0 * err["f32"]
    assert err["split"] <= SPLIT_BAR * scale
    # float64 ignores the mode: it is the anchor
    y64s = pf.conv_packed_pfft_plain(*(v.double() for v in xs), *planes, n,
                                     dtype=torch.float64, mode="split")
    for a, b in zip(y64s, y64):
        assert torch.equal(a, b)


@pytest.mark.parametrize("conj_spec", [False, True])
def test_split_passes_match_f32_passes(conj_spec):
    """Each pass under ``"split"`` against the same pass in float64, on
    the same inputs: within split's bar, and further off than
    ``"f32"``."""
    x0, x1, n, spectra = setup(7, 1, 128, 256, 9)
    planes = list(map(torch.as_tensor, spectra))
    u = pf.cols_fwd_plain(torch.as_tensor(x0), torch.as_tensor(x1), n)
    v64 = pf.rows_combine_plain(u.to(torch.complex128), *planes, conj_spec,
                                torch.float64)
    for mode in ("f32", "split"):
        v = pf.rows_combine_plain(u, *planes, conj_spec, mode=mode)
        for a, b in zip(v, v64):
            scale = float(b.abs().max())
            assert float((a.to(b.dtype) - b).abs().max()) <= (
                SPLIT_BAR * scale)
    v = pf.rows_combine_plain(u, *planes, conj_spec, mode="split")
    y64 = pf.cols_inv_plain(*(t.to(torch.complex128) for t in v), 128,
                            torch.float64)
    y32 = pf.cols_inv_plain(*v, 128)
    ys = pf.cols_inv_plain(*v, 128, mode="split")
    scale = max(float(t.abs().max()) for t in y64)
    e32 = max(float((a.double() - b).abs().max()) for a, b in zip(y32, y64))
    es = max(float((a.double() - b).abs().max()) for a, b in zip(ys, y64))
    assert 3.0 * e32 <= es <= SPLIT_BAR * scale


def loss_terms(y0, y1, sin):
    return (y0 * y0).sum() + sin(y1).sum()


def test_split_gradient_matches_jax_vjp():
    x0, x1, n, spectra = setup(1)
    js = tuple(map(jnp.asarray, spectra))

    def loss_j(a, b):
        return loss_terms(*jpf.conv_packed_pfft(a, b, *js, n, "split", True),
                          jnp.sin)

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(x1))
    xs = [torch.as_tensor(x).requires_grad_(True) for x in (x0, x1)]
    y0, y1 = pf.conv_packed_pfft(*xs, *map(torch.as_tensor, spectra), n,
                                 mode="split")
    loss_terms(y0, y1, torch.sin).backward()
    scale = float(np.abs(np.asarray(g_j[0])).max())
    for x, g in zip(xs, g_j):
        assert_allclose(x.grad.numpy(), np.asarray(g), rtol=0,
                        atol=SPLIT_BAR * scale)


def test_split_second_derivative_matches_jax():
    """Reverse over reverse in the port, ``jvp`` of ``vjp`` in the JAX
    package, both in ``"split"``: the probe's Hessian action along
    ones."""
    x0, x1, n, spectra = setup(4, p_=1)
    c = np.random.default_rng(5).random((1, 128, 128)).astype(np.float32)
    js = tuple(map(jnp.asarray, spectra))

    def loss_j(a):
        y0, y1 = jpf.conv_packed_pfft(a, jnp.asarray(x1), *js, n, "split",
                                      True)
        return jnp.mean(c * jnp.sin(y0)) + jnp.mean(y1 * y1)

    ones = jnp.ones_like(jnp.asarray(x0))
    hvp_j = np.asarray(jax.jvp(jax.grad(loss_j), (jnp.asarray(x0),),
                               (ones,))[1])

    x = torch.as_tensor(x0).requires_grad_(True)
    pf.reset_counters()
    y0, y1 = pf.conv_packed_pfft(x, torch.as_tensor(x1),
                                 *map(torch.as_tensor, spectra), n,
                                 mode="split")
    loss = (torch.as_tensor(c) * torch.sin(y0)).mean() + (y1 * y1).mean()
    (grad,) = torch.autograd.grad(loss, x, create_graph=True)
    (hvp,) = torch.autograd.grad(grad, x, grad_outputs=torch.ones_like(x))
    assert pf.conv_packed_pfft_plain.calls == 4
    scale = float(np.abs(hvp_j).max())
    assert scale > 0
    assert_allclose(hvp.numpy(), hvp_j, rtol=0, atol=2 * SPLIT_BAR * scale)


def test_split_adjoint_identity():
    """``<conv(x), g> = <x, conv_adj(g)>`` under ``"split"``, to split's
    error: the adjoint is the split pipeline with ``conj_spec``."""
    x0, x1, n, spectra = setup(2, p_=1, h=128, w=256)
    rng = np.random.default_rng(3)
    x = [torch.as_tensor(v) for v in (x0, x1)]
    g = [torch.as_tensor(rng.standard_normal(x0.shape).astype(np.float32))
         for _ in range(2)]
    planes = list(map(torch.as_tensor, spectra))
    y = pf.conv_packed_pfft_plain(*x, *planes, n, mode="split")
    d = pf.conv_packed_pfft_plain(*g, *planes, n, conj_spec=True,
                                  mode="split")
    lhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(y, g))
    rhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(x, d))
    norm = sum(float(a.double().norm() * b.double().norm())
               for a, b in zip(y, g))
    assert abs(lhs - rhs) <= SPLIT_BAR * norm

    xs = [v.clone().requires_grad_(True) for v in x]
    out = pf.conv_packed_pfft(*xs, *planes, n, mode="split")
    grads = torch.autograd.grad(out, xs, grad_outputs=g)
    for got, want in zip(grads, d):
        assert torch.equal(got, want)


def test_tensor_core_wrappers_need_the_card():
    """The bf16 modes' wrappers (the three passes of ``pfft_conv_wg``)
    launch a kernel or raise: a CPU tensor takes the plain version only
    through ``conv_packed_pfft``, never through a wrapper."""
    v = torch.zeros((1, 256, 128), dtype=torch.complex64)
    s = torch.zeros((1, 256, 256))
    x = torch.zeros((1, 128, 128))
    for launch in (lambda: pf.pfft_cols_fwd_tc_cuda(x, x, 256),
                   lambda: pf.pfft_cols_fwd_bf16_cuda(x, x, 256),
                   lambda: pf.pfft_rows_combine_tc_cuda(v, s, s, s, s),
                   lambda: pf.pfft_cols_inv_tc_cuda(v, v, 128)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()


def jax_cols_fwd_split(x0, x1, n, mode="split"):
    """The JAX package's pass 1 (``_k1_body``) in ``"split"`` mode (or
    ``mode``), through ``pl.pallas_call`` in the interpreter, called as
    its ``_pfft_conv_impl`` calls it; returns ``(u_re, u_im)``."""
    from functools import partial

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    p_, h, w = x0.shape
    m = n // jpf.PFFT_LANE
    t = jpf._stage_tables(m)
    mf_t = tuple(jnp.asarray(x) for x in t["mf_t"])
    cc = min(jpf._chunk_sizes(n)[0], w)
    cols = pl.BlockSpec((1, h, cc), lambda p, i: (p, 0, i),
                        memory_space=pltpu.VMEM)
    out = pl.BlockSpec((1, n, cc), lambda p, i: (p, 0, i),
                       memory_space=pltpu.VMEM)
    u_re, u_im = pl.pallas_call(
        partial(jpf._k1_body, m=m, h=h, wf=t["wf"], mode=mode),
        grid=(p_, w // cc),
        in_specs=[cols, cols, *[jpf._const_spec(x) for x in mf_t]],
        out_specs=[out, out],
        out_shape=[jax.ShapeDtypeStruct((p_, n, w), jnp.float32)] * 2,
        interpret=True,
    )(jnp.asarray(x0), jnp.asarray(x1), *mf_t)
    return np.asarray(u_re), np.asarray(u_im)


@pytest.mark.parametrize("p_,h,w,k", [(1, 128, 128, 9), (2, 256, 128, 33)])
def test_split_pass1_matches_jax_k1_split(p_, h, w, k):
    """Pass 1 under ``"split"`` against the JAX package's ``_k1_body`` in
    its split mode (Karatsuba's 3 complex products where the port takes
    4 real ones, so split's bar), and further from float64 than the
    float32 plain version: the mode is honoured."""
    x0, x1, n, _ = setup(6, p_, h, w, k)
    j_re, j_im = jax_cols_fwd_split(x0, x1, n)
    xs = [torch.as_tensor(v) for v in (x0, x1)]
    u = pf.cols_fwd_plain(*xs, n, mode="split")
    assert u.dtype == torch.complex64 and tuple(u.shape) == (p_, n, w)
    scale = max(float(np.abs(j_re).max()), float(np.abs(j_im).max()))
    assert_allclose(u.real.numpy(), j_re, rtol=0, atol=SPLIT_BAR * scale)
    assert_allclose(u.imag.numpy(), j_im, rtol=0, atol=SPLIT_BAR * scale)

    u64 = pf.cols_fwd_plain(*(v.double() for v in xs), n, torch.float64,
                            mode="split")
    assert torch.equal(u64, pf.cols_fwd_plain(*(v.double() for v in xs), n,
                                              torch.float64))
    u32 = pf.cols_fwd_plain(*xs, n)
    e_split = float((u.to(u64.dtype) - u64).abs().max())
    e32 = float((u32.to(u64.dtype) - u64).abs().max())
    assert 3.0 * e32 <= e_split <= SPLIT_BAR * float(u64.abs().max())
