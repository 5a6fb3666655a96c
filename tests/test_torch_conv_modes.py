"""The convolution backends ``conv_mode="ct"``, ``"mxu"`` and ``"direct"``
of the port against ``jolideco_tpu`` on the CPU.

Numpy inputs from seeds go through the JAX package's functions and the
port's: the transforms' shapes and tables (``ops/ct_conv.py``,
``ops/fft_mxu.py``), the permuted DFTs, the convolutions and their
adjoints, the stacked loss under each mode, a 20-epoch joint run at x2
with calibrations and the flux-error probe. Bars, each with its reason:

- shapes, factors and tables: equal;
- the transforms, the convolutions and their adjoints (JAX's custom VJP
  against the port's ``torch.autograd.Function``): within 2e-6 of the
  result's max-abs, both ``"split3"`` and ``"highest"`` (the same split
  products, float32 sums in another order); against float64 numpy, the
  JAX package's own bars, 5e-5 (``"split3"``) and 5e-6 (``"highest"``,
  ``tests/test_ct_conv.py:78-81``);
- the stacked loss: per-observation losses rtol 1e-5 and the flux
  gradient within 1e-5 of its max-abs (``tests/test_torch_stacked.py``'s
  bars);
- 20 joint epochs and the probe: flux and errors rtol 1e-4
  (``BASELINE.md``'s end-to-end bar), under ``UniformPrior`` (no random
  draws).
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
from jolideco_torch.ops import ct_conv as tc
from jolideco_torch.ops import fft_mxu as tm
from jolideco_torch.ops.fft import convolve_fft_numpy
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_tpu.data import gauss_and_point_sources_gauss_psf
from jolideco_tpu.ops import ct_conv as jc
from jolideco_tpu.ops import fft_mxu as jm
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

torch.set_num_threads(1)
OP_SHARE = 2e-6
EPOCHS = 20
PRECISIONS = {"split3": "split3", "highest": lax.Precision.HIGHEST}


def within(got, want, share=OP_SHARE):
    want = np.asarray(want)
    assert_allclose(np.asarray(got), want, rtol=0,
                    atol=share * float(np.abs(want).max()))


def test_shapes_and_factors_match_jax():
    sizes = list(range(40, 2201, 17)) + [1056, 2080]
    for n in sizes:
        assert tc.ct_factor(n) == jc.ct_factor(n), n
        assert tc.ct_conv_shape(n) == jc.ct_conv_shape(n), n
        assert tm.mxu_conv_shape(n) == jm.mxu_conv_shape(n), n
    # the main path's transforms (1024 + 33 - 1), and at x2
    assert tc.ct_conv_shape(1056) == 1089 and tc.ct_factor(1089) == (121, 9)
    assert tc.ct_conv_shape(2080) == 2091 and tc.ct_factor(2091) == (123, 17)
    assert tm.mxu_conv_shape(1056) == 1056 and tm._split_size(1056) == (32, 33)


CT_SHAPES = [((72, 96), None), ((66, 64), ((22, 3), (16, 4))),
             ((40, 40), ((40, 1), (8, 5)))]


@pytest.mark.parametrize("fft_shape,factors", CT_SHAPES)
def test_ct_dft2_matches_jax(fft_shape, factors):
    tables_j = jc.make_ct_tables(fft_shape, factors)
    tables_t = tc.make_ct_tables(fft_shape, factors)
    assert set(tables_t) == set(tables_j)
    for key, table in tables_j.items():
        assert_array_equal(tables_t[key].numpy(), np.asarray(table), key)
    x = np.random.RandomState(1).rand(2, *fft_shape).astype(np.float32)
    for name in ("ct_dft2", "ct_idft2"):
        want = getattr(jc, name)(jnp.asarray(x), tables_j)
        got = getattr(tc, name)(torch.as_tensor(x), tables_t)
        within(got.real.numpy(), jnp.real(want))
        within(got.imag.numpy(), jnp.imag(want))
    # against numpy's FFT in the permuted layout, and back
    if factors is None:
        factors = (tc.ct_factor(fft_shape[0]), tc.ct_factor(fft_shape[1]))
    ref = np.fft.fft2(x.astype(np.float64))
    ref = ref[..., tc._perm_index(fft_shape[0], factors[0][0]), :][
        ..., :, tc._perm_index(fft_shape[1], factors[1][0])]
    z = tc.ct_dft2(torch.as_tensor(x), tables_t).numpy()
    scale = np.abs(ref).max()
    assert_allclose(z / scale, ref / scale, atol=5e-5)
    back = tc.ct_idft2(tc.ct_dft2(torch.as_tensor(x), tables_t), tables_t)
    assert_allclose(back.real.numpy(), x, atol=5e-5)


def test_neg_freq_is_the_natural_negation():
    n, n1 = 24, 4
    perm = tc._perm_index(n, n1)
    x_nat = np.arange(100, 100 + n)
    got = tc._neg_freq_last(torch.as_tensor(x_nat[perm]), n // n1).numpy()
    assert_array_equal(got, x_nat[(-perm) % n])
    assert_array_equal(got, np.asarray(jc._neg_freq_last(
        jnp.asarray(x_nat[perm]), n // n1)))


def test_mxu_dft2_and_tables_match_jax():
    shape = (24, 36)
    tables_j, tables_t = jm.make_dft_tables(shape), tm.make_dft_tables(shape)
    assert set(tables_t) == set(tables_j)
    for key, table in tables_j.items():
        assert_array_equal(tables_t[key].numpy(), np.asarray(table), key)
    x = np.random.RandomState(1).rand(2, *shape).astype(np.float32)
    want = jm.mxu_dft2(jnp.asarray(x).astype(jnp.complex64), tables_j)
    got = tm.mxu_dft2(torch.as_tensor(x).to(torch.complex64), tables_t)
    within(got.real.numpy(), jnp.real(want))
    within(got.imag.numpy(), jnp.imag(want))
    back = tm.mxu_idft2(got, tables_t)
    assert_allclose(back.real.numpy(), x, atol=1e-5)


def conv_inputs(seed=2, h=40, w=56):
    rs = np.random.RandomState(seed)
    k0, k1 = rs.rand(13, 11), rs.rand(9, 15)
    x0, x1, g0, g1 = (rs.rand(3, 1, h, w).astype(np.float32)
                      for _ in range(4))
    return k0, k1, x0, x1, g0 - 0.5, g1 - 0.5


def jax_vjp(fn, args, cotangents):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    outs = out if isinstance(out, tuple) else (out,)
    cts = tuple(jnp.asarray(c) for c in cotangents)
    return outs, vjp(cts if isinstance(out, tuple) else cts[0])


def torch_vjp(fn, args, cotangents):
    xs = [torch.as_tensor(a).requires_grad_(True) for a in args]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, xs, [torch.as_tensor(np.asarray(c))
                                           for c in cotangents])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("op", ["ct_pair", "ct_single", "mxu"])
def test_convolution_and_adjoint_match_jax(op, precision):
    """Values and adjoints (the JAX package's custom VJPs; its autodiff
    through the stages for ``mxu``) within 2e-6 of the max-abs; both
    images of a pair against float64 numpy within the JAX package's bars
    (5e-5 split3, 5e-6 highest)."""
    k0, k1, x0, x1, g0, g1 = conv_inputs()
    h, w = x0.shape[-2:]
    prec_j = PRECISIONS[precision]
    if op == "mxu":
        fs = (tm.mxu_conv_shape(h + 12), tm.mxu_conv_shape(w + 14))
        tables_j, tables_t = jm.make_dft_tables(fs), tm.make_dft_tables(fs)
        kernel = k0.astype(np.float32)
        spec_j = jm.mxu_kernel_spectrum(jnp.asarray(kernel), fs, tables_j)
        spec_t = tm.mxu_kernel_spectrum(torch.as_tensor(kernel), fs,
                                        tables_t)
        within(spec_t.real.numpy(), jnp.real(spec_j))
        within(spec_t.imag.numpy(), jnp.imag(spec_j))
        (y_j,), (d_j,) = jax_vjp(
            lambda a: jm.mxu_convolve(a, spec_j, tables_j, fs, prec_j),
            (x0,), (g0,))
        (y_t,), (d_t,) = torch_vjp(
            lambda a: tm.mxu_convolve(a, spec_t, tables_t, fs, precision),
            (x0,), (g0,))
        pairs = [(y_t, y_j, x0, kernel)]
        adjoints = [(d_t, d_j)]
    else:
        fs = (tc.ct_conv_shape(h + 14), tc.ct_conv_shape(w + 14))
        tables_j, tables_t = jc.make_ct_tables(fs), tc.make_ct_tables(fs)
        if op == "ct_pair":
            spec_j = jc.ct_kernel_pair(k0, k1, (h, w), fs)
            spec_t = tc.ct_kernel_pair(k0, k1, (h, w), fs)
            for got, want in zip(spec_t, spec_j):
                assert_array_equal(got.numpy(), np.asarray(want))
            ys_j, ds_j = jax_vjp(lambda a, b: jc.ct_convolve_pair(
                a, b, *spec_j, tables_j, fs, prec_j), (x0, x1), (g0, g1))
            ys_t, ds_t = torch_vjp(lambda a, b: tc.ct_convolve_pair(
                a, b, *spec_t, tables_t, fs, precision), (x0, x1), (g0, g1))
            pairs = [(ys_t[0], ys_j[0], x0, k0), (ys_t[1], ys_j[1], x1, k1)]
            adjoints = list(zip(ds_t, ds_j))
        else:
            embedded = np.stack([np.roll(np.pad(
                k, ((0, fs[0] - k.shape[0]), (0, fs[1] - k.shape[1]))),
                (-((k.shape[0] - 1) // 2), -((k.shape[1] - 1) // 2)),
                (0, 1)) for k in (k0, k0, k0)]).astype(np.float32)[:, None]
            fr_j, fi_j = jc.ct_kernel_spectra(jnp.asarray(embedded),
                                              tables_j)
            fr_t, fi_t = tc.ct_kernel_spectra(torch.as_tensor(embedded),
                                              tables_t)
            within(fr_t.numpy(), fr_j)
            within(fi_t.numpy(), fi_j)
            (y_j,), (d_j,) = jax_vjp(
                lambda a: jc.ct_convolve_single(a, fr_j, fi_j, tables_j, fs,
                                                prec_j), (x0,), (g0,))
            (y_t,), (d_t,) = torch_vjp(
                lambda a: tc.ct_convolve_single(a, fr_t, fi_t, tables_t, fs,
                                                precision), (x0,), (g0,))
            pairs = [(y_t, y_j, x0, k0)]
            adjoints = [(d_t, d_j)]
    tol = 5e-5 if precision == "split3" else 5e-6
    for got, want, x, k in pairs:
        within(got, want)
        ref = np.stack([convolve_fft_numpy(img[0], k) for img in x])[:, None]
        within(got, ref, tol)
    for got, want in adjoints:
        within(got, want)


def test_dft_conv_plan_matches_jax():
    """``DFTConvPlan`` (``"highest"``: complex64 products) against the
    JAX package's plan: the transform shape, the spectra and a
    convolution within 2e-6 of the max-abs."""
    rs = np.random.RandomState(5)
    kernel = rs.rand(2, 7, 9).astype(np.float32)
    image = rs.rand(2, 30, 26).astype(np.float32)
    plan_j = jm.DFTConvPlan((30, 26), jnp.asarray(kernel))
    plan_t = tm.DFTConvPlan((30, 26), torch.as_tensor(kernel))
    assert plan_t.fft_shape == plan_j.fft_shape
    within(plan_t.kernel_spectrum.real.numpy(),
           jnp.real(plan_j.kernel_spectrum))
    within(plan_t.convolve(torch.as_tensor(image)).numpy(),
           plan_j.convolve(jnp.asarray(image)))


def test_pair_build_on_the_device_matches_jax():
    """``ct_build_pair_spectra`` (adjacent kernels of a stack, one
    transform each pair) against the JAX package's, and against the host
    build of the same pair in float64 (``ct_kernel_pair``) within 5e-6 of
    the max-abs (a float32 transform; 1.3e-6 measured)."""
    rs = np.random.RandomState(4)
    fs = (tc.ct_conv_shape(48), tc.ct_conv_shape(60))
    kernels = [rs.rand(9, 9) for _ in range(4)]
    embedded = np.stack([np.roll(np.pad(k, ((0, fs[0] - 9), (0, fs[1] - 9))),
                                 (-4, -4), (0, 1)) for k in kernels]
                        ).astype(np.float32)[:, None]
    want = jc.ct_build_pair_spectra(jnp.asarray(embedded),
                                    jc.make_ct_tables(fs))
    got = tc.ct_build_pair_spectra(torch.as_tensor(embedded),
                                   tc.make_ct_tables(fs))
    host = [tc.ct_kernel_pair(kernels[2 * i], kernels[2 * i + 1], (40, 52),
                              fs) for i in range(2)]
    for part, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, 1) + fs
        within(g.numpy(), w)
        within(g.numpy()[:, 0], np.stack([h[part].numpy() for h in host]),
               5e-6)


def test_small_transform_shape_is_refused():
    k = np.ones((9, 9))
    for pkg in (tc, jc):
        with pytest.raises(ValueError, match="too small"):
            pkg.ct_kernel_pair(k, k, (32, 32), (33, 40))


# ----------------------------------------------------------------------
# the stacked loss


def toy_datasets(n_obs, psf_sizes=None, size=32, seed=5):
    from jolideco_torch.utils.kernels import gaussian_kernel_2d

    rs = np.random.RandomState(seed)
    datasets = {}
    for i in range(n_obs):
        k = 9 if psf_sizes is None else psf_sizes[i]
        psf = gaussian_kernel_2d(1.5 + 0.2 * i, x_size=k, y_size=k)
        datasets[f"obs-{i}"] = {
            "counts": rs.poisson(3.0, (size, size)).astype(np.float32),
            "psf": psf.astype(np.float32),
            "exposure": rs.uniform(0.9, 1.3, (size, size)).astype(
                np.float32),
            "background": np.full((size, size), 2.0, np.float32),
        }
    return datasets


def band_datasets(n_obs=4, c=2, size=16, seed=0):
    """``n_obs`` stacks of ``c`` bands folded by an RMF, band PSFs of 5²
    (``tests/test_torch_multiband.py``'s data)."""
    rng = np.random.RandomState(seed)
    rmf = np.array([[0.7, 0.3], [0.2, 0.8]], np.float32)[:c, :c]
    datasets = {}
    for i in range(n_obs):
        psf = rng.uniform(0, 1, (c, 5, 5)).astype(np.float32)
        psf /= psf.sum(axis=(1, 2), keepdims=True)
        datasets[f"o{i}"] = {
            "counts": rng.poisson(3.0, (c, size, size)).astype(np.float32),
            "background": np.full((c, size, size), 0.5, np.float32),
            "exposure": rng.uniform(0.8, 1.2, (c, size, size)).astype(
                np.float32),
            "psf": psf, "rmf": rmf}
    return datasets


STACKS = {
    "ct_4": ("ct", lambda: toy_datasets(4)),
    "ct_5_odd_tail": ("ct", lambda: toy_datasets(5)),
    "mxu": ("mxu", lambda: toy_datasets(4)),
    "direct_mixed_psfs": ("direct", lambda: toy_datasets(3, [17, 11, 14])),
    "ct_mixed_psfs": ("ct", lambda: toy_datasets(3, [17, 11, 14])),
    "ct_bands": ("ct", band_datasets),
    "mxu_bands": ("mxu", band_datasets),
    "direct_bands": ("direct", band_datasets),
}


def stacked_pair(datasets, conv_mode, upsampling=1, calibrations=False):
    shape = next(iter(datasets.values()))["counts"].shape[-2:]
    flux = np.random.RandomState(6).uniform(
        0.5, 2.0, tuple(upsampling * s for s in shape)).astype(np.float32)
    losses = {}
    for pkg, stacked, kwargs in ((jj, JStacked, {}),
                                 (jt, TStacked, {"device": "cpu"})):
        comps = pkg.FluxComponents({"flux": pkg.SpatialFluxComponent
                                    .from_numpy(np.ones(shape, np.float32),
                                                upsampling_factor=upsampling)})
        cals = None
        if calibrations:
            cals = pkg.NPredCalibrations({
                name: pkg.NPredCalibration(shift_x=0.3 - 0.1 * i,
                                           shift_y=-0.2, weight=1.0 + 0.1 * i,
                                           background_norm=1.1)
                for i, name in enumerate(datasets)})
        losses[pkg] = stacked.from_datasets(datasets, comps, calibrations=cals,
                                            conv_mode=conv_mode, **kwargs)
    return flux, losses[jj], losses[jt]


def values_and_grads(loss_j, loss_t, flux):
    values_j, grad_j = jax.jit(lambda f: (
        loss_j.evaluate((f,)),
        jax.grad(lambda x: jnp.sum(loss_j.evaluate((x,)) * loss_j.weights))(
            f)))(jnp.asarray(flux)[None, None])
    values_j, grad_j = np.asarray(values_j), np.asarray(grad_j)
    f_t = torch.as_tensor(flux)[None, None].requires_grad_(True)
    values_t = loss_t.evaluate((f_t,))
    loss_t((f_t,)).backward()
    return (values_t.detach().numpy(), f_t.grad.numpy()), (values_j, grad_j)


def close(got, want, rtol=1e-5):
    assert_allclose(got[0], want[0], rtol=rtol)
    assert_allclose(got[1], want[1], rtol=0,
                    atol=rtol * float(np.abs(want[1]).max()))


@pytest.mark.parametrize("case", list(STACKS))
def test_stacked_loss_matches_jax(case):
    conv_mode, data = STACKS[case]
    datasets = data()
    flux, loss_j, loss_t = stacked_pair(datasets, conv_mode)
    n_obs = len(datasets)
    if conv_mode == "ct":
        assert loss_t.ct_fft_shape == loss_j.ct_fft_shape
        assert (loss_t.ct_pairs is None) == (n_obs < 2)
        assert loss_t.ct_pairs["flux"][0].shape[0] == n_obs // 2
    if conv_mode == "mxu":
        assert loss_t.mxu_fft_shape == loss_j.mxu_fft_shape
    if conv_mode == "direct":
        assert loss_t.psfs["flux"].shape[-2:] == loss_j.psfs["flux"].shape[-2:]
    got, want = values_and_grads(loss_j, loss_t, flux)
    close(got, want)
    # each observation alone (the per-observation convolution of the mode)
    f_j, f_t = jnp.asarray(flux)[None, None], torch.as_tensor(flux)[None, None]
    for idx in range(n_obs):
        assert_allclose(loss_t.evaluate_dataset(idx, (f_t,)).item(),
                        float(loss_j.evaluate_dataset(idx, (f_j,))),
                        rtol=1e-5)


@pytest.mark.parametrize("conv_mode", ["ct", "mxu", "direct"])
def test_stacked_loss_at_x2_with_calibrations_matches_jax(conv_mode):
    flux, loss_j, loss_t = stacked_pair(toy_datasets(4), conv_mode,
                                        upsampling=2, calibrations=True)
    got, want = values_and_grads(loss_j, loss_t, flux)
    close(got, want)


def test_ct_per_observation_path_matches_jax():
    """Without pairs (one observation) the loss convolves through
    ``ct_convolve_single``, values and the gradient through its adjoint."""
    flux, loss_j, loss_t = stacked_pair(toy_datasets(1), "ct")
    assert loss_t.ct_pairs is None and loss_j.ct_pair_kernels is None
    got, want = values_and_grads(loss_j, loss_t, flux)
    close(got, want)


@pytest.mark.parametrize("conv_mode", ["ct", "mxu"])
def test_one_transform_shape_across_components(conv_mode):
    """Components at x2 and x1 have no common matrix-DFT shape: both
    packages raise the same ``ValueError`` (the joint strategy then falls
    back to per-dataset models)."""
    datasets = toy_datasets(2)
    for pkg, stacked, kwargs in ((jj, JStacked, {}),
                                 (jt, TStacked, {"device": "cpu"})):
        comps = pkg.FluxComponents({
            "fine": pkg.SpatialFluxComponent.from_numpy(
                np.ones((64, 64), np.float32), upsampling_factor=2),
            "coarse": pkg.SpatialFluxComponent.from_numpy(
                np.ones((32, 32), np.float32))})
        with pytest.raises(ValueError, match="needs one common transform "
                           "shape across components"):
            stacked.from_datasets(datasets, comps, conv_mode=conv_mode,
                                  **kwargs)


def test_unknown_conv_mode_raises():
    """The port refuses a mode it does not know; the JAX package takes
    any (``ROADMAP.md`` section 3, faults on the reference side)."""
    comps = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        np.ones((32, 32), np.float32))})
    with pytest.raises(ValueError, match="conv_mode"):
        TStacked.from_datasets(toy_datasets(2), comps, conv_mode="fast",
                               device="cpu")
    with pytest.raises(ValueError, match="conv_mode"):
        jt.MAPDeconvolver(conv_mode="fast")


def test_sequential_strategy_warns_and_convolves_by_fft(caplog):
    """The mode applies to the stacked joint path only: the sequential
    strategy logs the JAX package's warning and builds per-dataset
    models (FFT convolutions)."""
    import logging

    flux = np.ones((32, 32), np.float32)
    for pkg, kwargs in ((jj, {}), (jt, {"device": "cpu"})):
        caplog.clear()
        deco = pkg.MAPDeconvolver(update_strategy="sequential",
                                  conv_mode="ct", **kwargs)
        with caplog.at_level(logging.WARNING):
            loss = deco.build_loss(toy_datasets(2), components=pkg
                                   .SpatialFluxComponent.from_numpy(flux))
        assert "only applies to the stacked joint path" in caplog.text
        assert type(loss.poisson_loss).__name__ == "PoissonLoss"


def test_convolutions_are_twice_differentiable():
    """The probe differentiates the loss twice: the second derivative
    through each mode's convolution equals the ``"fft"`` loss's (the
    Hessian action along ones, float32 at 1e-5 of its max-abs)."""
    datasets = toy_datasets(3)
    flux = np.random.RandomState(6).uniform(0.5, 2.0, (32, 32)).astype(
        np.float32)
    hvps = {}
    for mode in ("fft", "ct", "mxu", "direct"):
        comps = jt.FluxComponents({"flux": jt.SpatialFluxComponent
                                   .from_numpy(flux)})
        loss = TStacked.from_datasets(datasets, comps, conv_mode=mode,
                                      device="cpu")
        f = torch.as_tensor(flux)[None, None].requires_grad_(True)
        (grad,) = torch.autograd.grad(loss((f,)), f, create_graph=True)
        (hvps[mode],) = torch.autograd.grad(grad, f, torch.ones_like(f))
    for mode in ("ct", "mxu", "direct"):
        within(hvps[mode].numpy(), hvps["fft"].numpy(), 1e-5)


# ----------------------------------------------------------------------
# the deconvolver


@pytest.fixture(scope="module")
def run_data():
    rs = np.random.RandomState(642020)
    return {f"{idx}": gauss_and_point_sources_gauss_psf(random_state=rs)
            for idx in range(4)}


def run_components(pkg):
    """``tests/test_conv_modes_e2e.py``'s x2 component (32² at the data's
    resolution, a 64² flux) under ``UniformPrior``."""
    r = np.random.RandomState(1)
    return pkg.FluxComponents({"flux": pkg.SpatialFluxComponent.from_numpy(
        r.gamma(20, size=(32, 32)), prior=pkg.UniformPrior(),
        upsampling_factor=2)})


def run_calibrations(pkg, datasets):
    return pkg.NPredCalibrations({
        name: pkg.NPredCalibration(shift_x=0.1, shift_y=-0.2)
        for name in datasets})


def deconvolve(pkg, datasets, conv_mode, **kwargs):
    deco = pkg.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                              update_strategy="joint", conv_mode=conv_mode,
                              compute_error=True, **kwargs)
    cals = run_calibrations(pkg, datasets)
    result = deco.run(datasets, components=run_components(pkg),
                      calibrations=cals)
    return deco, result, cals


@pytest.fixture(scope="module")
def ct_runs(run_data):
    _, jax_result, jax_cals = deconvolve(jj, run_data, "ct",
                                         display_progress=False)
    deco, result, cals = deconvolve(jt, run_data, "ct", device="cpu",
                                    trace_every=0)
    return deco, result, cals, jax_result, jax_cals


def test_joint_ct_run_at_x2_with_calibrations_matches_jax(ct_runs):
    deco, result, cals, jax_result, jax_cals = ct_runs
    assert deco.to_dict()["conv_mode"] == "ct"
    assert jax_result.config["conv_mode"] == "ct"
    comp_t, comp_j = result.components["flux"], jax_result.components["flux"]
    assert comp_t.flux_upsampled_numpy.shape == (64, 64)
    assert_allclose(comp_t.flux_upsampled_numpy,
                    comp_j.flux_upsampled_numpy, rtol=1e-4)
    for name in list(cals):
        for key in ("shift_xy", "_background_norm"):
            assert_allclose(getattr(cals[name], key).numpy(),
                            np.asarray(getattr(jax_cals[name], key)),
                            rtol=1e-4, atol=1e-5)


def test_ct_probe_matches_jax(ct_runs):
    _, result, _, jax_result, _ = ct_runs
    errors = result.components["flux"].flux_upsampled_error_numpy
    want = jax_result.components["flux"].flux_upsampled_error_numpy
    # the shifted x2 grid's edge pixels reach no data pixel: H . 1 is 0
    # there and the error infinite, in both packages
    seen = np.isfinite(want)
    assert_array_equal(np.isfinite(errors), seen)
    assert seen.mean() > 0.5 and (errors[seen] > 0).all()
    assert_allclose(errors[seen], want[seen], rtol=1e-4)
