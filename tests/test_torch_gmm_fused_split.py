"""The fused GMM scorer's ``"split"`` mode against the JAX package.

The JAX package runs its fused kernel in the Pallas interpreter on the
CPU at ``precision=HIGH``, as ``tests/test_gmm_fused.py`` runs it: its
``"split3"`` logits, the pair products ``x_a x_b`` and ``A`` each split
into bf16 hi and lo parts, three products hi.hi + hi.lo + lo.hi summed
in float32, ``b . x`` at HIGHEST. The port runs the split plain version
(a CPU tensor), which forms the same products from the symmetric pair
layout and is the reference of the card's tensor-core kernels
(``csrc/gmm_score_wg.cu`` for both forwards); the layout of their buffers and the routing to
them are checked here through a Python copy of the MAP kernel's
address map and recorded stand-ins of the libraries. Both are held against float64 logits of the
same normalised patches. Tolerances:

- ``valid`` identical to the JAX package's; ``xtn`` the float32 path's
  to 1e-6;
- values: the port's max-abs error against float64 at most twice the
  JAX kernel's, plus 1e-6 of the max-abs;
- argmax: the JAX package's wherever the float64 gap between the two
  largest logits exceeds 10 times the larger of the two errors;
- the image gradient against ``jax.grad`` at HIGH to 1e-4 of its
  max-abs (the JAX backward reads ``A`` as a bf16 hi/lo pair, about 16
  significant bits; the bar of ``tests/test_torch_gmm_fused.py``);
- a small ``MAPDeconvolver`` run under the default dial against the
  JAX package under ``force_pallas("interpret")``: the final flux within
  twice that run's spread from the JAX package's own XLA run (its
  interpreted backward reads ``A`` as a bf16 hi/lo pair), and to the XLA
  run within rtol 1e-4 (the ``BASELINE.md`` bar for flux maps, as
  ``tests/test_torch_slice.py``).

The GMMs are the two of the registry and ``chip_smoke.wide_gmm``, 256
components, two of the tensor-core kernel's tiles of 208.

The MAP gradient depends on the logits only through the argmax, so two
runs that differ only in the dial train alike until an argmax flips:
:func:`test_dial_flux_difference_matches_jax` measures that difference
in both packages on ``chip_smoke.py``'s small run (none: no flip), and
``chip_smoke.py`` phase 3 prints the card's beside it.
"""

import contextlib
import types

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
from jolideco_torch.utils.bench_data import make_datasets as bench_datasets
from jolideco_tpu.config import force_pallas
from jolideco_tpu.config import set_gmm_precision as j_set_gmm_precision
from jolideco_tpu.ops.gmm_fused import _padded_dims, gmm_score_fused_image
from jolideco_tpu.priors.patches.core import ZERO_FLUX_SENTINEL

torch.set_num_threads(1)
STRIDE = 4
GMM_NAMES = ["builtin-8x8-v1", "astro-snr-v1", "wide-256"]
# a square image, and a ragged one with a block of sentinel pixels
SHAPES = [(128, 128), (44, 136)]
EPOCHS = 20


@pytest.fixture(scope="module", params=GMM_NAMES)
def gmms(request):
    if request.param == "wide-256":
        from chip_smoke import wide_gmm, wide_gmm_arrays
        from jolideco_tpu.priors.patches.gmm import GaussianMixtureModelMeta

        *arrays, stride = wide_gmm_arrays()
        meta = GaussianMixtureModelMeta(stride=stride)
        return (jj.GaussianMixtureModel.from_numpy(*arrays, meta=meta),
                wide_gmm())
    return (jj.GaussianMixtureModel.from_registry(request.param),
            jt.GaussianMixtureModel.from_registry(request.param))


def make_image(shape, seed=7):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    if shape[0] != shape[1]:
        img[:8, :16] = 2.0 * ZERO_FLUX_SENTINEL
    return img


def jax_scores(gmm_j, img):
    """The JAX kernel at HIGH, cropped to the port's patch grid."""
    values, argmax, valid = gmm_score_fused_image(
        jnp.asarray(img), (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
        interpret=True, precision=lax.Precision.HIGH,
    )
    h, w = img.shape
    hp, wp, _ = _padded_dims(h, w)
    g = (8 // STRIDE) ** 2

    def crop(a):
        grid = np.asarray(a).reshape(g, hp // 8, wp // 8)
        return grid[:, :h // 8, :w // 8].reshape(-1)

    return crop(values), crop(argmax), crop(valid)


def logits64(xtn, gmm_t):
    """Float64 logits ``(n, K)`` of float32 patches, from the float32
    buffers both packages score with."""
    packed = gmm_t.packed
    x = np.asarray(xtn, np.float64)
    u = (x[:, :, None] * x[:, None, :]).reshape(len(x), -1)
    return (-0.5 * (u @ packed["aq"].astype(np.float64))
            + x @ packed["bq"].astype(np.float64)
            + packed["const2"].astype(np.float64).reshape(-1))


@pytest.mark.parametrize("shape", SHAPES)
def test_split_plain_matches_jax_high(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape)
    v_j, a_j, valid_j = jax_scores(gmm_j, img)

    bufs = gmm_t.kernel_buffers("cpu")
    image = torch.as_tensor(img)
    v_t, a_t, valid_t, xtn = tfused.fused_forward_plain(
        image, bufs, STRIDE, ZERO_FLUX_SENTINEL, mode="split")
    _, _, valid_32, xtn_32 = tfused.fused_forward_plain(
        image, bufs, STRIDE, ZERO_FLUX_SENTINEL)
    m = valid_t.numpy() > 0.5
    assert_array_equal(m, valid_j)
    assert_array_equal(valid_t.numpy(), valid_32.numpy())
    assert_allclose(xtn.numpy(), xtn_32.numpy(), rtol=0, atol=1e-6)
    assert 0 < m.sum() <= m.size
    if shape[0] != shape[1]:
        assert m.sum() < m.size

    ref = logits64(xtn.numpy()[m], gmm_t)
    v64 = ref.max(axis=1)
    err_t = float(np.abs(v_t.numpy()[m] - v64).max())
    err_j = float(np.abs(v_j[m] - v64).max())
    scale = float(np.abs(v64).max())
    assert err_t <= 2 * err_j + 1e-6 * scale, (err_t, err_j, scale)
    # the split's own error: about 1e-5 of the logits, not float32's
    assert 0 < err_j <= 1e-4 * scale

    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 10 * max(err_t, err_j)
    assert decided.mean() > 0.9
    assert_array_equal(a_t.numpy()[m][decided], a_j[m][decided])
    assert_array_equal(a_t.numpy()[m][decided], ref.argmax(axis=1)[decided])


@pytest.mark.parametrize("shape", SHAPES)
def test_split_image_gradient_matches_jax_high(gmms, shape):
    gmm_j, gmm_t = gmms
    img = make_image(shape, seed=11)

    def scalar_j(x):
        values, _, valid = gmm_score_fused_image(
            x, (8, 8), STRIDE, gmm_j.packed, ZERO_FLUX_SENTINEL,
            interpret=True, precision=lax.Precision.HIGH,
        )
        return jnp.sum(jnp.where(valid, values, 0.0))

    value_j, grad_j = jax.value_and_grad(scalar_j)(jnp.asarray(img))

    x = torch.as_tensor(img).requires_grad_(True)
    values, _, valid = tfused.gmm_score_fused_image(
        x, (8, 8), STRIDE, gmm_t.kernel_buffers("cpu"), ZERO_FLUX_SENTINEL,
        mode="split",
    )
    value_t = torch.where(valid, values, torch.zeros_like(values)).sum()
    value_t.backward()

    assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                    atol=1e-4 * float(np.abs(grad_j).max()))


def test_split_buffers_reproduce_the_quadratic_form():
    """The pair-major ``A`` gives ``x^T A x`` (float64); its bf16 parts
    hold it to bf16's rounding of the low part; the kernels' copy
    (``pair_wg``) holds exactly those parts, its ``lin_wg`` the linear
    terms."""
    gmm_t = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    packed = gmm_t.packed
    a_quad = packed["a_quad"][:3]
    pair = tfused._pair_rows(a_quad)
    x = np.random.RandomState(0).randn(64)
    u = x[tfused.PAIR_A] * x[tfused.PAIR_B]
    want = np.einsum("i,kij,j->k", x, a_quad, x)
    assert pair.shape == (tfused.PAIRS, 3) == (2080, 3)
    assert_allclose(u @ pair, want, rtol=1e-12)

    bufs = gmm_t.kernel_buffers("cpu")
    k = gmm_t.n_components
    pair32 = torch.as_tensor(
        tfused._pair_rows(packed["a_quad"]).astype(np.float32))
    hi, lo = bufs["pair_hi"], bufs["pair_lo"]
    for part in (hi, lo):
        assert torch.equal(part, part.to(torch.bfloat16).float())
    assert bool(((pair32 - hi - lo).abs() <= 2.0**-17 * pair32.abs()).all())

    parts, b3, c = wg_parts(bufs)
    assert parts.shape == (2, 200, 2080)
    assert_array_equal(parts[0, :k], hi.T.numpy())
    assert_array_equal(parts[1, :k], lo.T.numpy())
    assert not parts[:, k:].any()
    assert_array_equal(b3.astype(np.float64).sum(axis=0)[:k],
                       -2.0 * bufs["bq"].numpy().T.astype(np.float64))
    assert_array_equal(c[:k], bufs["const2"].numpy())
    assert not b3[:, k:].any() and not c[k:].any()


def test_split_buffers_tile_the_components():
    """Past 200 components the kernels' copies hold tiles of 200, the
    last padded with zero components: 256 take two."""
    from chip_smoke import wide_gmm

    bufs = wide_gmm().kernel_buffers("cpu")
    hi, lo = bufs["pair_hi"], bufs["pair_lo"]
    assert hi.shape == (2080, 256)
    assert tuple(bufs["pair_wg"].shape)[:2] == (2, 65)
    assert tuple(bufs["pair_wg3"].shape)[:2] == (2, 130)
    assert bufs["lin_wg"].shape[0] == 2
    parts, b3, c = wg_parts(bufs)
    assert parts.shape == (2, 400, 2080)
    assert_array_equal(parts[0, :256], hi.T.numpy())
    assert_array_equal(parts[1, :256], lo.T.numpy())
    assert not parts[:, 256:].any()
    assert_array_equal(b3.astype(np.float64).sum(axis=0)[:256],
                       -2.0 * bufs["bq"].numpy().T.astype(np.float64))
    assert_array_equal(c[:256], bufs["const2"].numpy())
    assert not b3[:, 256:].any() and not c[256:].any()


def kernel_address(n, k, width=32):
    """Byte offset of component ``n``, entry ``k`` in a plane of
    ``csrc/gmm_score_wg.cu``'s stage (a chunk's 32 pairs) or linear terms
    (b's 64 features), as its descriptors walk it: 8 x 8 core matrices of
    eight 16-byte rows, the next along K 128 bytes on (the leading byte
    offset), the next eight components ``16 width`` bytes on (the stride
    byte offset: 512 and 1024)."""
    return (n // 8) * 16 * width + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2


def read_planes(data, width):
    """bf16 planes ``(..., 200 * width * 2)`` uint8 read back through
    :func:`kernel_address`: float32 ``(..., 200, width)``."""
    n, k = np.meshgrid(np.arange(tfused.KP_WG), np.arange(width),
                       indexing="ij")
    bits = np.ascontiguousarray(data).view(np.uint16)[
        ..., kernel_address(n, k, width) // 2]
    return (bits.astype(np.uint32) << 16).view(np.float32)


def wg_parts(bufs):
    """``pair_wg`` and ``lin_wg`` read back through :func:`kernel_address`:
    the hi and lo parts ``(2, T * 200, 2080)``, the three parts of -2 b
    ``(3, T * 200, 64)`` and c ``(T * 200,)``, float32."""
    wg, lin = bufs["pair_wg"].numpy(), bufs["lin_wg"].numpy()
    tiles = wg.shape[0]
    planes = read_planes(wg.reshape(tiles, 65, 2, -1), 32)
    parts = planes.transpose(2, 0, 3, 1, 4).reshape(2, tiles * 200, 2080)
    b3 = read_planes(lin[:, :3 * tfused.WG_LIN_PART].reshape(tiles, 3, -1),
                     64).transpose(1, 0, 2, 3).reshape(3, tiles * 200, 64)
    # c: thread t of a quad reads components 8 j + 2 t and + 1 as 13
    # float4s, its 50 entries then two zeros
    quads = np.ascontiguousarray(lin[:, 3 * tfused.WG_LIN_PART:]).view(
        np.float32).reshape(tiles, 4, 52)
    assert not quads[..., 50:].any()
    c = quads[..., :50].reshape(tiles, 4, 25, 2).transpose(0, 2, 1, 3)
    return parts, b3, c.reshape(-1)


@pytest.mark.parametrize("name,tiles", [("astro-snr-v1", 1),
                                        ("wide-256", 2)])
def test_wg_buffer_places_the_split_parts(name, tiles):
    """The kernels' copies (``pair_wg``, ``lin_wg``) hold exactly the
    split parts ``pair_hi`` and ``pair_lo``, placed as the kernel's
    descriptors read them
    (:func:`kernel_address`, which ``wg_plane_index`` must agree with),
    -2 b as three bf16 parts whose sum is it exactly, and c in the order
    the threads read it; zero past K, in tiles of 200."""
    from chip_smoke import wide_gmm

    gmm = (wide_gmm() if name == "wide-256"
           else jt.GaussianMixtureModel.from_registry(name))
    bufs = gmm.kernel_buffers("cpu")
    k = gmm.n_components
    assert bufs["pair_wg"].dtype == bufs["lin_wg"].dtype == torch.uint8
    assert tuple(bufs["pair_wg"].shape) == (tiles, 65, 2 * 2 * 200 * 32)
    assert tuple(bufs["lin_wg"].shape) == (tiles, 3 * 2 * 200 * 64
                                           + 4 * 4 * 52)
    for width in (32, 64):
        n, kk = np.meshgrid(np.arange(200), np.arange(width), indexing="ij")
        assert_array_equal(2 * tfused.wg_plane_index(n, kk, width),
                           kernel_address(n, kk, width))
        assert sorted(kernel_address(n, kk, width).reshape(-1)) == list(
            range(0, 2 * 200 * width, 2))
    parts, b3, c = wg_parts(bufs)
    assert_array_equal(parts[0, :k], bufs["pair_hi"].T.numpy())
    assert_array_equal(parts[1, :k], bufs["pair_lo"].T.numpy())
    assert not parts[:, k:].any()
    b = bufs["bq"].numpy().T.astype(np.float64)
    assert_array_equal(b3.astype(np.float64).sum(axis=0)[:k], -2.0 * b)
    for part in b3:
        assert_array_equal(part, part.astype(jnp.bfloat16).astype(np.float32))
    assert not b3[:, k:].any()
    assert_array_equal(c[:k], bufs["const2"].numpy())
    assert not c[k:].any()


class FakeLibrary:
    """A kernel library whose C entries record their calls and succeed."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, entry):
        if entry.endswith("error_string"):
            return lambda code: b"fake"

        def call(*args):
            self.calls.append((self.name, entry, args))
            return 0
        return call


@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_dial_routes_the_map_forward_to_the_warpgroup_kernels(monkeypatch,
                                                              mode):
    """On a card K1 (the wrappers ``gmm_fused_fwd_tc_cuda``,
    ``gmm_fused_fwd_bf16_cuda`` and their logsumexp ``_marg_``
    counterparts) and K5 (``gmm_score_rows_tc_cuda``,
    ``gmm_score_rows_bf16_cuda`` and their logsumexp ``_marg_``
    counterparts) launch ``gmm_score_wg``'s entries with the mode's
    products, ``pair_wg`` and ``lin_wg``, K5 with its epilogue flag. The
    library is a recorded stand-in and the wrappers' CUDA checks are
    lifted, so that a CPU tensor stands for a card's."""
    from jolideco_torch.ops import gmm_pallas as tpallas

    calls = []
    lib = FakeLibrary("gmm_score_wg", calls)
    for module in (tfused, tpallas):
        monkeypatch.setattr(module, "_wg_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *device: types.SimpleNamespace(cuda_stream=0))
    def outputs(image, stride):
        n = tfused.fused_patch_count(image.shape, stride)
        return (torch.empty(n), torch.empty(n, dtype=torch.int32),
                torch.empty(n), torch.empty((n, 64)))

    def rows(x, name, argmax=None):
        return x.device, x.shape[0]

    monkeypatch.setattr(tfused, "_forward_outputs", outputs)
    monkeypatch.setattr(tpallas, "_check_rows", rows)
    bufs = jt.GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers("cpu")
    image = torch.as_tensor(make_image((16, 128)))
    x = torch.zeros((300, 64))
    products = tfused.TC_PRODUCTS[mode]
    for marginalize in (False, True):
        calls.clear()
        tfused._FORWARDS[marginalize, mode](image, bufs, STRIDE,
                                            ZERO_FLUX_SENTINEL)
        tpallas._SCORES_TC[mode, marginalize](x, bufs)
        image_args, row_args = calls[0][2], calls[1][2]
        assert image_args[7:9] == (bufs["pair_wg"].data_ptr(),
                                   bufs["lin_wg"].data_ptr())
        assert image_args[9:11] == (200, products)
        image_entry = ("gmm_score_wg_image_lse" if marginalize
                       else "gmm_score_wg_image")
        assert [c[:2] for c in calls] == [
            ("gmm_score_wg", image_entry),
            ("gmm_score_wg", "gmm_score_wg_rows")]
        assert row_args[1] == 300
        assert row_args[2:4] == (bufs["pair_wg"].data_ptr(),
                                 bufs["lin_wg"].data_ptr())
        assert row_args[4:7] == (200, products, int(marginalize))


@pytest.mark.parametrize("dial,mode", [("highest", "f32"), ("high", "split"),
                                       ("default", "bf16")])
def test_dial_routes_the_map_forward(dial, mode):
    """The prior passes the dial's mode down: ``"highest"`` takes the
    float32 plain version, ``"high"`` the split one, ``"default"`` the
    single-bf16 one; the marginalised prior follows the dial too, its
    logsumexp forward and its backward's softmax both on the logits of
    the dial's mode."""
    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    flux = torch.as_tensor(np.random.RandomState(3).uniform(
        0.1, 2.0, (1, 1, 32, 40)).astype(np.float32))
    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        assert config.gmm_mode() == mode
        for marginalize in (False, True):
            prior = jt.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False,
                                     marginalize=marginalize)
            x = flux.clone().requires_grad_(True)
            tfused.reset_counters()
            prior(x).backward()
            for m in ("split", "bf16"):
                assert tfused.PLAIN_SCORES[m, False].calls == int(
                    m == mode and not marginalize)
                assert tfused.PLAIN_SCORES[m, True].calls == int(
                    m == mode and marginalize)
                assert tfused.PLAIN_UNITS[m].calls == int(
                    m == mode and marginalize)
            assert tfused.score_plain.calls == int(mode == "f32")
            assert tfused.fused_forward_plain.calls == 1
            assert (tfused.fused_backward_marg_plain.calls if marginalize
                    else tfused.fused_backward_plain.calls) == 1
    finally:
        config.set_gmm_precision(saved)


def test_invalid_mode_and_cpu_tensor_raise():
    bufs = jt.GaussianMixtureModel.from_registry(
        "builtin-8x8-v1").kernel_buffers("cpu")
    image = torch.as_tensor(make_image((16, 128)))
    with pytest.raises(ValueError, match="mode"):
        tfused.gmm_score_fused_image(image, (8, 8), STRIDE, bufs,
                                     ZERO_FLUX_SENTINEL, mode="bf8")
    for launch in (tfused.gmm_fused_fwd_tc_cuda,
                   tfused.gmm_fused_fwd_bf16_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            launch(image, bufs, STRIDE, ZERO_FLUX_SENTINEL)


def slice_datasets(n_obs=4, size=128, seed=1):
    """``tests/test_torch_slice.py``'s data: the flat start lies below the
    truth everywhere, so no pixel's step-0 gradient is near zero."""
    from jolideco_torch.utils.kernels import gaussian_kernel_2d

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    truth = 5.0 * np.exp(
        -((xx - 64) ** 2 + (yy - 60) ** 2) / (2 * 12.0**2)) + 8.0
    for _ in range(12):
        y0, x0 = rs.randint(8, size - 8, 2)
        truth[y0, x0] += rs.gamma(2.0) * 20
    datasets = {}
    for i in range(n_obs):
        psf = gaussian_kernel_2d(1.5 + 0.3 * i, x_size=9,
                                 y_size=9).astype(np.float32)
        exposure = np.full((size, size), 1.0 + 0.1 * i, np.float32)
        background = np.full((size, size), 1.0, np.float32)
        counts = rs.poisson(background + truth * exposure).astype(np.float32)
        datasets[f"obs-{i}"] = {"counts": counts, "psf": psf,
                                "exposure": exposure,
                                "background": background}
    return datasets


def run_deconvolver(pkg, datasets, gmm_name, cycle_spin, size=128,
                    interpret=True):
    """20 joint Adam epochs at lr 0.1 from a flat start under the GMM
    patch prior (stride 4); the final flux. The JAX package runs its
    Pallas kernels in the interpreter, or (``interpret=False``) its
    default CPU dispatch."""
    gmm = pkg.GaussianMixtureModel.from_registry(gmm_name)
    prior = pkg.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=cycle_spin)
    comp = pkg.SpatialFluxComponent.from_numpy(
        np.ones((size, size), np.float32), prior=prior)
    if pkg is jj:
        deco = jj.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                                 update_strategy="joint", trace_every=0,
                                 display_progress=False, seed=0)
        with force_pallas("interpret" if interpret else "auto"):
            result = deco.run(datasets, components=comp)
        return result.components["flux"].flux_upsampled_numpy
    deco = jt.MAPDeconvolver(n_epochs=EPOCHS, learning_rate=0.1,
                             update_strategy="joint", trace_every=0, seed=0,
                             device="cpu")
    return deco.run(datasets, components=comp).flux_upsampled_total


def max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_map_deconvolver_default_dial_matches_jax_interpret():
    """The port's default dial (the split plain version on the CPU)
    against the JAX package's default dial with its Pallas kernels in the
    interpreter (its split3 fused kernel). That run's backward reads ``A``
    as a bf16 hi/lo pair, and Adam carries the difference: after 20 steps
    it lies 3.5e-3 (elementwise) from the JAX package's own XLA run,
    whose backward is float32. So the port, whose backward is float32,
    is held within twice the JAX package's spread between its two
    dispatches, and to the XLA run within rtol 1e-4 (the bar of
    ``tests/test_torch_slice.py``)."""
    datasets = slice_datasets()
    flux_pallas = run_deconvolver(jj, datasets, "builtin-8x8-v1", False)
    flux_xla = run_deconvolver(jj, datasets, "builtin-8x8-v1", False,
                               interpret=False)
    tfused.reset_counters()
    flux_t = run_deconvolver(jt, datasets, "builtin-8x8-v1", False)
    assert tfused.score_split_plain.calls >= EPOCHS
    assert tfused.score_plain.calls == 0
    spread = max_rel(flux_xla, flux_pallas)
    assert 0 < spread < 1e-2
    assert max_rel(flux_t, flux_pallas) <= 2 * spread
    assert_allclose(flux_t, flux_xla, rtol=1e-4)


def dial_flux_difference(pkg, datasets):
    """Flux of a run under the "high" dial against one under "highest",
    as a share of the latter's max-abs."""
    set_dial = j_set_gmm_precision if pkg is jj else config.set_gmm_precision
    flux = {}
    try:
        for dial in ("high", "highest"):
            set_dial(dial)
            flux[dial] = run_deconvolver(pkg, datasets, "astro-snr-v1", True)
    finally:
        set_dial("high")
    return float(np.abs(flux["high"] - flux["highest"]).max()
                 / np.abs(flux["highest"]).max())


def test_dial_flux_difference_matches_jax():
    """``chip_smoke.py``'s small run at K = 200 with cycle spin (4 ×
    128², its data generator, ``astro-snr-v1``): the JAX package's own
    HIGH and HIGHEST runs differ by ``chip_smoke.JAX_DIAL_FLUX_SHARE`` of
    the max-abs (no argmax flips: identical flux), the reading phase 3
    prints beside the card's, and the port's two dials on the CPU stay
    within twice it."""
    import chip_smoke

    datasets = bench_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    diff_j = dial_flux_difference(jj, datasets)
    diff_t = dial_flux_difference(jt, datasets)
    assert diff_j == chip_smoke.JAX_DIAL_FLUX_SHARE
    assert diff_t <= 2 * diff_j


def test_jax_default_cpu_dispatch_ignores_the_dial():
    """The JAX package's default CPU dispatch (its XLA scorer) gives the
    same bits under every dial, so the tests that hold the port's
    default dial against it compare the split mode with float32 and
    keep their float32 tolerances (none needed more)."""
    gmm = jj.GaussianMixtureModel.from_registry("astro-snr-v1")
    prior = jj.GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False)
    flux = jnp.asarray(np.random.RandomState(0).uniform(
        0.1, 2.0, (1, 1, 64, 128)).astype(np.float32))
    out = {}
    try:
        for dial in ("high", "highest", "default"):
            j_set_gmm_precision(dial)
            value, grad = jax.value_and_grad(prior)(flux)
            out[dial] = (np.asarray(value), np.asarray(grad))
    finally:
        j_set_gmm_precision("high")
    for dial in ("highest", "default"):
        assert_array_equal(out[dial][0], out["high"][0])
        assert_array_equal(out[dial][1], out["high"][1])
