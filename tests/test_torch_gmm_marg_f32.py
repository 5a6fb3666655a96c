"""K1 lse and K4 of the ``"f32"`` mode as the warpgroup kernels compute them.

Under ``"highest"`` the marginalised prior's forward (K1's logsumexp) and
backward (K4) run ``csrc/gmm_score_wg.cu``'s six-product core: per row
``x`` the pair products ``u = x_a x_b`` (``a <= b``) and the pair-major
``A`` (off-diagonals doubled), both split three ways into bf16 parts
(``bf16_split3``: hi, mid, lo), the six products whose orders sum below
three, small first (:data:`PRODUCTS`), summed in float32 into fresh sums
a k16 step (16 pairs) that are added to the running float32 sum; ``b . x``
likewise from ``-2 b``'s three parts, before the pairs, and ``-2 c``
after them. K1
lse takes the logsumexp and the argmax; K4 recomputes the same logits on
the saved patches, weighs each component by ``exp(logit - lse)``, mixes
``b_k - A_k x`` in float32, divides by the sum of the weights, then the
plain versions' epilogue (the mean subtracted, the overlap-add).
This file holds that arithmetic, written out in PyTorch from the kernels'
own buffers (``pair_wg3``, read back through the address map of the
descriptors, and ``lin_wg``), against the float64 plain version and the
JAX package's ``"highest"`` kernels in interpret mode; the buffer's
layout; and the wrappers' routing. The JAX package's fused image scorer
takes images at least 128 wide, so its patch-level kernel scores the
patches here (``gmm_score_pallas``, the rows the plain forward extracts).
Tolerances, each with its reason:

- the three planes are ``bf16_split3`` of the pair form exactly, and
  their sum is its float32 entry to 2^-24 of it (the third part's
  rounding);
- K1 lse's values: rtol 1e-5 of the float32 plain version's and of the
  JAX kernel's (float32 quadratic forms summed in other orders), and
  within ``chip_smoke.py`` phase 2's anchored bar of the float64 plain
  version (twice the float32 plain version's error, plus 1e-6 of the
  max-abs); the argmax identical;
- K4's image gradient: the anchored bar against the float64 plain
  pipeline, as on the card; against the JAX kernels 1e-4 of the max-abs
  (their backward reads ``A`` and the softmax weights as bf16 hi/lo
  pairs, about 16 significant bits).
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from jolideco_torch.ops import gmm_fused as gf
from jolideco_torch.ops.linalg import bf16_split3
from jolideco_torch.priors import GaussianMixtureModel as TGMM
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from jolideco_tpu.priors import GaussianMixtureModel as JGMM
from jolideco_tpu.priors.patches.core import ZERO_FLUX_SENTINEL

torch.set_num_threads(1)
SENTINEL = ZERO_FLUX_SENTINEL
# the six products (u part, A part), small first, in the kernels' order
PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
CASES = [((37, 45), 4), ((24, 40), 8)]


def spd_arrays(k):
    """A random SPD GMM of ``k`` components whose softmax weights are
    mixed (``chip_smoke.mixed_gmm``'s arrays for k = 200): means,
    covariances, weights."""
    rs = np.random.RandomState(1)
    a = rs.randn(k, 64, 64) / 8.0
    return (rs.rand(k, 64), a @ a.transpose(0, 2, 1) + 0.5 * np.eye(64),
            rs.dirichlet(np.ones(k)))


@pytest.fixture(scope="module",
                params=["astro-snr-v1", "spd-13", "spd-200", "spd-256"])
def gmms(request):
    """The shipped GMM (one-hot weights), random SPD GMMs of K = 13 and
    200 (mixed weights), and K = 256, across two tiles of 200
    components: the JAX package's GMM, the port's buffers on the CPU."""
    if request.param.startswith("spd"):
        means, covariances, weights = spd_arrays(int(request.param[4:]))
        gmm_j = JGMM.from_numpy(means=means, covariances=covariances,
                                weights=weights)
        gmm_t = gmm_from_arrays(means, covariances, weights, None)
    else:
        gmm_j = JGMM.from_registry(request.param)
        gmm_t = TGMM.from_registry(request.param)
    return gmm_j, gmm_t.kernel_buffers("cpu")


def from_bits(bits):
    """bf16 bits (uint16) as float32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def plane_order(width):
    """:func:`gf.wg_plane_index` of every (component, entry) of a plane
    ``width`` entries a component: ``(KP_WG, width)``."""
    n, k = np.meshgrid(np.arange(gf.KP_WG), np.arange(width), indexing="ij")
    return gf.wg_plane_index(n, k, width)


def unpack3(bufs):
    """``pair_wg3`` back to float32 ``(3, PAIRS, T * KP_WG)``: the hi, mid
    and lo parts of the pair-major ``A``, through the descriptors'
    address map (record ``s`` of tile ``T``: three planes of pairs ``16 s
    ..``, each component's 16 entries K-major)."""
    t = bufs["pair_wg3"].numpy()
    tiles = t.shape[0]
    bits = t.view(np.uint16).reshape(tiles, gf.WG3_STEPS, 3, -1)
    x = from_bits(bits[..., plane_order(gf.WG3_STEP)])  # T s part n k
    return torch.as_tensor(x.transpose(2, 0, 3, 1, 4).reshape(
        3, tiles * gf.KP_WG, gf.PAIRS).transpose(0, 2, 1).copy())


def unpack_linear(bufs):
    """``lin_wg`` back to float32: ``-2 b``'s three parts ``(3, 64, T *
    KP_WG)`` and ``c`` ``(T * KP_WG,)``, as the kernels read them."""
    lin = bufs["lin_wg"].numpy()
    tiles = lin.shape[0]
    bits = lin[:, :3 * gf.WG_LIN_PART].copy().view(np.uint16)
    x = from_bits(bits.reshape(tiles, 3, -1)[..., plane_order(gf.D)])
    parts = x.transpose(1, 0, 2, 3).reshape(3, tiles * gf.KP_WG, gf.D)
    c = lin[:, 3 * gf.WG_LIN_PART:].copy().view(np.float32)
    c = (c.reshape(tiles, 4, 52)[..., :50].reshape(tiles, 4, 25, 2)
         .transpose(0, 2, 1, 3).reshape(-1))
    return (torch.as_tensor(parts.transpose(0, 2, 1).copy()),
            torch.as_tensor(c))


def six(a, b, lo):
    """One k16 step's six products of the parts, entries ``lo .. lo +
    15``, in the kernels' order, summed in float32."""
    t = None
    for i, j in PRODUCTS:
        p = a[i][:, lo:lo + 16] @ b[j][lo:lo + 16]
        t = p if t is None else t + p
    return t


def logits_as_the_kernel(x, bufs):
    """The logits ``(n, K)`` of rows ``x (n, 64)`` as the ``"f32"`` core
    computes them: four steps of ``-2 b . x`` and 130 of ``u . A``, six
    products each into fresh sums added to the running float32 ones, then
    ``-2 c``, then times ``-1/2``."""
    k = bufs["b_rows"].shape[0]
    a3 = unpack3(bufs)
    lin3, c = unpack_linear(bufs)
    up = bf16_split3(x[:, gf.PAIR_A] * x[:, gf.PAIR_B])
    xp = bf16_split3(x)
    acc = six(xp, lin3, 0)
    for s in range(1, gf.D // 16):
        acc = acc + six(xp, lin3, 16 * s)
    for s in range(gf.WG3_STEPS):
        acc = acc + six(up, a3, 16 * s)
    return (-0.5 * (acc - 2.0 * c))[:, :k]


def k4_as_the_kernel(xtn, lse, valid, dv, bufs, shape, stride):
    """K4 as the kernel computes it: the weights ``exp(logit - lse)`` of
    :func:`logits_as_the_kernel`'s logits (0 for an invalid patch), ``g
    = sum_k w_k (b_k - A_k x)`` in float32, ``u = dv g / sum w``, then
    the mean subtracted and the overlap-add."""
    live = valid > 0.5
    w = torch.exp(logits_as_the_kernel(xtn, bufs) - lse[:, None])
    w = torch.where(live[:, None], w, torch.zeros_like(w))
    g = w @ bufs["b_rows"] - gf.mix_rows(w, xtn, bufs)
    u = dv[:, None] * g / w.sum(dim=1, keepdim=True)
    u = torch.where(live[:, None], u, torch.zeros_like(u))
    return gf._patches_to_image(u, valid, shape, stride)


def anchored(got, plain32, plain64):
    """``chip_smoke.py`` phase 2's bar of the marginalise kernels."""
    err = float((got.to(plain64.dtype) - plain64).abs().max())
    err32 = float((plain32.to(plain64.dtype) - plain64).abs().max())
    scale = float(plain64.abs().max())
    assert err <= 2.0 * err32 + 1e-6 * scale, (err, err32, scale)


def make_image(shape, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:8, :10] = 2.0 * SENTINEL
    return torch.as_tensor(img)


def jax_rows(gmm_j, xtn, dv):
    """The JAX package's ``"highest"`` patch-level kernels (interpreted)
    on the rows: logsumexp, argmax, and the gradient of ``sum(dv *
    values)`` with respect to the rows."""
    args = (gmm_j.packed, gmm_j.means_precisions_cholesky,
            gmm_j.precisions_cholesky, gmm_j.pixel_weights)

    def score(x):
        return gmm_score_pallas(x, *args, True, marginalize=True)

    rows, dvj = jnp.asarray(xtn.numpy()), jnp.asarray(dv.numpy())
    values, argmax = score(rows)
    grad = jax.grad(lambda x: jnp.sum(dvj * score(x)[0]))(rows)
    return (torch.as_tensor(np.asarray(values)),
            torch.as_tensor(np.asarray(argmax)),
            torch.as_tensor(np.asarray(grad)))


def test_three_planes_are_the_split_of_the_pair_form(gmms):
    """``pair_wg3`` holds ``bf16_split3`` of the float32 pair form, zero
    components past K; the parts sum to it within 2^-24 of it."""
    _, bufs = gmms
    k = bufs["b_rows"].shape[0]
    a3 = unpack3(bufs)
    aq = bufs["aq"].reshape(gf.D, gf.D, k)
    pair = aq[gf.PAIR_A, gf.PAIR_B] + torch.where(
        torch.as_tensor(gf.PAIR_A < gf.PAIR_B)[:, None],
        aq[gf.PAIR_B, gf.PAIR_A], torch.zeros(()))
    for got, want in zip(a3[:, :, :k], bf16_split3(pair)):
        assert torch.equal(got, want)
    assert not a3[:, :, k:].any()
    assert_allclose(a3.sum(dim=0)[:, :k].numpy(), pair.numpy(), rtol=2**-24,
                    atol=0)


@pytest.mark.parametrize("shape,stride", CASES)
def test_six_products_match_float64_and_jax(gmms, shape, stride):
    """K1 lse and K4 as the kernels compute them against the float64
    plain versions (the anchored bar) and, with the float32 plain
    versions, against the JAX package's ``"highest"`` kernels."""
    gmm_j, bufs = gmms
    b64 = {name: t.double() for name, t in bufs.items()}
    image = make_image(shape)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, SENTINEL,
                                              True)
    m = valp > 0.5
    assert 0 < int(m.sum()) < len(m)
    logits = logits_as_the_kernel(xp, bufs)
    lse = torch.logsumexp(logits, dim=1)
    argmax = torch.max(logits, dim=1).indices.to(torch.int32)
    v64, _, _, _ = gf.fused_forward_plain(image.double(), b64, stride,
                                          SENTINEL, True)
    anchored(lse[m], vp[m], v64[m])
    assert_allclose(lse[m].numpy(), vp[m].numpy(), rtol=1e-5)
    assert_array_equal(argmax[m].numpy(), ap[m].numpy())

    dv = torch.as_tensor(np.random.RandomState(2).randn(len(vp)),
                         dtype=torch.float32) * valp
    grad = k4_as_the_kernel(xp, lse, valp, dv, bufs, shape, stride)
    g32 = gf.fused_backward_marg_plain(xp, vp, valp, dv, bufs, shape, stride)
    g64 = gf.fused_backward_marg_plain(*(t.double() for t in (xp, vp, valp,
                                                                dv)),
                                       b64, shape, stride)
    anchored(grad, g32, g64)

    vj, aj, rows_j = jax_rows(gmm_j, xp, dv)
    grad_j = gf._patches_to_image(rows_j, valp, shape, stride)
    for values in (lse, vp):
        assert_allclose(values[m].numpy(), vj[m].numpy(), rtol=1e-5)
    assert_array_equal(argmax[m].numpy(), aj[m].numpy())
    scale = float(grad_j.abs().max())
    for got in (grad, g32):
        assert_allclose(got.numpy(), grad_j.numpy(), rtol=0,
                        atol=1e-4 * scale)


class FakeLibrary:
    """A kernel library whose C entries record their calls and return
    ``code``."""

    def __init__(self, name, calls, code=0):
        self.name, self.calls, self.code = name, calls, code

    def __getattr__(self, entry):
        if entry.endswith("error_string"):
            return lambda code: b"fake"

        def call(*args):
            self.calls.append((self.name, entry, args))
            return self.code
        return call


def fake_card(monkeypatch, code=0):
    """Recorded stand-ins for the kernel libraries, the wrappers' CUDA
    check and the dispatch lifted, so that a CPU tensor stands for a
    card's (132 SMs); returns the list the calls go to."""
    calls = []
    for name, lib in (("_library", "gmm_fused"),
                      ("_wg_library", "gmm_score_wg")):
        monkeypatch.setattr(gf, name,
                            lambda lib=lib: FakeLibrary(lib, calls, code))
    monkeypatch.setattr(gf, "dispatch", lambda t: "kernel")
    monkeypatch.setattr(gf, "_cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


def marginalised_score(image, bufs, stride):
    """The fused scorer's marginalised values under ``"f32"``, and the
    image gradient of their sum."""
    x = image.clone().requires_grad_(True)
    values, _, valid = gf.gmm_score_fused_image(
        x, (8, 8), stride, bufs, SENTINEL, marginalize=True, mode="f32")
    torch.where(valid, values, torch.zeros_like(values)).sum().backward()
    return values, x.grad


def test_highest_marginalise_routes_to_the_warpgroup_kernels(monkeypatch):
    """On a card, ``"f32"`` marginalises through ``gmm_score_wg``'s
    entries with six products: K1 lse on the image with ``pair_wg3`` and
    ``lin_wg``, then K4 on K1's patches, logsumexp and validity, one CTA
    a tile of 128 rows up to the SMs, each wrapper counting its launch
    (:func:`fake_card`)."""
    calls = fake_card(monkeypatch)
    bufs = TGMM.from_registry("astro-snr-v1").kernel_buffers("cpu")
    gf.reset_counters()
    marginalised_score(make_image((24, 40)), bufs, 8)
    assert [c[:2] for c in calls] == [
        ("gmm_score_wg", "gmm_score_wg_image_lse"),
        ("gmm_score_wg", "gmm_score_wg_mix")]
    fwd, bwd = (c[2] for c in calls)
    assert fwd[1:11] == (24, 40, 8, 3, 5, SENTINEL,
                         bufs["pair_wg3"].data_ptr(),
                         bufs["lin_wg"].data_ptr(), 200, 6)
    # xtn, lse (the forward's values), valid: the forward's outputs
    assert (bwd[0], bwd[1], bwd[2]) == (fwd[14], fwd[11], fwd[13])
    assert bwd[4:8] == tuple(bufs[name].data_ptr() for name in (
        "pair_wg3", "lin_wg", "a_full", "b_rows"))
    assert bwd[8:15] == (24, 40, 8, 3, 5, 200, 6)
    assert bwd[16] == 1  # 15 patches: one tile of rows
    assert fwd[-1] == bwd[-1] == 0  # the stream
    assert (gf.gmm_fused_fwd_marg_cuda.launches,
            gf.gmm_fused_bwd_marg_cuda.launches) == (1, 1)
    assert gf.fused_forward_plain.calls == 0
    assert gf.fused_backward_marg_plain.calls == 0


def test_highest_marginalise_raises_where_a_launch_fails(monkeypatch):
    """A kernel that reports an error raises: nothing falls back to the
    plain versions."""
    fake_card(monkeypatch, code=1)
    bufs = TGMM.from_registry("astro-snr-v1").kernel_buffers("cpu")
    gf.reset_counters()
    with pytest.raises(RuntimeError, match="gmm_score_wg_image_lse"):
        marginalised_score(make_image((24, 40)), bufs, 8)
    assert gf.fused_forward_plain.calls == 0


def test_highest_marginalise_on_the_cpu_runs_the_plain_versions():
    """A CPU tensor takes the plain versions under ``"f32"``, and their
    gradient is the float32 plain backward's."""
    bufs = TGMM.from_registry("astro-snr-v1").kernel_buffers("cpu")
    image = make_image((24, 40))
    gf.reset_counters()
    values, grad = marginalised_score(image, bufs, 8)
    assert (gf.fused_forward_plain.calls,
            gf.fused_backward_marg_plain.calls) == (1, 1)
    assert (gf.gmm_fused_fwd_marg_cuda.launches,
            gf.gmm_fused_bwd_marg_cuda.launches) == (0, 0)
    vp, _, valp, xp = gf.fused_forward_plain(image, bufs, 8, SENTINEL, True)
    assert torch.equal(values, vp)
    want = gf.fused_backward_marg_plain(xp, vp, valp, valp, bufs,
                                        image.shape, 8)
    assert torch.equal(grad, want)
