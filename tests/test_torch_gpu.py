"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``; every test skips without a card. On a machine with one
(and without JAX, whose test configuration this file does not need):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: ``valid`` and the normalised patches exact to 1e-5; values
to rtol 1e-5 (float32 sums in different orders; the tensor-core
scorers of the ``"split"`` mode, K1 split and K5 split, against the
split plain version, which forms the same bf16 products, to rtol 7e-5,
``chip_smoke.py``'s ``K1_SPLIT_RTOL``: the tensor cores' sums are not
IEEE sums); argmax identical; the image gradient, the unit gradient and
the Hessian action to 1e-4 of their max-abs, the image gradient (K2)
and the row map (K6, K7) also bitwise repeatable, K2 free of host
synchronisation; the flux errors of the Hessian probe, card against CPU,
to rtol 1e-4 (float32 FFTs and sums in other orders). The marginalise
kernels (K4, K8, K9) are held against their plain versions run in
float64 on the same inputs: at most twice the float32 plain version's
max-abs error plus 1e-6 of the result's max-abs (softmax weights of
logits of order 1e5 to 1e8 are ill-conditioned in float32); they run on
the ``astro-snr-v1`` GMM, whose weights are nearly one-hot, and on a
random SPD GMM, whose weights are not; K9b also at 65,025 rows on
one-hot, mixed and made-up weights, bitwise repeatable. Their ``"split"`` kernels on the
tensor cores: the logsumexp as the MAP forward's against the split plain
version, the backward fed by it against the float64 pipeline within
twice the split plain pipeline's error, scaled by how much further the
logsumexp lies from float64 than the split plain one
(``chip_smoke.split_lse_ratio``), plus 1e-6 of the max-abs, and
bitwise repeatable; the probe's K8 split and K9a split, fed K5 lse
split's logsumexp, against the float64 plain versions within
``chip_smoke.MARG_SPLIT_FACTOR`` times the split plain pipeline's
error, plus 1e-6 of the max-abs, dp also within its own float32
rounding (``chip_smoke.probe_split_compare``). The
matrix-DFT convolution's
three float32 kernels (K3) are held the same way against their plain
version in float64, and the whole pipeline also within 1e-5 of its
max-abs; the tensor-core kernels of its ``"split"`` mode against the
float64 plain version within twice the float32 split plain version's
error plus 1e-6 of the max-abs, and within 1e-4 of it (split's own
error is about 3e-5); the pfft path's loss, gradient and flux errors,
card against CPU under the default dial (split on both), to rtol 1e-5
and 1e-4. The ``"bf16"`` kernels (the ``"default"`` setting: one bf16
product a step) are held to the same bars against the bf16 plain
versions, the probe's and the marginalise backward's against the float64
sums of the same bf16-rounded operands (``chip_smoke.bf16_reference``),
K3's within the anchored bar and at least half the bf16 plain version's
error against float64 (``chip_smoke.bf16_anchored``).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SENTINEL = -1e5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def gmm():
    from jolideco_torch.priors import GaussianMixtureModel

    return GaussianMixtureModel.from_registry("astro-snr-v1")


def make_image(shape, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:8, :16] = 2.0 * SENTINEL
    return img


@pytest.mark.parametrize("shape,stride", [
    ((16, 128), 4), ((20, 136), 2), ((64, 256), 8), ((37, 203), 4),
    ((24, 40), 4),
])
def test_kernels_match_plain(device, gmm, shape, stride):
    from jolideco_torch.ops import gmm_fused as gf

    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    vk, ak, valk, xk = gf.gmm_fused_fwd_cuda(image, bufs, stride, SENTINEL)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, SENTINEL)
    torch.cuda.synchronize()
    assert torch.equal(valk, valp)
    m = valp > 0.5
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(vk[m], vp[m], rtol=1e-5, atol=0)
    assert torch.equal(ak[m], ap[m])

    dv = torch.randn(vp.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    gk = gf.gmm_fused_bwd_cuda(xp, ap, valp, dv * valp, bufs, shape, stride)
    gp = gf.fused_backward_plain(xp, ap, valp, dv * valp, bufs, shape, stride)
    torch.cuda.synchronize()
    torch.testing.assert_close(gk, gp, rtol=0,
                               atol=1e-4 * float(gp.abs().max()))


@pytest.mark.parametrize("name,shape,stride", [
    ("astro-snr-v1", (96, 160), 4), ("astro-snr-v1", (37, 203), 2),
    ("builtin-8x8-v1", (64, 136), 4), ("wide-256", (96, 160), 4),
    ("wide-256", (37, 203), 2), ("mixed-256", (96, 160), 4),
])
def test_tensor_core_forward_matches_split_plain(device, name, shape,
                                                 stride):
    """K1's ``"split"`` kernel against the split plain version: ``valid``
    and the normalised patches as the float32 kernel's, values to rtol
    7e-5 (the same bf16 products summed by the tensor cores, whose sums
    are not IEEE sums, and by cuBLAS: ``chip_smoke.K1_SPLIT_RTOL``),
    argmax identical; K = 64 leaves most of the kernel's 208 columns
    padding, and the 256 components of ``chip_smoke.wide_gmm`` and of
    the random SPD ``chip_smoke.mixed_gmm(256)`` take two of its tiles,
    each winning some patches."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel

    import chip_smoke

    wide = {"wide-256": chip_smoke.wide_gmm,
            "mixed-256": lambda: chip_smoke.mixed_gmm(256)}
    gmm = (wide[name]() if name in wide
           else GaussianMixtureModel.from_registry(name))
    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    vk, ak, valk, xk = gf.gmm_fused_fwd_tc_cuda(image, bufs, stride,
                                                SENTINEL)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, SENTINEL,
                                              mode="split")
    torch.cuda.synchronize()
    assert torch.equal(valk, valp)
    m = valp > 0.5
    assert 0 < int(m.sum()) < m.numel()
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(vk[m], vp[m], rtol=7e-5, atol=0)
    assert torch.equal(ak[m], ap[m])
    if gmm.n_components > gf.KP_TC:
        assert 0 < int((ap[m] >= gf.KP_TC).sum()) < int(m.sum())


@pytest.mark.parametrize("name,shape,stride", [
    ("astro-snr-v1", (96, 160), 4), ("builtin-8x8-v1", (64, 136), 4),
    ("wide-256", (37, 203), 2),
])
def test_bf16_forward_and_row_scorer_match_bf16_plain(device, name, shape,
                                                      stride):
    """K1 bf16 (MAP and logsumexp) and K5 bf16 (both instances) against
    the bf16 plain versions: ``valid`` and the normalised patches as the
    plain version's, values to rtol 7e-5 (``chip_smoke.K1_SPLIT_RTOL``:
    the same bf16 products, summed by the tensor cores and by cuBLAS),
    argmax identical. A single bf16 rounding is not continuous, so K1's
    values are held against the bf16 plain scorer of the kernel's own
    normalised patches (``chip_smoke.k1_split_checks`` says why)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel

    import chip_smoke

    gmm = (chip_smoke.wide_gmm() if name == "wide-256"
           else GaussianMixtureModel.from_registry(name))
    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    for marginalize in (False, True):
        kernel = (gf.gmm_fused_fwd_marg_bf16_cuda if marginalize
                  else gf.gmm_fused_fwd_bf16_cuda)
        vk, ak, valk, xk = kernel(image, bufs, stride, SENTINEL)
        _, _, valp, xp = gf.fused_forward_plain(image, bufs, stride,
                                                SENTINEL, marginalize,
                                                mode="bf16")
        vp, ap = gf.PLAIN_SCORES["bf16", marginalize](xk, bufs)
        torch.cuda.synchronize()
        assert torch.equal(valk, valp)
        m = valp > 0.5
        torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
        torch.testing.assert_close(vk[m], vp[m], rtol=chip_smoke.K1_SPLIT_RTOL,
                                   atol=0)
        assert torch.equal(ak[m], ap[m])
    x = torch.as_tensor(make_rows(1000), device=device)
    for kernel, plain in ((gp.gmm_score_rows_bf16_cuda, gf.score_bf16_plain),
                          (gp.gmm_score_rows_marg_bf16_cuda,
                           gf.score_bf16_marg_plain)):
        vk, ak = kernel(x, bufs)
        vp, ap = plain(x, bufs)
        torch.cuda.synchronize()
        torch.testing.assert_close(vk, vp, rtol=chip_smoke.K1_SPLIT_RTOL,
                                   atol=0)
        assert torch.equal(ak, ap)


@pytest.mark.parametrize("dial,mode", [("highest", "f32"), ("high", "split"),
                                       ("default", "bf16")])
def test_fused_forward_launches_by_dial(device, gmm, dial, mode):
    """The prior on the card under each dial: the tensor-core forward
    under ``"high"`` (three products a step) and ``"default"`` (one), the
    float32 one under ``"highest"``, once each; K2 once; no plain
    call."""
    from jolideco_torch import config
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GMMPatchPrior

    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False)
    x = torch.as_tensor(make_image((96, 160))[None, None].clip(0.1),
                        device=device).requires_grad_(True)
    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        gf.reset_counters()
        prior(x).backward()
        torch.cuda.synchronize()
    finally:
        config.set_gmm_precision(saved)
    launches = {"f32": gf.gmm_fused_fwd_cuda.launches,
                "split": gf.gmm_fused_fwd_tc_cuda.launches,
                "bf16": gf.gmm_fused_fwd_bf16_cuda.launches}
    assert launches == {m: int(m == mode) for m in launches}
    assert gf.gmm_fused_bwd_cuda.launches == 1
    assert (gf.fused_forward_plain.calls, gf.fused_backward_plain.calls) \
        == (0, 0)


def test_prior_on_card_matches_cpu(device, gmm):
    from jolideco_torch.priors import GMMPatchPrior

    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True)
    flux = np.random.RandomState(1).uniform(0.1, 2.0, (1, 1, 96, 160))
    results = {}
    for dev in ("cpu", device):
        x = torch.as_tensor(flux.astype(np.float32), device=dev)
        x.requires_grad_(True)
        value = prior(x, shifts=(1, -2))
        value.backward()
        results[str(dev)] = (value.item(), x.grad.cpu())
    (v_cpu, g_cpu), (v_gpu, g_gpu) = results.values()
    np.testing.assert_allclose(v_gpu, v_cpu, rtol=1e-5)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-4 * float(g_cpu.abs().max()))


def make_rows(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-0.5, 0.5, size=(n, 64)).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    x[:3] = 0.0                       # masked patches score as zero rows
    return x


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4097])
def test_patch_kernels_match_plain(device, gmm, n):
    from jolideco_torch.ops import gmm_pallas as gp

    bufs = gmm.kernel_buffers(device)
    x = torch.as_tensor(make_rows(n), device=device)
    t = torch.randn(x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    for marginalize in (False, True):
        vk, ak = gp.gmm_score_rows_cuda(x, bufs, marginalize)
        vp, ap = gp.score_rows_plain(x, bufs, marginalize)
        torch.cuda.synchronize()
        torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0)
        assert torch.equal(ak, ap)
    for kern, plain, arg in ((gp.gmm_unit_map_cuda, gp.unit_map_plain, x),
                             (gp.gmm_hvp_map_cuda, gp.hvp_map_plain, t)):
        got, want = kern(arg, ap, bufs), plain(arg, ap, bufs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("name,n", [
    ("astro-snr-v1", 1), ("astro-snr-v1", 257), ("astro-snr-v1", 4097),
    ("builtin-8x8-v1", 1000), ("wide-256", 4097),
])
def test_tensor_core_row_scorer_matches_split_plain(device, name, n):
    """K5 split (``gmm_score_rows_tc_kernel``, both instances) against the
    split plain versions on rows: values to rtol 7e-5
    (``chip_smoke.K1_SPLIT_RTOL``: K1 split's logits), argmax identical,
    the ragged tail of a block masked; the 256 components of
    ``chip_smoke.wide_gmm`` take two of the kernel's tiles, each winning
    some rows."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel

    import chip_smoke

    gmm = (chip_smoke.wide_gmm() if name == "wide-256"
           else GaussianMixtureModel.from_registry(name))
    bufs = gmm.kernel_buffers(device)
    x = torch.as_tensor(make_rows(n), device=device)
    for kernel, plain in ((gp.gmm_score_rows_tc_cuda, gf.score_split_plain),
                          (gp.gmm_score_rows_marg_tc_cuda,
                           gf.score_split_marg_plain)):
        vk, ak = kernel(x, bufs)
        vp, ap = plain(x, bufs)
        torch.cuda.synchronize()
        torch.testing.assert_close(vk, vp, rtol=chip_smoke.K1_SPLIT_RTOL,
                                   atol=0)
        assert torch.equal(ak, ap)
    if gmm.n_components > gf.KP_TC:
        assert 0 < int((ap >= gf.KP_TC).sum()) < n


@pytest.mark.parametrize("period", [1, 7, 200])
def test_row_map_any_components_per_tile(device, period):
    """K6 and K7 where the rows of a block select ``period`` components in
    turn (one run of 128 rows, runs crossing the half-warps' places, one
    row a run) over 4,097 rows against the plain versions at the 1e-4
    bar; two calls give the same bits."""
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel

    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        device)
    n = 4097
    x = torch.as_tensor(make_rows(n, seed=period), device=device)
    t = torch.randn(x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(2))
    argmax = (torch.arange(n, device=device) % period).to(torch.int32)
    for kern, plain, arg in ((gp.gmm_unit_map_cuda, gp.unit_map_plain, x),
                             (gp.gmm_hvp_map_cuda, gp.hvp_map_plain, t)):
        got, again = kern(arg, argmax, bufs), kern(arg, argmax, bufs)
        want = plain(arg, argmax, bufs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        assert torch.equal(got, again)


def test_patch_kernels_take_only_8x8_patches(device):
    """A 16x16 GMM is scored on the card by the plain scorer: K5 (and
    every patch kernel) never launched, its values and gradient the
    CPU's."""
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.utils.interop import gmm_from_arrays

    rs = np.random.RandomState(2)
    covariances = np.stack([a @ a.T / 256 + 0.1 * np.eye(256)
                            for a in rs.randn(3, 256, 256)])
    gmm16 = gmm_from_arrays(0.1 * rs.randn(3, 256), covariances,
                            np.ones(3) / 3, 8)
    rows = rs.randn(40, 256).astype(np.float32)
    out = {}
    for dev in (device, "cpu"):
        x = torch.as_tensor(rows, device=dev).requires_grad_(True)
        gp.reset_counters()
        values, _ = gp.gmm_score_patches(x, gmm16.kernel_buffers(dev))
        values.sum().backward()
        launches = [fn.launches for fn in (
            gp.gmm_score_rows_cuda, gp.gmm_score_rows_tc_cuda,
            gp.gmm_unit_map_cuda, gp.gmm_hvp_map_cuda)]
        out[str(dev)] = (values.detach().cpu(), x.grad.cpu(),
                         gp.score_rows_plain.calls, launches)
    card, cpu = out[str(device)], out["cpu"]
    assert card[2] == cpu[2] == 1
    assert card[3] == [0, 0, 0, 0]
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(card[1], cpu[1], rtol=0,
                               atol=1e-5 * float(cpu[1].abs().max()))


@pytest.mark.parametrize("dial,tc", [("high", True), ("highest", False)])
def test_probe_on_card_matches_cpu(device, gmm, dial, tc):
    """``TotalLoss.fluxes_error`` at 64² (two observations, cycle spin
    fixed) under each dial, card against CPU (the dial's plain scorer),
    with the dial's K5 (K5 split under ``"high"``, the float32 K5 under
    ``"highest"``), K6 and K7 launched once each."""
    from jolideco_torch import FluxComponents, GMMPatchPrior, MAPDeconvolver
    from jolideco_torch import SpatialFluxComponent, config
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=2, size=64, psf_size=9, seed=3)
    flux = np.random.RandomState(4).uniform(0.5, 2.0, (64, 64))
    errors = {}
    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        for dev in ("cpu", device):
            comps = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
                flux, prior=GMMPatchPrior(gmm=gmm, stride=4))})
            deco = MAPDeconvolver(update_strategy="joint", trace_every=0,
                                  device=dev, conv_mode="fft")
            total = deco.build_loss(datasets, components=comps,
                                    device=torch.device(dev))
            for comp in comps.values():
                comp.to(dev)
            gf.reset_counters()
            gp.reset_counters()
            out = total.fluxes_error(comps.fluxes_from(),
                                     shifts={"flux": (1, -2)})
            errors[str(dev)] = out["flux"].cpu()
            if dev != "cpu":
                launches = (gp.gmm_score_rows_tc_cuda.launches,
                            gp.gmm_score_rows_cuda.launches,
                            gp.gmm_unit_map_cuda.launches,
                            gp.gmm_hvp_map_cuda.launches)
                assert launches == ((1, 0, 1, 1) if tc else (0, 1, 1, 1))
                assert gf.gmm_fused_fwd_cuda.launches == 0
                assert gf.gmm_fused_fwd_tc_cuda.launches == 0
    finally:
        config.set_gmm_precision(saved)
    err_cpu, err_gpu = errors.values()
    assert torch.isfinite(err_cpu).all() and (err_cpu > 0).all()
    torch.testing.assert_close(err_gpu, err_cpu, rtol=1e-4, atol=0)


def anchored(got, plain32, plain64, factor=2.0):
    err = float((got.double() - plain64).abs().max())
    err32 = float((plain32.double() - plain64).abs().max())
    assert err <= factor * err32 + 1e-6 * float(plain64.abs().max()), (
        err, err32)


@pytest.fixture(scope="module", params=["astro-snr-v1", "random-spd"])
def marg_gmm(request):
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.interop import gmm_from_arrays

    if request.param == "random-spd":
        rs = np.random.RandomState(1)
        a = rs.randn(13, 64, 64) / 8.0
        covariances = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(64)
        return gmm_from_arrays(rs.rand(13, 64), covariances,
                               rs.dirichlet(np.ones(13)), None)
    return GaussianMixtureModel.from_registry(request.param)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4097])
def test_marginalise_patch_kernels_match_float64(device, marg_gmm, n):
    from jolideco_torch.ops import gmm_pallas as gp

    bufs = marg_gmm.kernel_buffers(device)
    b64 = {k: v.double() for k, v in bufs.items()}
    x = torch.as_tensor(make_rows(n), device=device)
    t = torch.randn(x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    lse, _ = gp.score_rows_plain(x, bufs, True)
    x64, t64, lse64 = x.double(), t.double(), lse.double()
    anchored(gp.gmm_unit_marg_cuda(x, lse, bufs),
             gp.unit_marg_plain(x, lse, bufs),
             gp.unit_marg_plain(x64, lse64, b64))
    pk, dpk = gp.gmm_hvp_marg_weights_cuda(x, t, lse, bufs)
    p32, dp32 = gp.hvp_marg_weights_plain(x, t, lse, bufs)
    p64, dp64 = gp.hvp_marg_weights_plain(x64, t64, lse64, b64)
    anchored(pk, p32, p64)
    anchored(dpk, dp32, dp64)
    anchored(gp.gmm_hvp_marg_mix_cuda(x, t, pk, dpk, bufs),
             gp.hvp_marg_mix_plain(x, t, p32, dp32, bufs),
             gp.hvp_marg_mix_plain(x64, t64, p64, dp64, b64))
    torch.cuda.synchronize()


def mix_weights(case, x, t, device):
    """The GMM's buffers and the weights ``p``, ``dp`` ``(K, N)`` of a K9b
    case at ``x``'s rows (see :func:`test_hvp_marg_mix_cases`)."""
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors import GaussianMixtureModel

    import chip_smoke

    if case == "mixed":
        gmm = chip_smoke.mixed_gmm()
    else:
        gmm = GaussianMixtureModel.from_registry("astro-snr-v1")
    bufs = gmm.kernel_buffers(device)
    if case in ("one-hot", "mixed"):
        lse, _ = gp.score_rows_plain(x, bufs, True)
        p, dp = gp.hvp_marg_weights_plain(x, t, lse, bufs)
        return bufs, p, dp
    n, k = x.shape[0], bufs["rec"].shape[0]
    rs = np.random.RandomState(len(case))
    rows = np.arange(n)
    if case == "chunks":
        picks = [rows % 7, 64 + rows % 5, 150 + rows % 3,
                 np.where(rows % 4 == 0, 199, 150 + rows % 3)]
    else:
        picks = [rows % int(case)]
    p = np.zeros((k, n), np.float32)
    dp = np.zeros((k, n), np.float32)
    for pick in picks:
        p[pick, rows] = rs.uniform(0.1, 1.0, n)
        dp[pick, rows] = rs.randn(n)
    dp[picks[0][::5], rows[::5]] = 0.0
    return bufs, torch.as_tensor(p, device=device), torch.as_tensor(
        dp, device=device)


@pytest.mark.parametrize("case", ["one-hot", "mixed", "chunks", "1", "3",
                                  "7", "19", "200"])
def test_hvp_marg_mix_cases(device, case):
    """K9b at the main path's 65,025 rows (the last tile of 128 rows holds
    one) against the plain version in float32 and float64 (the anchored
    bar), and twice on the same inputs with the same bits: the float32
    plain first stage's weights under ``astro-snr-v1`` (one-hot) and
    ``chip_smoke.mixed_gmm()`` (mixed, K = 200), entries of each row in
    three chunks of 64 components, and one component a row at row index
    mod 1, 3, 7, 19 and 200."""
    from jolideco_torch.ops import gmm_pallas as gp

    n = 65025
    x = torch.as_tensor(make_rows(n), device=device)
    t = torch.randn(x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    bufs, p, dp = mix_weights(case, x, t, device)
    b64 = {k: v.double() for k, v in bufs.items()}
    got = gp.gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs)
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
    anchored(got, gp.hvp_marg_mix_plain(x, t, p, dp, bufs),
             gp.hvp_marg_mix_plain(x.double(), t.double(), p.double(),
                                   dp.double(), b64))
    assert torch.equal(got, gp.gmm_hvp_marg_mix_cuda(x, t, p, dp, bufs))


@pytest.mark.parametrize("name,n", [
    ("astro-snr-v1", 257), ("astro-snr-v1", 4097), ("random-spd", 1000),
    ("wide-256", 4097), ("mixed-200", 1000), ("mixed-256", 257),
])
def test_marginalise_split_probe_kernels_match_float64(device, name, n):
    """K8 split and K9a split (tensor cores, ``"split"``) fed K5 lse
    split's logsumexp, as the probe runs them, against the plain versions
    in float64 (the exact logits' logsumexp, K4 split's reference), by
    ``chip_smoke.probe_split_compare``: within
    ``chip_smoke.MARG_SPLIT_FACTOR`` times the split plain pipeline's
    error plus 1e-6 of the max-abs, dp also within its own float32
    rounding (``chip_smoke.dp_rounding``); K9b on K9a split's weights the
    same; dp exactly 0 on the rows whose weight is one-hot; two controls
    (single bf16 logits, g without t . b) refused. One-hot weights
    (``astro-snr-v1``: at least 9 in 10 of the nonzero rows), a random
    SPD GMM (K = 13), two tiles of components (``chip_smoke.wide_gmm``, K
    = 256) and mixed weights (``chip_smoke.mixed_gmm``, K = 200 and 256).
    Prints the errors and their ratios to the split plain pipeline's."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.interop import gmm_from_arrays

    import chip_smoke

    def random_spd():
        rs = np.random.RandomState(1)
        a = rs.randn(13, 64, 64) / 8.0
        covariances = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(64)
        return gmm_from_arrays(rs.rand(13, 64), covariances,
                               rs.dirichlet(np.ones(13)), None)

    gmm = {"wide-256": chip_smoke.wide_gmm,
           "mixed-200": chip_smoke.mixed_gmm,
           "mixed-256": lambda: chip_smoke.mixed_gmm(256),
           "random-spd": random_spd}.get(
        name, lambda: GaussianMixtureModel.from_registry(name))()
    bufs = gmm.kernel_buffers(device)
    x = torch.as_tensor(make_rows(n), device=device)
    t = torch.randn(x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    out, _, one_hot = chip_smoke.probe_split_compare(torch, x, t, bufs)
    print(f"{name}, {n} rows: {chip_smoke.describe_probe_split(out)}")
    if name == "astro-snr-v1":
        # make_rows' three zero rows (masked patches) have two weights
        nonzero = x.abs().amax(dim=1) > 0
        assert int(one_hot[nonzero].sum()) >= 0.9 * int(nonzero.sum())


@pytest.mark.parametrize("name,n", [
    ("astro-snr-v1", 1000), ("wide-256", 1000), ("mixed-200", 1000),
])
def test_marginalise_bf16_kernels_match_float64(device, name, n):
    """K1 lse bf16 -> K4 bf16 on an image (``chip_smoke.marg_split_checks``
    with ``"bf16"``) and K8 bf16 and K9a bf16 fed K5 lse bf16's logsumexp
    on rows (``chip_smoke.probe_split_compare`` with ``"bf16"``), against
    the float64 sums of the same bf16-rounded operands: within
    ``chip_smoke.MARG_SPLIT_FACTOR`` times the bf16 plain pipeline's
    error plus 1e-6 of the max-abs, dp also within its own float32
    rounding; dp exactly 0 on one-hot rows; the controls (split logits, g
    without t . b) refused. Prints the errors."""
    from jolideco_torch.priors import GaussianMixtureModel

    import chip_smoke

    gmm = {"wide-256": chip_smoke.wide_gmm,
           "mixed-200": chip_smoke.mixed_gmm}.get(
        name, lambda: GaussianMixtureModel.from_registry(name))()
    bufs = gmm.kernel_buffers(device)
    chip_smoke.marg_split_checks(torch, device, f"card test {name}",
                                 make_image((96, 160)).clip(0.1), bufs,
                                 "bf16")
    x = torch.as_tensor(make_rows(n), device=device)
    t = torch.randn(x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    out, _, _ = chip_smoke.probe_split_compare(torch, x, t, bufs, "bf16")
    print(f"{name}, {n} rows: {chip_smoke.describe_probe_split(out)}")


@pytest.mark.parametrize("shape", [(37, 203), (64, 256)])
def test_marginalise_fused_kernels_match_plain(device, marg_gmm, shape):
    from jolideco_torch.ops import gmm_fused as gf

    bufs = marg_gmm.kernel_buffers(device)
    b64 = {k: v.double() for k, v in bufs.items()}
    image = torch.as_tensor(make_image(shape), device=device)
    vk, ak, valk, xk = gf.gmm_fused_fwd_marg_cuda(image, bufs, 4, SENTINEL)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, 4, SENTINEL, True)
    torch.cuda.synchronize()
    assert torch.equal(valk, valp)
    m = valp > 0.5
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(vk[m], vp[m], rtol=1e-5, atol=0)
    assert torch.equal(ak[m], ap[m])

    dv = torch.randn(vp.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    args = (xp, vp, valp, dv * valp)
    anchored(gf.gmm_fused_bwd_marg_cuda(*args, bufs, shape, 4),
             gf.fused_backward_marg_plain(*args, bufs, shape, 4),
             gf.fused_backward_marg_plain(*(a.double() for a in args), b64,
                                          shape, 4))


@pytest.mark.parametrize("name,shape", [
    ("astro-snr-v1", (96, 160)), ("astro-snr-v1", (37, 203)),
    ("wide-256", (96, 160)), ("mixed-200", (96, 160)),
    ("mixed-256", (37, 203)),
])
def test_marginalise_tensor_core_kernels_match_split_plain(device, name,
                                                           shape):
    """K1 lse split (``"split"`` mode, tensor cores) against the split
    plain version: ``valid``, the normalised patches to 1e-5, values to
    rtol 7e-5 (``chip_smoke.K1_SPLIT_RTOL``), argmax identical; K4 split,
    fed K1 lse split's logsumexp as training feeds it, against the float64
    pipeline within twice the split plain pipeline's error, times the
    share by which K1 lse split's logsumexp lies further from float64
    than the split plain version's (``chip_smoke.split_lse_ratio``: the
    weights inherit the tensor cores' sums), plus 1e-6 of the max-abs.
    One-hot weights (``astro-snr-v1``, K = 200), two tiles of
    components (``chip_smoke.wide_gmm``, K = 256) and mixed weights (the
    random SPD ``chip_smoke.mixed_gmm``, K = 200 and 256)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel

    import chip_smoke

    gmm = {"wide-256": chip_smoke.wide_gmm,
           "mixed-200": chip_smoke.mixed_gmm,
           "mixed-256": lambda: chip_smoke.mixed_gmm(256)}.get(
        name, lambda: GaussianMixtureModel.from_registry(name))()
    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    dv = torch.randn(gf.fused_patch_count(shape, 4), device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    tc, g_tc, sp, g_sp, (lse64, _, g64) = chip_smoke.marg_split_pipelines(
        torch, image, bufs, dv)
    torch.cuda.synchronize()
    (vk, ak, valk, xk), (vp, ap, valp, xp) = tc, sp
    assert torch.equal(valk, valp)
    m = valp > 0.5
    assert 0 < int(m.sum()) < m.numel()
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(vk[m], vp[m], rtol=7e-5, atol=0)
    assert torch.equal(ak[m], ap[m])
    lse_errs = {key: float((v[m].double() - lse64[m]).abs().max())
                for key, v in (("tc", vk), ("split_plain", vp))}
    anchored(g_tc, g_sp, g64, 2.0 * chip_smoke.split_lse_ratio(lse_errs))
    if name.startswith("mixed"):
        nnz, _ = chip_smoke.support(torch, xp[m], vp[m], bufs, "split")
        assert nnz >= 10 * int(m.sum())


@pytest.mark.parametrize("shape,stride", [((1024, 1024), 4), ((37, 203), 2)])
def test_map_backward_is_repeatable_and_needs_no_host(device, gmm, shape,
                                                      stride):
    """K2 twice on the same inputs gives the same bits (its sums have a
    fixed order, no float atomics), and it reads nothing back to the
    host: under ``set_sync_debug_mode("error")`` any synchronising call
    inside it raises."""
    from jolideco_torch.ops import gmm_fused as gf

    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    _, argmax, valid, xtn = gf.gmm_fused_fwd_cuda(image, bufs, stride,
                                                  SENTINEL)
    dv = torch.randn(valid.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(2))
    torch.cuda.synchronize()
    gf.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, second = (gf.gmm_fused_bwd_cuda(xtn, argmax, valid, dv, bufs,
                                               shape, stride)
                         for _ in range(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert gf.gmm_fused_bwd_cuda.launches == 2
    assert bool(torch.isfinite(first).all()) and bool(first.abs().max() > 0)
    assert torch.equal(first, second)
    want = gf.fused_backward_plain(xtn, argmax, valid, dv, bufs, shape,
                                   stride)
    torch.testing.assert_close(first, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("period", [1, 7, 200])
def test_map_backward_any_components_per_tile(device, period):
    """K2 where the 128 patches of a tile select ``period`` components in
    turn (one run of 128 patches, runs crossing the half-warps' places,
    one patch a run), at the valid patches of a 256 x 192 image, against
    the plain version."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel

    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        device)
    shape, stride = (256, 192), 4
    image = torch.as_tensor(make_image(shape), device=device)
    _, _, valid, xtn = gf.gmm_fused_fwd_cuda(image, bufs, stride, SENTINEL)
    n = valid.numel()
    gen = torch.Generator(device=device).manual_seed(period)
    argmax = (torch.arange(n, device=device) % period).to(torch.int32)
    dv = torch.randn(n, generator=gen, device=device)
    got = gf.gmm_fused_bwd_cuda(xtn, argmax, valid, dv, bufs, shape, stride)
    want = gf.fused_backward_plain(xtn, argmax, valid, dv, bufs, shape,
                                   stride)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_marginalise_tensor_core_backward_is_repeatable(device):
    """Two launches of K4 split on the same inputs give the same bits
    (no float atomics), where the weights are mixed."""
    from jolideco_torch.ops import gmm_fused as gf

    import chip_smoke

    bufs = chip_smoke.mixed_gmm().kernel_buffers(device)
    shape = (96, 160)
    image = torch.as_tensor(make_image(shape), device=device)
    lse, _, valid, xtn = gf.gmm_fused_fwd_marg_tc_cuda(image, bufs, 4,
                                                       SENTINEL)
    dv = torch.randn(lse.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    first, second = (gf.gmm_fused_bwd_marg_tc_cuda(xtn, lse, valid, dv, bufs,
                                                   shape, 4)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(first).all()) and bool(first.abs().max() > 0)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dial,mode", [("highest", "f32"), ("high", "split"),
                                       ("default", "bf16")])
def test_marginalised_launches_by_dial(device, gmm, dial, mode):
    """The marginalised prior on the card under each dial: K1 lse split
    and K4 split under ``"high"``, K1 lse bf16 and K4 bf16 under
    ``"default"``, the float32 K1 lse and K4 under ``"highest"``, once
    each; no plain call."""
    from jolideco_torch import config
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GMMPatchPrior

    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=False,
                          marginalize=True)
    x = torch.as_tensor(make_image((96, 160))[None, None].clip(0.1),
                        device=device).requires_grad_(True)
    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        gf.reset_counters()
        prior(x).backward()
        torch.cuda.synchronize()
    finally:
        config.set_gmm_precision(saved)
    launches = {"split": (gf.gmm_fused_fwd_marg_tc_cuda.launches,
                          gf.gmm_fused_bwd_marg_tc_cuda.launches),
                "bf16": (gf.gmm_fused_fwd_marg_bf16_cuda.launches,
                         gf.gmm_fused_bwd_marg_bf16_cuda.launches),
                "f32": (gf.gmm_fused_fwd_marg_cuda.launches,
                        gf.gmm_fused_bwd_marg_cuda.launches)}
    assert launches == {m: (int(m == mode),) * 2 for m in launches}
    assert (gf.gmm_fused_fwd_tc_cuda.launches, gf.gmm_fused_fwd_cuda.launches,
            gf.gmm_fused_fwd_bf16_cuda.launches,
            gf.gmm_fused_bwd_cuda.launches) == (0, 0, 0, 0)
    assert (gf.fused_forward_plain.calls,
            gf.fused_backward_marg_plain.calls) == (0, 0)


def test_marginalised_prior_on_card_matches_cpu(device, gmm):
    """The marginalised prior under the default dial, card (K1 lse split
    and K4 split) against CPU (their split plain versions)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GMMPatchPrior

    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True,
                          marginalize=True)
    flux = np.random.RandomState(1).uniform(0.1, 2.0, (1, 1, 96, 160))
    results = {}
    gf.reset_counters()
    for dev in ("cpu", device):
        x = torch.as_tensor(flux.astype(np.float32), device=dev)
        x.requires_grad_(True)
        value = prior(x, shifts=(1, -2))
        value.backward()
        results[str(dev)] = (value.item(), x.grad.cpu())
    assert (gf.gmm_fused_fwd_marg_tc_cuda.launches,
            gf.gmm_fused_bwd_marg_tc_cuda.launches) == (1, 1)
    (v_cpu, g_cpu), (v_gpu, g_gpu) = results.values()
    np.testing.assert_allclose(v_gpu, v_cpu, rtol=1e-5)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-4 * float(g_cpu.abs().max()))


@pytest.mark.parametrize("dial,mode", [("high", "split"), ("default", "bf16"),
                                       ("highest", "f32")])
def test_marginalised_probe_on_card_matches_cpu(device, gmm, dial, mode):
    """The marginalised prior's ``fluxes_error`` at 64², card against
    CPU, under each dial: K5 lse split, K8 split and K9a split under
    ``"high"``, their bf16 kernels under ``"default"``, their float32
    kernels under ``"highest"``, once each, and K9b once."""
    from jolideco_torch import FluxComponents, GMMPatchPrior, MAPDeconvolver
    from jolideco_torch import SpatialFluxComponent, config
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=2, size=64, psf_size=9, seed=3)
    flux = np.random.RandomState(4).uniform(0.5, 2.0, (64, 64))
    errors = {}
    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        for dev in ("cpu", device):
            comps = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
                flux, prior=GMMPatchPrior(gmm=gmm, stride=4,
                                          marginalize=True))})
            deco = MAPDeconvolver(update_strategy="joint", trace_every=0,
                                  device=dev, conv_mode="fft")
            total = deco.build_loss(datasets, components=comps,
                                    device=torch.device(dev))
            for comp in comps.values():
                comp.to(dev)
            gp.reset_counters()
            out = total.fluxes_error(comps.fluxes_from(),
                                     shifts={"flux": (1, -2)})
            errors[str(dev)] = out["flux"].cpu()
            if dev != "cpu":
                launches = {
                    "split": (gp.gmm_score_rows_marg_tc_cuda.launches,
                              gp.gmm_unit_marg_tc_cuda.launches,
                              gp.gmm_hvp_marg_weights_tc_cuda.launches),
                    "bf16": (gp.gmm_score_rows_marg_bf16_cuda.launches,
                             gp.gmm_unit_marg_bf16_cuda.launches,
                             gp.gmm_hvp_marg_weights_bf16_cuda.launches),
                    "f32": (gp.gmm_score_rows_cuda.launches,
                            gp.gmm_unit_marg_cuda.launches,
                            gp.gmm_hvp_marg_weights_cuda.launches)}
                assert launches == {m: (int(m == mode),) * 3
                                    for m in launches}
                assert gp.gmm_hvp_marg_mix_cuda.launches == 1
    finally:
        config.set_gmm_precision(saved)
    err_cpu, err_gpu = errors.values()
    assert torch.isfinite(err_cpu).all() and (err_cpu > 0).all()
    torch.testing.assert_close(err_gpu, err_cpu, rtol=1e-4, atol=0)


def pfft_anchored(got, plain32, plain64):
    err = float((got.to(plain64.dtype) - plain64).abs().max())
    err32 = float((plain32.to(plain64.dtype) - plain64).abs().max())
    assert err <= 2.0 * err32 + 1e-6 * float(plain64.abs().max()), (err, err32)


@pytest.mark.parametrize("conj_spec", [False, True])
@pytest.mark.parametrize("p_,h,w,k", [
    (1, 128, 128, 9), (2, 256, 128, 33), (3, 128, 384, 9), (2, 384, 256, 65),
])
def test_pfft_kernels_match_float64(device, p_, h, w, k, conj_spec):
    from jolideco_torch.ops import pallas_fft as pf

    rs = np.random.RandomState(h + w + k)
    x0, x1 = (torch.as_tensor(rs.randn(p_, h, w).astype(np.float32),
                              device=device) for _ in range(2))
    n = pf.pfft_size(max(h, w) + k - 1)
    planes = [pf.pfft_pair_spectra(rs.rand(k, k), rs.rand(k, k), (h, w), n)
              for _ in range(p_)]
    spectra = [torch.as_tensor(np.stack([q[j] for q in planes]),
                               device=device) for j in range(4)]
    c128, f64 = torch.complex128, torch.float64
    pf.reset_counters()
    u = pf.pfft_cols_fwd_cuda(x0, x1, n)
    pfft_anchored(u, pf.cols_fwd_plain(x0, x1, n),
                  pf.cols_fwd_plain(x0.double(), x1.double(), n, f64))
    v = pf.pfft_rows_combine_cuda(u, *spectra, conj_spec)
    for got, want32, want64 in zip(
            v, pf.rows_combine_plain(u, *spectra, conj_spec),
            pf.rows_combine_plain(u.to(c128), *spectra, conj_spec, f64)):
        pfft_anchored(got, want32, want64)
    y = pf.pfft_cols_inv_cuda(*v, h)
    for got, want32, want64 in zip(
            y, pf.cols_inv_plain(*v, h),
            pf.cols_inv_plain(*(t.to(c128) for t in v), h, f64)):
        pfft_anchored(got, want32, want64)
    ref = pf.conv_packed_pfft_plain(x0.double(), x1.double(), *spectra, n,
                                    conj_spec, f64)
    scale = max(float(r.abs().max()) for r in ref)
    for got, want in zip(y, ref):
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale
    torch.cuda.synchronize()
    assert (pf.pfft_cols_fwd_cuda.launches, pf.pfft_rows_combine_cuda.launches,
            pf.pfft_cols_inv_cuda.launches) == (1, 1, 1)


def pfft_batch(device, p_, h, w, k, seed):
    from jolideco_torch.ops import pallas_fft as pf

    rs = np.random.RandomState(seed)
    x0, x1 = (torch.as_tensor(rs.randn(p_, h, w).astype(np.float32),
                              device=device) for _ in range(2))
    n = pf.pfft_size(max(h, w) + k - 1)
    planes = [pf.pfft_pair_spectra(rs.rand(k, k), rs.rand(k, k), (h, w), n)
              for _ in range(p_)]
    spectra = [torch.as_tensor(np.stack([q[j] for q in planes]),
                               device=device) for j in range(4)]
    return x0, x1, n, spectra


def split_anchored(got, plain32, plain64):
    """``chip_smoke.py``'s bar of the tensor-core kernels: at most twice
    the float32 ``"split"`` plain version's error against float64 plus
    1e-6 of the max-abs, and at most 1e-4 of the max-abs."""
    pfft_anchored(got, plain32, plain64)
    err = float((got.to(plain64.dtype) - plain64).abs().max())
    assert err <= 1e-4 * float(plain64.abs().max()), err


@pytest.mark.parametrize("conj_spec", [False, True])
@pytest.mark.parametrize("p_,h,w", [(2, 128, 128), (2, 256, 128),
                                    (5, 1024, 896)])
def test_pfft_tensor_core_kernels_match_float64(device, p_, h, w,
                                                conj_spec):
    """Passes 2 and 3 on the tensor cores (``"split"``) and the split
    pipeline, against the plain version in float64 on the same inputs;
    33² kernels, so n = 256, 384 and 1152 (m = 2, 3, 9)."""
    from jolideco_torch.ops import pallas_fft as pf

    x0, x1, n, spectra = pfft_batch(device, p_, h, w, 33, h + w)
    c128, f64 = torch.complex128, torch.float64
    pf.reset_counters()
    u = pf.pfft_cols_fwd_cuda(x0, x1, n)
    v = pf.pfft_rows_combine_tc_cuda(u, *spectra, conj_spec)
    for got, want32, want64 in zip(
            v, pf.rows_combine_plain(u, *spectra, conj_spec, mode="split"),
            pf.rows_combine_plain(u.to(c128), *spectra, conj_spec, f64)):
        split_anchored(got, want32, want64)
    y = pf.pfft_cols_inv_tc_cuda(*v, h)
    for got, want32, want64 in zip(
            y, pf.cols_inv_plain(*v, h, mode="split"),
            pf.cols_inv_plain(*(t.to(c128) for t in v), h, f64)):
        split_anchored(got, want32, want64)
    y = pf.pfft_conv_cuda(x0, x1, *spectra, n, conj_spec, "split")
    for got, want32, want64 in zip(
            y, pf.conv_packed_pfft_plain(x0, x1, *spectra, n, conj_spec,
                                         mode="split"),
            pf.conv_packed_pfft_plain(x0.double(), x1.double(), *spectra, n,
                                      conj_spec, f64)):
        split_anchored(got, want32, want64)
    torch.cuda.synchronize()
    assert (pf.pfft_rows_combine_tc_cuda.launches,
            pf.pfft_cols_inv_tc_cuda.launches,
            pf.pfft_rows_combine_cuda.launches,
            pf.pfft_cols_inv_cuda.launches) == (2, 2, 0, 0)


@pytest.mark.parametrize("conj_spec", [False, True])
@pytest.mark.parametrize("p_,h,w", [(2, 128, 128), (1, 384, 256),
                                    (5, 1024, 896), (1, 1152, 128)])
def test_pfft_tensor_core_pass1_matches_float64(device, p_, h, w, conj_spec):
    """Pass 1 on the tensor cores (``"split"``) against the split plain
    version and float64, beside the float32 kernel; 1152 rows exceed
    what a block keeps in shared memory (1024), so that image takes the
    kernel's variant that re-reads its columns per k2."""
    from jolideco_torch.ops import pallas_fft as pf

    x0, x1, n, spectra = pfft_batch(device, p_, h, w, 33, h + w + p_)
    f64 = torch.float64
    pf.reset_counters()
    u = pf.pfft_cols_fwd_tc_cuda(x0, x1, n)
    u64 = pf.cols_fwd_plain(x0.double(), x1.double(), n, f64)
    split_anchored(u, pf.cols_fwd_plain(x0, x1, n, mode="split"), u64)
    err32 = float((pf.pfft_cols_fwd_cuda(x0, x1, n).to(u64.dtype)
                   - u64).abs().max())
    err = float((u.to(u64.dtype) - u64).abs().max())
    assert err >= err32  # the mode is honoured: bf16 products
    y = pf.pfft_conv_cuda(x0, x1, *spectra, n, conj_spec, "split")
    for got, want32, want64 in zip(
            y, pf.conv_packed_pfft_plain(x0, x1, *spectra, n, conj_spec,
                                         mode="split"),
            pf.conv_packed_pfft_plain(x0.double(), x1.double(), *spectra, n,
                                      conj_spec, f64)):
        split_anchored(got, want32, want64)
    torch.cuda.synchronize()
    assert (pf.pfft_cols_fwd_tc_cuda.launches,
            pf.pfft_cols_fwd_cuda.launches) == (2, 1)


def test_pfft_split_adjoint_identity(device):
    """``<conv(x), g> = <x, conv_adj(g)>`` on the tensor-core pipeline,
    to split's error (3.1e-5 of the norms' product)."""
    from jolideco_torch.ops import pallas_fft as pf

    x0, x1, n, spectra = pfft_batch(device, 2, 256, 128, 33, 11)
    gen = torch.Generator(device=device).manual_seed(0)
    g = [torch.randn(x0.shape, generator=gen, device=device)
         for _ in range(2)]
    y = pf.pfft_conv_cuda(x0, x1, *spectra, n, False, "split")
    d = pf.pfft_conv_cuda(*g, *spectra, n, True, "split")
    lhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(y, g))
    rhs = sum(float((a.double() * b.double()).sum())
              for a, b in zip((x0, x1), d))
    norm = sum(float(a.double().norm() * b.double().norm())
               for a, b in zip(y, g))
    assert abs(lhs - rhs) <= 3.1e-5 * norm


@pytest.mark.parametrize("mode", ["split", "f32", "bf16"])
def test_pfft_launches_by_mode(device, mode):
    """``conv_packed_pfft`` forward and backward on the card: each mode's
    kernels once per pipeline, the other modes' never, no plain call."""
    from jolideco_torch.ops import pallas_fft as pf

    x0, x1, n, spectra = pfft_batch(device, 1, 128, 128, 9, 3)
    x0.requires_grad_(True)
    pf.reset_counters()
    y0, y1 = pf.conv_packed_pfft(x0, x1, *spectra, n, mode)
    (y0 * y1).sum().backward()
    torch.cuda.synchronize()
    launches = {m: tuple(fn.launches for fn in passes)
                for m, passes in pf.PASSES.items()}
    assert launches == {m: (2, 2, 2) if m == mode else (0, 0, 0)
                        for m in pf.PASSES}
    assert pf.conv_packed_pfft_plain.calls == 0


@pytest.mark.parametrize("conj_spec", [False, True])
@pytest.mark.parametrize("p_,h,w", [(2, 128, 128), (2, 256, 128)])
def test_pfft_bf16_kernels_match_float64(device, p_, h, w, conj_spec):
    """K3's three passes in ``"bf16"`` mode and their pipeline against
    the plain version in float64 on the same inputs
    (``chip_smoke.bf16_anchored``: within twice the bf16 plain version's
    error plus 1e-6 of the max-abs, and at least half of it; the pipeline
    within 1.3e-2 of the max-abs)."""
    from jolideco_torch.ops import pallas_fft as pf

    import chip_smoke

    x0, x1, n, spectra = pfft_batch(device, p_, h, w, 33, h + w)
    c128, f64 = torch.complex128, torch.float64
    u = pf.pfft_cols_fwd_bf16_cuda(x0, x1, n)
    chip_smoke.bf16_anchored("card test", "cols_fwd bf16", u,
                             pf.cols_fwd_plain(x0, x1, n, mode="bf16"),
                             pf.cols_fwd_plain(x0.double(), x1.double(), n,
                                               f64))
    v = pf.pfft_rows_combine_bf16_cuda(u, *spectra, conj_spec)
    for got, want32, want64 in zip(
            v, pf.rows_combine_plain(u, *spectra, conj_spec, mode="bf16"),
            pf.rows_combine_plain(u.to(c128), *spectra, conj_spec, f64)):
        chip_smoke.bf16_anchored("card test", "rows bf16", got, want32,
                                 want64)
    y = pf.pfft_cols_inv_bf16_cuda(*v, h)
    for got, want32, want64 in zip(
            y, pf.cols_inv_plain(*v, h, mode="bf16"),
            pf.cols_inv_plain(*(t.to(c128) for t in v), h, f64)):
        chip_smoke.bf16_anchored("card test", "cols_inv bf16", got, want32,
                                 want64)
    y = pf.pfft_conv_cuda(x0, x1, *spectra, n, conj_spec, "bf16")
    for got, want32, want64 in zip(
            y, pf.conv_packed_pfft_plain(x0, x1, *spectra, n, conj_spec,
                                         mode="bf16"),
            pf.conv_packed_pfft_plain(x0.double(), x1.double(), *spectra, n,
                                      conj_spec, f64)):
        chip_smoke.bf16_anchored("card test", "pipeline bf16", got, want32,
                                 want64, chip_smoke.PFFT_BF16_SHARE)


def test_pfft_path_on_card_matches_cpu(device):
    """``StackedPoissonLoss(conv_mode="pfft")`` at 3 × 100 × 72 (padded
    to 128², a pair and an odd tail), then the Hessian probe at 2 × 64²:
    card against CPU under the default dial (``"split"``: the plain
    version on the CPU computes what the tensor-core kernels compute),
    with K3's kernels launched once per pipeline."""
    from jolideco_torch import FluxComponents, MAPDeconvolver
    from jolideco_torch import SpatialFluxComponent, UniformPrior
    from jolideco_torch.ops import pallas_fft as pf
    from jolideco_torch.parallel.stacked import StackedPoissonLoss
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=3, size=100, psf_size=9, seed=5)
    for d in datasets.values():
        for key in ("counts", "exposure", "background"):
            d[key] = d[key][:, :72]
    flux = np.random.RandomState(6).uniform(0.5, 2.0, (100, 72))
    results = {}
    for dev in ("cpu", device):
        comps = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
            flux, device=dev)})
        loss = StackedPoissonLoss.from_datasets(datasets, comps,
                                                conv_mode="pfft", device=dev)
        f = comps.fluxes_from()[0].detach().requires_grad_(True)
        pf.reset_counters()
        values = loss.evaluate((f,))
        values.sum().backward()
        if dev != "cpu":
            assert pf.pfft_cols_fwd_tc_cuda.launches == 2
            assert pf.pfft_rows_combine_tc_cuda.launches == 2
            assert pf.conv_packed_pfft_plain.calls == 0
        results[str(dev)] = (values.detach().cpu(), f.grad.cpu())
    (v_cpu, g_cpu), (v_gpu, g_gpu) = results.values()
    torch.testing.assert_close(v_gpu, v_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-5 * float(g_cpu.abs().max()))

    datasets = make_datasets(n_obs=2, size=64, psf_size=9, seed=3)
    errors = {}
    for dev in ("cpu", device):
        comps = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
            np.random.RandomState(4).uniform(0.5, 2.0, (64, 64)),
            prior=UniformPrior())})
        deco = MAPDeconvolver(update_strategy="joint", trace_every=0,
                              device=dev, conv_mode="pfft")
        total = deco.build_loss(datasets, components=comps,
                                device=torch.device(dev))
        for comp in comps.values():
            comp.to(dev)
        pf.reset_counters()
        out = total.fluxes_error(comps.fluxes_from())
        errors[str(dev)] = out["flux"].cpu()
        if dev != "cpu":
            # the default dial's "split": the three passes on the tensor
            # cores
            assert pf.pfft_rows_combine_tc_cuda.launches == 4
            assert pf.pfft_cols_inv_tc_cuda.launches == 4
            assert pf.pfft_cols_fwd_tc_cuda.launches == 4
            assert pf.pfft_cols_fwd_cuda.launches == 0
            assert pf.pfft_rows_combine_cuda.launches == 0
    err_cpu, err_gpu = errors.values()
    assert torch.isfinite(err_cpu).all() and (err_cpu > 0).all()
    torch.testing.assert_close(err_gpu, err_cpu, rtol=1e-4, atol=0)


def _default_runs(dev, datasets, gmm, epochs, resume):
    """The default deconvolver (sequential, ``trace_every=1``, cycle
    spin) for ``epochs`` epochs, then ``resume`` more from its result."""
    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
    )

    size = next(iter(datasets.values()))["counts"].shape
    component = SpatialFluxComponent.from_numpy(
        np.ones(size, np.float32),
        prior=GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True))
    first = MAPDeconvolver(n_epochs=epochs, device=dev).run(
        datasets, components=component)
    second = MAPDeconvolver(n_epochs=resume, device=dev).run(
        datasets, components=first.components.copy(), resume_from=first)
    return first, second


def test_sequential_and_resumed_runs_on_card_match_cpu(device, gmm):
    """The default deconvolver at 3 × 64², 4 epochs and 2 resumed, card
    against CPU (the same cycle spins: the generator is the CPU's on
    both): every trace column to rtol 1e-4, the flux within 1e-3 of its
    max-abs (``chip_smoke.SEQ_FLUX_SHARE``: Adam's steps part the two
    paths' float32 rounding where a pixel's gradient nearly vanishes)."""
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=3, size=64, psf_size=9, seed=2)
    runs = {str(dev): _default_runs(dev, datasets, gmm, 4, 2)
            for dev in ("cpu", device)}
    (cpu_first, cpu_second), (card_first, card_second) = runs.values()
    for card, cpu in ((card_first, cpu_first), (card_second, cpu_second)):
        a, b = card.flux_upsampled_total, cpu.flux_upsampled_total
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
        assert card.trace_loss.colnames == cpu.trace_loss.colnames
        for name in cpu.trace_loss.colnames[:-1]:
            np.testing.assert_allclose(card.trace_loss[name],
                                       cpu.trace_loss[name], rtol=1e-4,
                                       err_msg=name)
    assert len(card_first.trace_loss) == 4
    assert len(card_second.trace_loss) == 2
    assert torch.equal(card_second.generator_state,
                       cpu_second.generator_state)


@pytest.mark.parametrize("n_obs", [1, 3])
def test_sequential_epoch_launches(device, gmm, n_obs):
    """One epoch of the default deconvolver: K1 split once per dataset
    step and once for the trace row, K2 once per step, nothing else."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.utils.bench_data import make_datasets

    datasets = make_datasets(n_obs=n_obs, size=96, psf_size=9, seed=1)
    _default_runs(device, datasets, gmm, 1, 0)   # builds, warms up
    gf.reset_counters()
    gp.reset_counters()
    _default_runs(device, datasets, gmm, 1, 0)
    torch.cuda.synchronize()
    assert gf.gmm_fused_fwd_tc_cuda.launches == n_obs + 1
    assert gf.gmm_fused_bwd_cuda.launches == n_obs
    assert (gf.gmm_fused_fwd_cuda.launches, gf.gmm_fused_fwd_bf16_cuda
            .launches, gp.gmm_score_rows_tc_cuda.launches) == (0, 0, 0)
    assert (gf.fused_forward_plain.calls, gf.fused_backward_plain.calls,
            gf.score_split_plain.calls) == (0, 0, 0)


def test_image_ops_on_card_match_cpu(device):
    """``upsample_bilinear`` and ``shift_image`` (value and both
    gradients) on the card against the CPU: 1e-6 of the max-abs (the same
    float32 coordinates and weights; interpolation and gathers need no
    sum), the shift's gradient rtol 1e-4: a sum over 77,100 pixels of
    terms of both signs, in another order on the card (1.3e-5 measured
    on an H100)."""
    from jolideco_torch.ops import image as ops

    rs = np.random.RandomState(3)
    x = rs.uniform(0.1, 1.0, (1, 1, 257, 300)).astype(np.float32)
    weights = rs.normal(size=x.shape).astype(np.float32)
    for factor in (2, 3):
        cpu = ops.upsample_bilinear(torch.as_tensor(x), factor)
        card = ops.upsample_bilinear(torch.as_tensor(x, device=device),
                                     factor).cpu()
        torch.testing.assert_close(card, cpu, rtol=0,
                                   atol=1e-6 * float(cpu.abs().max()))
    for shift in (0.0, 1.0, -0.37, 2.6):
        for scale in (1, 2):
            got = {}
            for dev in ("cpu", device):
                image = torch.tensor(x, device=dev, requires_grad=True)
                s = torch.tensor([[shift, -0.5 * shift]], device=dev,
                                 requires_grad=True)
                out = ops.shift_image(image, s, scale=scale)
                (out * torch.as_tensor(weights, device=dev)).sum().backward()
                got[str(dev)] = [t.cpu() for t in (out.detach(), image.grad,
                                                   s.grad)]
            cpu, card = got["cpu"], got[str(device)]
            for a, b in zip(card[:2], cpu[:2]):
                torch.testing.assert_close(a, b, rtol=0,
                                           atol=1e-6 * float(b.abs().max()))
            torch.testing.assert_close(card[2], cpu[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind", ["random", "estimate"])
def test_split_forward_and_backward_at_a_2048_flux(device, gmm, kind):
    """K1 split and K2 at the 262,144 patches of a 2048² flux (phase 9's
    upsampled main path) against their plain versions, by phase 2's
    bars: ``valid`` identical, the normalised patches to 1e-5, argmax
    flips on at most 1e-4 of the valid patches; K2 to 1e-4 of its
    max-abs, bitwise repeatable. On a random image the values to rtol
    7e-5 (``chip_smoke.K1_SPLIT_RTOL``); on the x2 start flux of the main
    path's data (``from_flux_init_datasets``), whose best logits are
    often much cancelled sums, their difference from the exact sum of
    the products within ``chip_smoke.K1_SPLIT_SUM_ERR_FLUX`` of the
    products' magnitudes (the mma's own sums: its comment)."""
    import chip_smoke
    from jolideco_torch import SpatialFluxComponent
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.utils.bench_data import make_datasets

    bufs = gmm.kernel_buffers(device)
    if kind == "random":
        img = make_image((2048, 2048))
    else:
        datasets = make_datasets(n_obs=10, size=1024, psf_size=33, seed=0)
        img = SpatialFluxComponent.from_flux_init_datasets(
            list(datasets.values()),
            upsampling_factor=2).flux_upsampled_numpy
    image = torch.as_tensor(img, device=device)
    vk, ak, valk, xk = gf.gmm_fused_fwd_tc_cuda(image, bufs, 4, SENTINEL)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, 4, SENTINEL,
                                              mode="split")
    torch.cuda.synchronize()
    assert vk.numel() == 512 * 512
    assert torch.equal(valk, valp)
    m = valp > 0.5
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    assert int((ak != ap)[m].sum()) <= 1e-4 * int(m.sum())
    if kind == "random":
        torch.testing.assert_close(vk[m], vp[m], rtol=7e-5, atol=0)
    else:
        exact, mag = chip_smoke.exact_split_values(torch, xp[m], bufs, ak[m])
        err = float(((vk[m].double() - exact).abs() / mag).max())
        assert err <= chip_smoke.K1_SPLIT_SUM_ERR_FLUX
    dv = torch.randn(vp.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(4))
    first, second = (gf.gmm_fused_bwd_cuda(xp, ap, valp, dv * valp, bufs,
                                           image.shape, 4) for _ in range(2))
    want = gf.fused_backward_plain(xp, ap, valp, dv * valp, bufs,
                                   image.shape, 4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_calibrated_upsampled_run_on_card_matches_cpu(device):
    """A x2 component and calibrations (the first one's shift frozen),
    joint, 10 epochs under cycle spin with the flux-error probe, at 4 x
    64² counts seen at known sub-pixel offsets, card against CPU: the
    flux within 1e-3 of its max-abs (``chip_smoke.SEQ_FLUX_SHARE``), the
    errors rtol 1e-4, the trained shifts and log norms within 1e-4
    (``chip_smoke.UPS_CAL_ATOL``); the frozen shift unmoved."""
    import chip_smoke
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_shifted_datasets

    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    datasets = make_shifted_datasets(size=64, psf_size=9, seed=1)
    runs = {str(dev): chip_smoke.upsampled_run(datasets, builtin, dev, 10,
                                               compute_error=True)
            for dev in ("cpu", device)}
    cpu, card = runs["cpu"], runs[str(device)]
    a, b = card.flux_upsampled_total, cpu.flux_upsampled_total
    assert a.shape == (128, 128)
    assert np.abs(a - b).max() <= chip_smoke.SEQ_FLUX_SHARE * np.abs(b).max()
    np.testing.assert_allclose(
        card.components["flux"].flux_upsampled_error_numpy,
        cpu.components["flux"].flux_upsampled_error_numpy, rtol=1e-4)
    for x, y in zip(chip_smoke.calibration_arrays(card),
                    chip_smoke.calibration_arrays(cpu)):
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=chip_smoke.UPS_CAL_ATOL)
    assert torch.equal(card.calibrations["obs-0"].shift_xy.cpu(),
                       torch.zeros(1, 2))


@pytest.mark.parametrize("kind,marginalize,kernels", [
    ("jitter", False, {"gmm_score_rows_tc": 1, "gmm_unit_map": 1}),
    ("fraction", False, {"gmm_score_rows_tc": 1, "gmm_unit_map": 1}),
    ("group", True, {"gmm_score_rows_marg_tc": 1, "gmm_unit_marg_tc": 1}),
])
def test_grouped_training_step_on_card_matches_cpu(device, gmm, kind,
                                                   marginalize, kernels):
    """One training step's prior value and flux gradient on the
    patch-level branch, card (K5 split, then K6, or K5 lse split, then K8
    split, under the default dial) against CPU (the split plain
    versions), the same draws on both: value rtol 7e-5 (K5 split's bar,
    ``chip_smoke.K1_SPLIT_RTOL``), gradient 1e-4 of its max-abs (under
    jitter the card's gather adds overlapping corners with atomics)."""
    import chip_smoke
    from jolideco_torch.utils.profile_step import make_prior

    prior = make_prior(kind, gmm, marginalize=marginalize)
    flux = np.random.RandomState(2).uniform(0.1, 2.0, (1, 1, 96, 160))
    draws = prior.draw_shifts(torch.Generator().manual_seed(3), flux.shape)
    results = {}
    for dev in ("cpu", device):
        x = torch.as_tensor(flux.astype(np.float32), device=dev)
        x.requires_grad_(True)
        chip_smoke.reset_counts()
        value = prior(x, shifts=draws)
        value.backward()
        results[str(dev)] = (value.item(), x.grad.cpu())
    launches, plain_calls = chip_smoke.counts()
    assert launches == chip_smoke.expect(**kernels) and plain_calls == 0
    (v_cpu, g_cpu), (v_gpu, g_gpu) = results.values()
    np.testing.assert_allclose(v_gpu, v_cpu, rtol=chip_smoke.K1_SPLIT_RTOL)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-4 * float(g_cpu.abs().max()))


def test_multiscale_prior_launches_the_fused_kernels_per_level(device, gmm):
    """``MultiScalePrior`` over three levels: K1 split and K2 once a level
    (96 x 160, 48 x 80, 24 x 40), value and gradients (flux, level
    weights, the asinh norm's alpha and beta) card against CPU, value
    rtol 7e-5, gradients 1e-4 of their max-abs."""
    import chip_smoke
    from jolideco_torch.utils.profile_step import make_prior

    prior = make_prior("multiscale", gmm)
    flux = np.random.RandomState(4).uniform(0.1, 2.0, (1, 1, 96, 160))
    draws = prior.draw_shifts(torch.Generator().manual_seed(5), flux.shape)
    results = {}
    for dev in ("cpu", device):
        x = torch.as_tensor(flux.astype(np.float32), device=dev)
        x.requires_grad_(True)
        def leaf(value, dev=dev):
            return value.detach().clone().to(dev).requires_grad_(True)

        params = {"log_weights": leaf(prior.parameters()["log_weights"]),
                  "prior": {"norm": {
                      k: leaf(v) for k, v in
                      prior.parameters()["prior"]["norm"].items()}}}
        chip_smoke.reset_counts()
        value = prior(x, params=params, shifts=draws)
        value.backward()
        leaves = [params["log_weights"]] + list(
            params["prior"]["norm"].values())
        results[str(dev)] = (value.item(), [x.grad.cpu()] + [
            leaf.grad.cpu() for leaf in leaves])
    launches, plain_calls = chip_smoke.counts()
    assert launches == chip_smoke.expect(gmm_fused_fwd_tc=3,
                                         gmm_fused_bwd=3)
    assert plain_calls == 0
    (v_cpu, g_cpu), (v_gpu, g_gpu) = results.values()
    np.testing.assert_allclose(v_gpu, v_cpu, rtol=chip_smoke.K1_SPLIT_RTOL)
    for got, want in zip(g_gpu, g_cpu):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_every_prior_holds_its_tensors_on_the_flux_device(device):
    """After ``SpatialFluxComponent.to`` and an evaluation on the card,
    every tensor a prior holds (kernels, their spectra, images, tables,
    level weights, its norm's and its GMM's buffers) lies on the card:
    no constant stays on the host to be copied each step."""
    import chip_smoke
    import jolideco_torch as jt
    from jolideco_torch.utils.profile_step import make_prior

    # a GMM of its own: the module's has CPU buffers from other tests
    gmm = jt.GaussianMixtureModel.from_registry("astro-snr-v1")
    table = np.linspace(0.0, 3.0, 20)
    priors = {
        "multiscale": make_prior("multiscale", gmm),
        "inverse-cdf": jt.GMMPatchPrior(
            gmm=gmm, norm=jt.InverseCDFImageNorm(table, table / 3.0)),
        "fixed-max": jt.GMMPatchPrior(gmm=gmm,
                                      norm=jt.FixedMaxImageNorm(3.0,
                                                                frozen=True)),
        "smooth": jt.SmoothnessPrior(width=2),
        "image": jt.ImagePrior(np.ones((1, 1, 64, 64), np.float32)),
        "lira": jt.LIRAPrior((2.0, 2.0)),
        "inverse-gamma": jt.InverseGammaPrior(cycle_spin_subpix=True),
        "exponential": jt.ExponentialPrior(),
    }
    for name, prior in priors.items():
        component = jt.SpatialFluxComponent.from_numpy(
            np.ones((64, 64), np.float32), prior=prior).to(device)
        value = prior(component.flux_upsampled)
        assert value.device == device and bool(torch.isfinite(value)), name
        tensors = chip_smoke.device_tensors(prior)
        assert all(t.device == device for t in tensors), name


@pytest.mark.parametrize("marginalize", [False, True])
@pytest.mark.parametrize("shape", [(72, 136), (61, 45)])
def test_strip_block_partial_sums_on_the_card(device, gmm, shape,
                                              marginalize):
    """``gmm_score_fused_partial_sum`` over 2, 4 and 3 shards, each a
    launch of K1 split and of K2 (K4 split, marginalised) on its strip
    block, against one whole-image call: the summed values rtol 1e-6 and
    the image gradient 1e-6 of its max-abs (the same patches, summed in
    another order); no plain version runs."""
    from jolideco_torch.ops import gmm_fused as gf

    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    x = image.clone().requires_grad_(True)
    values, _, valid = gf.gmm_score_fused_image(
        x, (8, 8), 4, bufs, SENTINEL, marginalize=marginalize, mode="split")
    whole = torch.where(valid, values, torch.zeros_like(values)).sum()
    whole.backward()
    backward = (gf.gmm_fused_bwd_marg_tc_cuda if marginalize
                else gf.gmm_fused_bwd_cuda)
    forward = (gf.gmm_fused_fwd_marg_tc_cuda if marginalize
               else gf.gmm_fused_fwd_tc_cuda)
    for n_shards in (2, 4, 3):
        gf.reset_counters()
        xs = image.clone().requires_grad_(True)
        total = sum(gf.gmm_score_fused_partial_sum(
            xs, (8, 8), 4, bufs, SENTINEL, n_shards, index,
            marginalize=marginalize, mode="split")
            for index in range(n_shards))
        total.backward()
        torch.cuda.synchronize()
        assert forward.launches == n_shards
        assert backward.launches == n_shards
        assert gf.fused_forward_plain.calls == 0
        torch.testing.assert_close(total, whole, rtol=1e-6, atol=0)
        torch.testing.assert_close(xs.grad, x.grad, rtol=0,
                                   atol=1e-6 * float(x.grad.abs().max()))
