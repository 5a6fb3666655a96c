"""The patch-level GMM scorer's ``"split"`` mode against the JAX package.

Under its default dial the JAX package's grouped scorer runs
``gmm_score_pallas`` at ``precision=HIGH`` (its ``"split3"`` logits: the
pair products ``x_a x_b`` and ``A`` each split into bf16 hi and lo
parts, three products hi.hi + hi.lo + lo.hi summed in float32). The
JAX side runs that kernel in the Pallas interpreter on the CPU; the port
runs the split plain versions (``score_split_plain``,
``score_split_marg_plain``: a CPU tensor), the reference of the card's
K5 split kernels (``csrc/gmm_score_wg.cu``'s MAP and logsumexp
instances), which form the same bf16 products from the symmetric pair
layout and sum them in another order. Rows: the masked, mean-subtracted
patches of a random image (the probe's rows), a few of them zero
(masked patches); GMMs: the two of the registry and
``chip_smoke.wide_gmm``, 256 components, two of the kernel's tiles of
200. Tolerances:

- values, the maximum and the logsumexp: rtol 1e-5 (float32 sums of the
  same products in other orders; the split itself lies about 1e-5 from
  float64, the same in both);
- argmax: identical on these rows;
- ``MAPDeconvolver(compute_error=True)`` under the default dial against
  the JAX package's probe at HIGH (its Pallas kernels in the
  interpreter) at the flux its own run reached: rtol 1e-4, the bar of
  ``tests/test_torch_errors.py`` (the flux maps agree to rtol 1e-4).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax.numpy as jnp
from jax import lax

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch import config
from jolideco_torch.config import force_fused
from jolideco_torch.ops import gmm_fused as tf
from jolideco_torch.ops import gmm_pallas as tp
from jolideco_torch.utils.interop import gmm_from_arrays
from jolideco_tpu.config import force_pallas as j_force_pallas
from jolideco_tpu.ops.gmm_pallas import gmm_score_pallas
from test_torch_slice import (  # noqa: E402  (tests/ is on sys.path)
    jax_setup,
    make_datasets,
    torch_setup,
)

torch.set_num_threads(1)
GMM_NAMES = ["builtin-8x8-v1", "astro-snr-v1", "wide-256"]
STRIDE = 4


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


@pytest.fixture(scope="module")
def rows():
    """The probe's rows of a random 48 x 64 image: the 192 grouped
    patches, mean-subtracted; rows 0 and 97 zeroed as masked patches."""
    from jolideco_torch.ops.patches import (
        view_as_overlapping_patches_grouped,
    )

    img = np.random.RandomState(3).uniform(0.1, 2.0, (48, 64))
    patches = view_as_overlapping_patches_grouped(
        torch.as_tensor(img, dtype=torch.float32), (8, 8), STRIDE)
    x = patches - patches.mean(dim=1, keepdim=True)
    x[::97] = 0.0
    return x.contiguous().numpy()


def jax_scores(gmm_j, rows, marginalize):
    values, argmax = gmm_score_pallas(
        jnp.asarray(rows), gmm_j.packed, gmm_j.means_precisions_cholesky,
        gmm_j.precisions_cholesky, gmm_j.pixel_weights, True,
        lax.Precision.HIGH, marginalize)
    return np.asarray(values), np.asarray(argmax)


@pytest.mark.parametrize("marginalize", [False, True])
def test_split_plain_matches_jax_high(gmms, rows, marginalize):
    gmm_j, gmm_t = gmms
    bufs = gmm_t.kernel_buffers("cpu")
    v_j, a_j = jax_scores(gmm_j, rows, marginalize)
    score = tf.score_split_marg_plain if marginalize else tf.score_split_plain
    v_t, a_t = score(torch.as_tensor(rows), bufs)
    assert v_t.shape == (len(rows),) and a_t.dtype == torch.int32
    assert_allclose(v_t.numpy(), v_j, rtol=1e-5)
    assert_array_equal(a_t.numpy(), a_j)
    if gmm_t.n_components > tf.KP_WG:
        # both of the kernel's tiles hold winning components
        assert 0 < int((a_t >= tf.KP_WG).sum()) < len(rows)


@pytest.mark.parametrize("marginalize", [False, True])
@pytest.mark.parametrize("mode", tf.MODES)
def test_gmm_score_patches_dispatches_by_mode(rows, mode, marginalize):
    """On the CPU the scorers of ``"split"`` and ``"bf16"``, MAP and
    marginalise, are those modes' plain versions; those of ``"f32"`` the
    float32 one. Each way the values are that plain version's own."""
    bufs = jt.GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers("cpu")
    x = torch.as_tensor(rows)
    tp.reset_counters()
    tf.reset_counters()
    values, argmax = tp.gmm_score_patches(x, bufs, marginalize, mode)
    calls = {m: tf.PLAIN_SCORES[m, marginalize].calls
             for m in ("split", "bf16")}
    calls["f32"] = tp.score_rows_plain.calls
    assert calls == {m: int(m == mode) for m in tf.MODES}
    assert sum(fn.calls for fn in tf.PLAIN_SCORES.values()) == int(
        mode != "f32")
    want = (tp.score_rows_plain(x, bufs, marginalize) if mode == "f32"
            else tf.PLAIN_SCORES[mode, marginalize](x, bufs))
    assert torch.equal(values, want[0]) and torch.equal(argmax, want[1])
    with pytest.raises(ValueError, match="mode"):
        tp.gmm_score_patches(x, bufs, marginalize, "bf8")


@pytest.mark.parametrize("dial,mode", [("high", "split"), ("default", "bf16"),
                                       ("highest", "f32")])
def test_prior_probe_scorer_follows_the_dial(dial, mode):
    """The patch prior's grouped branch (the probe's) scores by the dial's
    mode: ``"high"`` the split plain versions, ``"default"`` the
    single-bf16 ones, ``"highest"`` the float32 one, MAP and marginalised
    alike; the marginalised gradient's softmax takes the same logits."""
    flux = torch.as_tensor(np.random.RandomState(4).uniform(
        0.5, 2.0, (1, 1, 48, 64)).astype(np.float32)).requires_grad_(True)
    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    try:
        config.set_gmm_precision(dial)
        for marginalize in (False, True):
            prior = jt.GMMPatchPrior(gmm=gmm, stride=STRIDE, cycle_spin=False,
                                     marginalize=marginalize)
            tp.reset_counters()
            tf.reset_counters()
            with force_fused("off"):
                (grad,) = torch.autograd.grad(prior(flux), flux)
            for m in ("split", "bf16"):
                assert tf.PLAIN_SCORES[m, marginalize].calls == int(m == mode)
                assert tf.PLAIN_SCORES[m, not marginalize].calls == 0
                assert tf.PLAIN_UNITS[m].calls == int(
                    marginalize and m == mode)
            assert tp.score_rows_plain.calls == int(mode == "f32")
            if marginalize:
                assert tp.unit_marg_plain.calls == int(mode == "f32")
            assert tf.fused_forward_plain.calls == 0
            assert torch.isfinite(grad).all()
    finally:
        config.set_gmm_precision("high")


def test_split_mode_scores_other_patch_sizes_in_float32():
    """A GMM of 4x4 patches has no ``"split"`` buffers; its scorer takes
    float32 in either mode."""
    rs = np.random.RandomState(2)
    covariances = np.stack([a @ a.T / 16 + 0.1 * np.eye(16)
                            for a in rs.randn(3, 16, 16)])
    gmm4 = gmm_from_arrays(rs.randn(3, 16), covariances, np.ones(3) / 3, 2)
    bufs = gmm4.kernel_buffers("cpu")
    assert "pair_hi" not in bufs
    x = torch.as_tensor(rs.randn(10, 16).astype(np.float32))
    tp.reset_counters()
    tf.reset_counters()
    v_split, a_split = tp.gmm_score_patches(x, bufs, mode="split")
    v_f32, a_f32 = tp.gmm_score_patches(x, bufs, mode="f32")
    assert (tp.score_rows_plain.calls, tf.score_split_plain.calls) == (2, 0)
    assert torch.equal(v_split, v_f32) and torch.equal(a_split, a_f32)


def test_map_deconvolver_errors_match_jax_high():
    """``MAPDeconvolver(compute_error=True)`` under the default dial (the
    probe on the split plain scorer) against the JAX package's probe at
    HIGH: its deconvolver trained by its default CPU dispatch, then
    ``fluxes_error`` at the flux it reached, with its Pallas kernels in
    the interpreter (the fused scorer off, as its probe runs it)."""
    datasets = make_datasets(2)
    gmm_j, comp_j, deco_j = jax_setup(datasets)
    comp_t, deco_t = torch_setup(gmm_j)
    deco_t.compute_error = True

    result_j = deco_j.run(datasets, components=comp_j)
    flux_j = result_j.components["flux"].flux_upsampled_numpy
    total_j = deco_j.build_loss(datasets, components=comp_j)
    with j_force_pallas("interpret"):
        errors_j = np.asarray(total_j.fluxes_error(
            (jnp.asarray(flux_j[None, None]),))["flux"]).reshape(
                flux_j.shape)

    tf.reset_counters()
    tp.reset_counters()
    result_t = deco_t.run(datasets, components=comp_t)
    # 20 training steps on the fused split plain version, then the probe's
    # MAP scorer, also split; no float32 scorer
    assert tf.score_split_plain.calls == deco_t.n_epochs + 1
    assert tp.score_rows_plain.calls == 0 and tf.score_plain.calls == 0
    assert (tp.unit_map_plain.calls, tp.hvp_map_plain.calls) == (1, 1)
    errors_t = result_t.components["flux"].flux_upsampled_error_numpy
    assert errors_t.shape == errors_j.shape == (128, 128)
    assert np.isfinite(errors_t).all() and (errors_t > 0).all()
    assert_allclose(errors_t, errors_j, rtol=1e-4)


def test_tensor_core_row_scorer_refuses_cpu_tensors(rows):
    """K5 split's wrappers (MAP and logsumexp) launch on a card or raise:
    a CPU tensor takes the split plain versions only through the
    dispatch."""
    bufs = jt.GaussianMixtureModel.from_registry(
        "astro-snr-v1").kernel_buffers("cpu")
    for wrapper in (tp.gmm_score_rows_tc_cuda, tp.gmm_score_rows_marg_tc_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(torch.as_tensor(rows), bufs)
