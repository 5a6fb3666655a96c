"""The port's public signatures and names against the JAX package's.

Every keyword that the JAX package's deconvolver, its ``run``, the flux
component, the GMM patch prior and the stacked loss accept is accepted
by the port (``inspect.signature``), every option is ported (the conv
modes: ``tests/test_torch_conv_modes.py``), the harmless ones are
honoured, and the ported options raise the JAX package's errors where it
does. Every name in the ``__all__`` of a JAX module is found in the
port's module of the same path, but for the few kept elsewhere or under
their own name and those that exist only for JAX, each listed with its
reason in :data:`ELSEWHERE` and :data:`JAX_ONLY`. The names of the
reference's external GMM library resolve to the shipped ``astro-snr-v1``
with the JAX package's warning.
"""

import importlib
import inspect
import pkgutil
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jolideco_torch as jt
import jolideco_torch.utils.norms as tn
import jolideco_tpu as jj
import jolideco_tpu.utils.norms as jn
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_torch.priors.patches.gmm import REFERENCE_LIBRARY_ALIASES
from jolideco_tpu.ops.dist_fft import spatial_fft_shape
from jolideco_tpu.parallel.stacked import StackedPoissonLoss as JStacked

torch.set_num_threads(1)

CALLABLES = {
    "MAPDeconvolver": (jj.MAPDeconvolver.__init__, jt.MAPDeconvolver.__init__),
    "MAPDeconvolver.run": (jj.MAPDeconvolver.run, jt.MAPDeconvolver.run),
    "SpatialFluxComponent": (jj.SpatialFluxComponent.__init__,
                             jt.SpatialFluxComponent.__init__),
    "GMMPatchPrior": (jj.GMMPatchPrior.__init__, jt.GMMPatchPrior.__init__),
    "StackedPoissonLoss.from_datasets": (JStacked.from_datasets,
                                         TStacked.from_datasets),
    "FluxComponents": (jj.FluxComponents.__init__,
                       jt.FluxComponents.__init__),
}
# the priors and norms of the prior layer
CALLABLES.update({
    name: (getattr(jj, name).__init__, getattr(jt, name).__init__)
    for name in ("MultiScalePrior", "LIRAPrior", "SmoothnessPrior",
                 "InverseGammaPrior", "ExponentialPrior", "ImagePrior",
                 "UniformPrior")
})
CALLABLES.update({
    name: (getattr(jn, name).__init__, getattr(tn, name).__init__)
    for name in ("IdentityImageNorm", "MaxImageNorm", "FixedMaxImageNorm",
                 "SigmoidImageNorm", "ATanImageNorm", "InverseCDFImageNorm",
                 "ASinhImageNorm", "LogImageNorm", "PowerImageNorm")
})
CALLABLES["InverseCDFImageNorm.from_image"] = (
    jn.InverseCDFImageNorm.from_image, tn.InverseCDFImageNorm.from_image)


def _params(fn):
    return inspect.signature(fn).parameters


# (JAX module, name) -> (port module, name) of a name the port keeps
# elsewhere or under its own name
ELSEWHERE = {
    ("jolideco_tpu.ops.gmm_pallas", "pack_gmm_buffers"):
        ("jolideco_torch.ops.gmm_pack", "pack_gmm_buffers"),
    ("jolideco_tpu.ops.gmm_pallas", "gmm_score_pallas"):
        ("jolideco_torch.ops.gmm_pallas", "gmm_score_rows_cuda"),
}
# (JAX module, name) -> why the port has no counterpart
_PALLAS = ("the Pallas dispatch switch: the port routes each kernel by its "
           "tensor's device (config.dispatch), a CUDA kernel on the card and "
           "its plain version on the CPU")
JAX_ONLY = {
    ("jolideco_tpu.utils.pytree", "register_pytree"):
        "registers a class as a JAX pytree; torch modules hold plain "
        "tensors",
    ("jolideco_tpu.config", "enable_persistent_cache"):
        "XLA's compilation cache; the port compiles nothing per shape (its "
        "CUDA libraries are built once, keyed by their sources)",
    ("jolideco_tpu.config", "set_use_pallas"): _PALLAS,
    ("jolideco_tpu.config", "use_pallas"): _PALLAS,
    ("jolideco_tpu.config", "force_pallas"): _PALLAS,
    ("jolideco_tpu.config", "pallas_mode"): _PALLAS,
    ("jolideco_tpu.ops.gmm_pallas", "pallas_supported"):
        "whether a GMM fits the Pallas kernels' tiles; the port's kernels "
        "take any K, and other patch sizes take the plain scorer "
        "(ops.gmm_pallas.route)",
    ("jolideco_tpu.ops.gmm_pallas", "TILE_N"):
        "the Pallas kernels' row tile; the CUDA kernels' tiles are their "
        "own (csrc/)",
}


def _jax_modules_with_all():
    for info in pkgutil.walk_packages(jj.__path__, "jolideco_tpu."):
        module = importlib.import_module(info.name)
        if hasattr(module, "__all__"):
            yield info.name, module


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    missing, used = [], set()
    for name, module in _jax_modules_with_all():
        for attr in module.__all__:
            key = (name, attr)
            if key in JAX_ONLY:
                used.add(key)
                continue
            port_module, port_attr = ELSEWHERE.get(key, (
                name.replace("jolideco_tpu", "jolideco_torch", 1), attr))
            used.add(key)
            try:
                found = hasattr(importlib.import_module(port_module),
                                port_attr)
            except ImportError:
                found = False
            if not found:
                missing.append(f"{name}.{attr} -> {port_module}.{port_attr}")
    assert not missing, missing
    # every exemption names a JAX public name that exists
    assert set(ELSEWHERE) | set(JAX_ONLY) <= used
    assert all(reason for reason in JAX_ONLY.values())
    # the ops package re-exports the JAX package's ops
    import jolideco_torch.ops as t_ops
    import jolideco_tpu.ops as j_ops

    for attr in vars(j_ops):
        if not attr.startswith("_") and callable(getattr(j_ops, attr)):
            assert hasattr(t_ops, attr), attr


@pytest.mark.parametrize("name", list(CALLABLES))
def test_port_accepts_every_jax_keyword_with_its_default(name):
    jax_fn, port_fn = CALLABLES[name]
    jax_params, port_params = _params(jax_fn), _params(port_fn)
    missing = [p for p in jax_params if p not in port_params]
    assert not missing, f"{name} lacks {missing}"
    # the JAX package's parameters come first, in its order, so that a
    # positional call means the same in both
    assert list(port_params)[:len(jax_params)] == list(jax_params)
    for p, spec in jax_params.items():
        if spec.default is not inspect.Parameter.empty:
            assert port_params[p].default == spec.default, (name, p)


def _datasets():
    ones = np.ones((16, 16), np.float32)
    return {"obs": {"counts": ones, "psf": np.ones((3, 3)) / 9,
                    "exposure": ones, "background": ones}}


@pytest.mark.parametrize("kwargs", [
    {"mesh": SimpleNamespace(mesh_dim_names=("obs",), shape=(4,))},
    {"stop_early": True},
    {"checkpoint_path": "checkpoints"},
], ids=lambda kw: next(iter(kw)))
def test_deconvolver_raises_on_unported_options(kwargs, tmp_path, caplog):
    """``mesh`` is ported: the deconvolver takes it, its configuration
    records the topology as the JAX package writes it, and with the
    default sequential strategy it logs the JAX package's warning (the
    meshes themselves: ``tests/test_torch_mesh.py``).
    ``stop_early`` is ported: the deconvolver takes it, and its ``run``
    without validation data raises the JAX package's ``ValueError``.
    ``checkpoint_path`` is ported: the directory is made, the
    configuration records it, and each epoch writes the JAX package's
    file name."""
    if "mesh" in kwargs:
        with caplog.at_level(logging.WARNING, logger="jolideco_torch.core"):
            deco = jt.MAPDeconvolver(**kwargs)
        assert deco.to_dict()["mesh"] == "obs:4"
        assert "runs unsharded" in caplog.text
        return
    component = jt.SpatialFluxComponent.from_numpy(np.ones((16, 16)))
    if "checkpoint_path" in kwargs:
        path = tmp_path / kwargs["checkpoint_path"]
        deco = jt.MAPDeconvolver(n_epochs=2, device="cpu",
                                 checkpoint_path=path)
        assert deco.to_dict()["checkpoint_path"] == str(path)
        result = deco.run(_datasets(), components=component)
        names = [jj.MAPDeconvolver._default_checkpoint_filename.format(
            epoch=epoch) for epoch in range(2)]
        assert sorted(p.name for p in path.iterdir()) == names
        assert list(result.trace_loss["filename"]) == names
        return
    deco = jt.MAPDeconvolver(n_epochs=1, device="cpu", **kwargs)
    assert deco.to_dict()["stop_early"] is True
    with pytest.raises(ValueError, match="requires providing test datasets"):
        deco.run(_datasets(), components=component)


def _run_option_raises(keyword, tmp_path):
    """What ``run(<keyword>=...)`` does: the four are ported and raise the
    JAX package's errors on what they cannot use; ``calibrations`` train
    beside the flux as in the JAX package (rtol 1e-5 after one step:
    float32 FFTs)."""
    deco = jt.MAPDeconvolver(n_epochs=1, device="cpu")
    component = jt.SpatialFluxComponent.from_numpy(np.ones((16, 16)))
    if keyword == "calibrations":
        rs = np.random.RandomState(0)
        datasets = _datasets()
        datasets["obs"]["counts"] = rs.poisson(
            3.0, (16, 16)).astype(np.float32)
        cals_t = jt.NPredCalibrations(
            {"obs": jt.NPredCalibration(background_norm=0.8)})
        cals_j = jj.NPredCalibrations(
            {"obs": jj.NPredCalibration(background_norm=0.8)})
        result_t = deco.run(datasets, components=component,
                            calibrations=cals_t)
        result_j = jj.MAPDeconvolver(n_epochs=1, display_progress=False).run(
            datasets, components=jj.SpatialFluxComponent.from_numpy(
                np.ones((16, 16))), calibrations=cals_j)
        np.testing.assert_allclose(
            result_t.components["flux"].flux_upsampled_numpy,
            result_j.components["flux"].flux_upsampled_numpy, rtol=1e-5)
        for name in ("shift_xy", "_background_norm"):
            np.testing.assert_allclose(
                getattr(result_t.calibrations["obs"], name).numpy(),
                np.asarray(getattr(result_j.calibrations["obs"], name)),
                rtol=1e-5, atol=1e-7)
        assert result_t.calibrations_init.to_dict() == \
            jt.NPredCalibrations(
                {"obs": jt.NPredCalibration(background_norm=0.8)}).to_dict()
    elif keyword == "datasets_validation":
        # early stopping needs validation data; with it, the trace
        # carries its total
        deco.stop_early = True
        with pytest.raises(ValueError, match="test datasets"):
            deco.run(_datasets(), components=component)
        result = deco.run(_datasets(), components=component,
                          datasets_validation=_datasets())
        assert result.trace_loss.colnames[-2:] == [
            "datasets-validation-total", "filename"]
    elif keyword == "resume_from":
        with pytest.raises(FileNotFoundError):
            deco.run(_datasets(), components=component,
                     resume_from=tmp_path / "no-state")
    else:
        loss = deco.build_loss(_datasets(), components=component)
        deco.stop_early = True
        with pytest.raises(ValueError, match="built without them"):
            deco.run(_datasets(), components=component,
                     datasets_validation=_datasets(), total_loss=loss)


@pytest.mark.parametrize("keyword", ["datasets_validation", "calibrations",
                                     "resume_from", "total_loss"])
def test_run_raises_on_unported_options(keyword, tmp_path):
    _run_option_raises(keyword, tmp_path)
    deco = jt.MAPDeconvolver(n_epochs=1, device="cpu")
    with pytest.raises(ValueError, match="components"):
        deco.run(_datasets())


def test_harmless_keywords_are_honoured(caplog):
    deco = jt.MAPDeconvolver(
        n_epochs=2, update_strategy="joint", trace_every=0, device="cpu",
        stop_early_n_average=5, display_progress=True, scan_epochs=True,
        scan_chunk=4, shard_prior=False)
    config = deco.to_dict()
    assert config["stop_early_n_average"] == 5
    assert config["scan_epochs"] is True and config["scan_chunk"] == 4
    assert config["shard_prior"] is False and config["mesh"] is None
    wcs = {"CTYPE1": "RA---TAN"}
    error = np.full((1, 1, 16, 16), 0.5, np.float32)
    component = jt.SpatialFluxComponent(np.ones((1, 1, 16, 16)),
                                        flux_upsampled_error=error, wcs=wcs)
    assert component.wcs is wcs
    np.testing.assert_array_equal(component.flux_upsampled_error_numpy,
                                  error[0, 0])
    with caplog.at_level(logging.INFO, logger="jolideco_torch.core"):
        result = deco.run(_datasets(), components=component)
    assert "2 steps" in caplog.text
    assert result.loss_per_step.shape == (2,)
    quiet = jt.MAPDeconvolver(n_epochs=1, update_strategy="joint",
                              trace_every=0, device="cpu",
                              display_progress=False)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="jolideco_torch.core"):
        quiet.run(_datasets(), components=jt.SpatialFluxComponent.from_numpy(
            np.ones((16, 16))))
    assert "steps in" not in caplog.text


def test_prior_and_loss_raise_on_unported_options():
    from jolideco_torch.utils.norms import SubtractMeanPatchNorm

    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    prior = jt.GMMPatchPrior(gmm=gmm, patch_norm=SubtractMeanPatchNorm())
    assert type(prior.patch_norm) is SubtractMeanPatchNorm
    comps = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(
        np.ones((16, 16)))})
    # row_shards is ported: the FFT width grows until its half-spectrum
    # divides over the row shards, as the JAX package's does
    loss = TStacked.from_datasets(_datasets(), comps, row_shards=4,
                                  device="cpu")
    assert loss.fft_shape == spatial_fft_shape((16, 16), (3, 3), 4)


@pytest.mark.parametrize("alias", REFERENCE_LIBRARY_ALIASES)
def test_reference_library_aliases_give_astro_snr(alias, caplog):
    assert set(REFERENCE_LIBRARY_ALIASES) == set(
        jj.priors.patches.gmm.REFERENCE_LIBRARY_ALIASES)
    with caplog.at_level(logging.WARNING):
        got = jt.GaussianMixtureModel.from_registry(alias)
    assert "substituting the shipped 'astro-snr-v1'" in caplog.text
    astro = jt.GaussianMixtureModel.from_registry("astro-snr-v1")
    jax_gmm = jj.GaussianMixtureModel.from_registry(alias)
    for field in ("means", "covariances", "weights"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(astro, field))
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(jax_gmm, field)))
    assert got.meta.stride == astro.meta.stride


def test_default_prior_gmm_is_the_alias(caplog):
    with caplog.at_level(logging.WARNING):
        prior = jt.GMMPatchPrior()
    assert "'zoran-weiss'" in caplog.text
    astro = jt.GaussianMixtureModel.from_registry("astro-snr-v1")
    np.testing.assert_array_equal(prior.gmm.means, astro.means)
    np.testing.assert_array_equal(
        prior.gmm.means, np.asarray(jj.GMMPatchPrior().gmm.means))


def test_flux_components_take_the_jax_signature():
    """``FluxComponents(components=...)`` keys its entries by the dict's
    names, as the JAX package's does; its priors are a ``Priors``."""
    comp = jt.SpatialFluxComponent.from_numpy(np.ones((16, 16)))
    for comps in (jt.FluxComponents(components={"flux": comp}),
                  jt.FluxComponents({"flux": comp})):
        assert list(comps) == ["flux"] and comps["flux"] is comp
        assert isinstance(comps.priors, jt.Priors)
        assert list(comps.priors) == ["flux"]
    assert len(jt.FluxComponents()) == 0


def test_public_names_of_the_jax_package_exist():
    for name in jj.__dict__:
        if not name.startswith("_") and name[0].isupper():
            assert hasattr(jt, name), name
    sparse = jt.SparseSpatialFluxComponent([1.0], [2.0], [3.0], (4, 5))
    assert sparse.shape == (1, 1, 4, 5)
    assert jt.SparseSpatialFluxComponent.is_sparse is True
    assert jt.parallel.DataValidationError is \
        jt.parallel.stacked.DataValidationError
    assert set(jt.priors.PRIOR_REGISTRY) == set(jj.priors.PRIOR_REGISTRY)

    wcs = {"CTYPE1": "RA---TAN"}
    flux = np.arange(1.0, 17.0, dtype=np.float32).reshape(4, 4)
    comp_t = jt.SpatialFluxComponent.from_numpy(flux, upsampling_factor=2,
                                                wcs=wcs)
    comp_j = jj.SpatialFluxComponent.from_numpy(flux, upsampling_factor=2,
                                                wcs=wcs)
    for name in ("shape", "shape_image", "use_log_flux", "is_sparse"):
        assert getattr(comp_t, name) == getattr(comp_j, name), name
    comps_t = jt.FluxComponents({"flux": comp_t})
    comps_j = jj.FluxComponents({"flux": comp_j})
    assert comps_t.wcs is wcs and comps_j.wcs is wcs
    fluxes = comps_t.to_flux_tuple()
    assert len(fluxes) == 1 and tuple(fluxes[0].shape) == (1, 1, 8, 8)
    np.testing.assert_allclose(
        comps_t.fluxes_upsampled_numpy["flux"],
        np.asarray(comps_j.fluxes_upsampled_numpy["flux"]), rtol=1e-6)
    np.testing.assert_allclose(comps_t.flux_upsampled_total_numpy,
                               np.asarray(comps_j.flux_upsampled_total_numpy),
                               rtol=1e-6)

    deco = jt.MAPDeconvolver(n_epochs=1, device="cpu")
    loss = deco.build_loss(_datasets(), components=jt.FluxComponents(
        {"flux": jt.SpatialFluxComponent.from_numpy(np.ones((16, 16)),
                                                    wcs=wcs)}))
    assert loss.prior_weight == 1
    pairs = list(loss.poisson_loss.iter_by_dataset())
    assert len(pairs) == 1
    assert pairs[0][1] is loss.poisson_loss.npred_models_all[0]
    result = deco.run(_datasets(), components=jt.SpatialFluxComponent
                      .from_numpy(np.ones((16, 16)), wcs=wcs))
    assert result.wcs is wcs
    np.testing.assert_array_equal(result.flux_total,
                                  result.components.flux_total_numpy)


def test_trained_prior_leaves_reach_the_result():
    """The trained image-norm parameters are written back into the
    result's prior, and they are the optimiser's final leaves."""
    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    norm = jt.ASinhImageNorm(alpha=1.0, beta=2.0)
    comp = jt.SpatialFluxComponent.from_numpy(
        np.ones((16, 16)), prior=jt.GMMPatchPrior(gmm=gmm, norm=norm))
    deco = jt.MAPDeconvolver(n_epochs=3, update_strategy="joint",
                             trace_every=0, device="cpu")
    trainer = deco.make_trainer(_datasets(), comp)
    for epoch in range(3):
        trainer.epoch(epoch)
    leaves = {k: v.detach() for k, v in
              trainer.params["flux"]["prior"]["norm"].items()}
    comp.set_parameters(trainer.params["flux"])
    assert norm.alpha == float(leaves["alpha"]) != 1.0
    assert norm.beta == float(leaves["beta"]) != 2.0

    norm = jt.ASinhImageNorm(alpha=1.0, beta=2.0)
    comp = jt.SpatialFluxComponent.from_numpy(
        np.ones((16, 16)), prior=jt.GMMPatchPrior(gmm=gmm, norm=norm))
    result = deco.run(_datasets(), components=comp)
    prior = result.components["flux"].prior
    assert prior.norm is norm and (norm.alpha, norm.beta) == (
        float(leaves["alpha"]), float(leaves["beta"]))


@pytest.mark.parametrize("name", ["gmm_log_prob_matrix", "gmm_score_map",
                                  "gmm_score_marginalize"])
def test_gmm_score_functions_match_jax(name):
    """``ops.gmm_score`` over the port's scorer against the JAX package's
    XLA reference: values rtol 1e-5 (float32 quadratic forms in another
    order), the argmax equal, the patch gradient within 1e-4 of its
    max-abs. The marginalised gradient is held against JAX's autodiff of
    the logsumexp of ``gmm_log_prob_matrix``: the XLA scan's own backward
    does not renormalise its weights (``ROADMAP.md`` section 3, faults on
    the reference side)."""
    import jax
    import jax.numpy as jnp

    import jolideco_torch.ops as t_ops
    import jolideco_tpu.ops as j_ops
    from jolideco_tpu.ops.patches import get_pixel_weights

    gmm = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    prec = np.asarray(gmm.precisions_cholesky, np.float32)
    means = np.asarray(gmm.means, np.float32)
    arrays = (np.einsum("kd,kdj->kj", means, prec),
              prec,
              np.sum(np.log(np.einsum("kii->ki", prec)), axis=1),
              np.log(np.asarray(gmm.weights, np.float32)),
              get_pixel_weights((8, 8), 4).astype(np.float32).reshape(-1))
    patches = np.random.RandomState(3).normal(0, 0.3, (50, 64)).astype(
        np.float32)
    j_arrays = j_ops.GMMArrays(*arrays)
    t_arrays = t_ops.GMMArrays(*arrays)
    assert t_arrays.n_components == j_arrays.n_components
    assert t_arrays.n_features == j_arrays.n_features
    if name == "gmm_log_prob_matrix":
        want = np.asarray(j_ops.gmm_log_prob_matrix(jnp.asarray(patches),
                                                    *j_arrays.astuple()))
        got = t_ops.gmm_log_prob_matrix(torch.as_tensor(patches),
                                        *t_arrays.astuple()).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        return
    marginalize = name.endswith("marginalize")
    values_j, argmax_j = j_ops.gmm_score(jnp.asarray(patches),
                                         *j_arrays.astuple(), marginalize)
    if marginalize:
        grad_j = jax.grad(lambda x: jnp.sum(jax.nn.logsumexp(
            j_ops.gmm_log_prob_matrix(x, *j_arrays.astuple()), axis=1)))(
            jnp.asarray(patches))
    else:
        grad_j = jax.grad(lambda x: jnp.sum(j_ops.gmm_score(
            x, *j_arrays.astuple())[0]))(jnp.asarray(patches))
    grad_j = np.asarray(grad_j)
    x = torch.as_tensor(patches).requires_grad_(True)
    values_t, argmax_t = t_ops.gmm_score(x, *t_arrays.astuple(),
                                         marginalize=marginalize)
    values_t.sum().backward()
    np.testing.assert_allclose(values_t.detach().numpy(),
                               np.asarray(values_j), rtol=1e-5)
    np.testing.assert_array_equal(argmax_t.numpy(), np.asarray(argmax_j))
    np.testing.assert_allclose(x.grad.numpy(), grad_j, rtol=0,
                               atol=1e-4 * float(np.abs(grad_j).max()))


def test_host_helpers_match_jax():
    """The numpy helpers the port copies: equal to the JAX package's."""
    import jolideco_torch.ops as t_ops
    import jolideco_tpu.ops as j_ops
    from jolideco_torch.ops import fft as t_fft
    from jolideco_tpu.ops import fft as j_fft

    for n in list(range(1, 300)) + [1056, 1089, 2080]:
        assert t_ops.good_fft_size(n) == j_ops.good_fft_size(n), n
    x = np.linspace(-4, 4, 33)
    np.testing.assert_array_equal(t_ops.evaluate_trapez(x, 3.0, 0.5),
                                  j_ops.evaluate_trapez(x, 3.0, 0.5))
    rs = np.random.RandomState(0)
    patches = rs.rand(49, 8, 8)
    np.testing.assert_array_equal(
        t_ops.reconstruct_from_overlapping_patches(patches, (32, 32), 4),
        j_ops.reconstruct_from_overlapping_patches(patches, (32, 32), 4))
    image, kernel = rs.rand(20, 24), rs.rand(5, 7)
    np.testing.assert_array_equal(t_fft.convolve_fft_numpy(image, kernel),
                                  j_fft.convolve_fft_numpy(image, kernel))
    for got, want in zip(t_fft.kernel_fft_numpy(kernel, (20, 24), (26, 32)),
                         j_fft.kernel_fft_numpy(kernel, (20, 24), (26, 32))):
        np.testing.assert_array_equal(got, want)


def test_switches_registries_and_markers():
    from jolideco_torch import config
    from jolideco_torch.priors.patches import GMM_REGISTRY
    from jolideco_torch.utils import (
        NORMS_PATCH_REGISTRY,
        NORMS_REGISTRY,
        split_datasets_validation,
    )
    from jolideco_torch.utils.testing import requires_device

    from jolideco_torch.priors.patches.gmm import REFERENCE_LIBRARY_ALIASES

    # the JAX registry also names the reference's library, which the port
    # resolves to a shipped model (test_reference_library_aliases_...)
    assert set(GMM_REGISTRY) | set(REFERENCE_LIBRARY_ALIASES) == set(
        jj.priors.patches.GMM_REGISTRY)
    assert set(NORMS_REGISTRY) == set(jj.utils.NORMS_REGISTRY)
    assert set(NORMS_PATCH_REGISTRY) == set(jj.utils.NORMS_PATCH_REGISTRY)
    assert split_datasets_validation is \
        jt.utils.datasets.split_datasets_validation
    assert config.fused_enabled() and config.use_fused() == "auto"
    try:
        config.set_use_fused("off")
        assert not config.fused_enabled()
        with config.force_fused("auto"):
            assert config.fused_enabled()
        assert config.use_fused() == "off"
    finally:
        config.set_use_fused("auto")
    with pytest.raises(ValueError, match="fused mode"):
        config.set_use_fused("on")
    assert not requires_device("cpu").args[0]
    assert requires_device("gpu").args[0] == (not torch.cuda.is_available())
