"""The port's public signatures against the JAX package's.

Every keyword that the JAX package's deconvolver, its ``run``, the flux
component, the GMM patch prior and the stacked loss accept is accepted
by the port (``inspect.signature``). A keyword whose option is not
ported raises ``NotImplementedError`` for anything but its default; the
harmless ones are honoured, and the ported options raise the JAX
package's errors where it does. The names of the reference's external GMM
library resolve to the shipped ``astro-snr-v1`` with the JAX package's
warning.
"""

import inspect
import logging

import numpy as np
import pytest
import torch

import jolideco_torch as jt
import jolideco_torch.utils.norms as tn
import jolideco_tpu as jj
import jolideco_tpu.utils.norms as jn
from jolideco_torch.parallel.stacked import StackedPoissonLoss as TStacked
from jolideco_torch.priors.patches.gmm import REFERENCE_LIBRARY_ALIASES
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
    {"mesh": object()},
    {"stop_early": True},
    {"checkpoint_path": "checkpoints"},
], ids=lambda kw: next(iter(kw)))
def test_deconvolver_raises_on_unported_options(kwargs, tmp_path):
    """``mesh`` is not ported and raises ``NotImplementedError``.
    ``stop_early`` is ported: the deconvolver takes it, and its ``run``
    without validation data raises the JAX package's ``ValueError``.
    ``checkpoint_path`` is ported: the directory is made, the
    configuration records it, and each epoch writes the JAX package's
    file name."""
    if "mesh" in kwargs:
        with pytest.raises(NotImplementedError, match="mesh"):
            jt.MAPDeconvolver(**kwargs)
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
    with pytest.raises(NotImplementedError, match="row_shards"):
        TStacked.from_datasets(_datasets(), comps, row_shards=2, device="cpu")


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
