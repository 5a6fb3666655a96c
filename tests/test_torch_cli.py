"""The port's command line, checkpoints and resuming from files, against
the JAX package's (``jolideco_torch/cli.py``, ``MAPDeconvolver(
checkpoint_path=)``, ``MAPDeconvolverResult.read_checkpoint``).

- The CLI runs the configuration of ``tests/test_resume_and_cli.py``
  with ``device: cpu`` (datasets in ``.npz`` and in FITS, results in FITS
  and ASDF); its flux is within rtol 1e-4 of the JAX CLI's on the same
  files (the ``BASELINE.md`` bar for flux maps; the uniform prior draws
  nothing).
- A 3-epoch run with ``checkpoint_path`` writes the JAX package's file
  names and trace ``filename`` column, its last checkpoint holds the
  final flux (within one unit in the last place: a log flux is read back
  as ``exp(log(v))``), each checkpoint within rtol 1e-4 of the JAX
  package's, and the same run without checkpoints gives the same bits.
- A result written by the JAX package, read by the port and passed as
  ``resume_from`` continues the fit as the JAX package continues it,
  rtol 1e-4.
"""

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from numpy.testing import assert_allclose, assert_array_equal, \
    assert_array_max_ulp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.cli import cli as tcli
from jolideco_tpu.cli import cli as jcli
from jolideco_tpu.data import gauss_and_point_sources_gauss_psf
from jolideco_tpu.utils.io.minifits import ImageHDU, write_hdulist

torch.set_num_threads(1)

RTOL = 1e-4


def test_cli_version_and_help():
    runner = CliRunner()
    result = runner.invoke(tcli, ["--version"])
    assert result.exit_code == 0 and "Jolideco-Torch version" in result.output
    result = runner.invoke(tcli, ["--help"])
    assert result.exit_code == 0
    assert "test" in result.output and "run" in result.output


def jax_cli_config(tmp_path, dataset_format):
    """``tests/test_resume_and_cli.py``'s run configuration, its dataset
    in ``.npz`` or in FITS (one image HDU a key)."""
    rs = np.random.RandomState(642020)
    dataset = gauss_and_point_sources_gauss_psf(random_state=rs)
    if dataset_format == "npz":
        path = tmp_path / "obs.npz"
        np.savez(path, **dataset)
    else:
        path = tmp_path / "obs.fits"
        write_hdulist([ImageHDU()] + [
            ImageHDU(data=np.asarray(value), name=key)
            for key, value in dataset.items()], path)
    flux_init = rs.gamma(20, size=(32, 32))
    return {
        "datasets": {"obs-1": {"filename": str(path)}},
        "components": {"flux": {"flux_upsampled": flux_init.tolist(),
                                "prior": {"type": "uniform"}}},
        "deconvolver": {"n_epochs": 3, "learning_rate": 0.1,
                        "display_progress": False, "device": "cpu"},
    }


@pytest.mark.parametrize("dataset_format,output", [("npz", "fits"),
                                                   ("fits", "asdf")])
def test_cli_run_matches_the_jax_cli(dataset_format, output, tmp_path):
    config = jax_cli_config(tmp_path, dataset_format)
    config_path = tmp_path / "run.yaml"
    config_path.write_text(yaml.safe_dump(config))
    runner = CliRunner()
    outputs = {}
    for tag, group in (("jax", jcli), ("torch", tcli)):
        outputs[tag] = tmp_path / f"result-{tag}.{output}"
        got = runner.invoke(group, ["run", str(config_path), "--output",
                                    str(outputs[tag])])
        assert got.exit_code == 0, got.output
        assert f"wrote {outputs[tag]}" in got.output
    port = jt.MAPDeconvolverResult.read(outputs["torch"], device="cpu")
    jax = jj.MAPDeconvolverResult.read(outputs["jax"])
    assert port.config["device"] == "cpu"
    assert port.config["n_epochs"] == jax.config["n_epochs"] == 3
    assert_allclose(port.flux_upsampled_total,
                    np.asarray(jax.flux_upsampled_total), rtol=RTOL)
    assert_allclose(port.trace_loss["total"], jax.trace_loss["total"],
                    rtol=RTOL)
    # an existing output is kept unless --overwrite
    again = runner.invoke(tcli, ["run", str(config_path), "--output",
                                 str(outputs["torch"])])
    assert again.exit_code != 0
    again = runner.invoke(tcli, ["run", str(config_path), "--output",
                                 str(outputs["torch"]), "--overwrite"])
    assert again.exit_code == 0, again.output


@pytest.mark.parametrize("conv_mode", ["ct", "mxu", "direct"])
def test_cli_run_takes_the_conv_mode_from_the_yaml(conv_mode, tmp_path):
    """The joint strategy under each matrix-DFT or direct convolution, as
    a YAML configuration names it, in both command lines: the result
    records the mode and its flux is within rtol 1e-4 of the JAX CLI's."""
    config = jax_cli_config(tmp_path, "npz")
    config["deconvolver"].update(update_strategy="joint",
                                 conv_mode=conv_mode)
    config_path = tmp_path / "run.yaml"
    config_path.write_text(yaml.safe_dump(config))
    runner = CliRunner()
    results = {}
    for tag, group, pkg in (("jax", jcli, jj), ("torch", tcli, jt)):
        output = tmp_path / f"result-{tag}.asdf"
        got = runner.invoke(group, ["run", str(config_path), "--output",
                                    str(output)])
        assert got.exit_code == 0, got.output
        kwargs = {"device": "cpu"} if pkg is jt else {}
        results[tag] = pkg.MAPDeconvolverResult.read(output, **kwargs)
    assert results["torch"].config["conv_mode"] == conv_mode
    assert results["jax"].config["conv_mode"] == conv_mode
    assert_allclose(results["torch"].flux_upsampled_total,
                    np.asarray(results["jax"].flux_upsampled_total),
                    rtol=RTOL)


def test_run_config_takes_a_dict(tmp_path):
    from jolideco_torch.cli import run_config

    config = jax_cli_config(tmp_path, "npz")
    result = run_config(config)
    assert isinstance(result, jt.MAPDeconvolverResult)
    assert result.components["flux"].flux_upsampled.device.type == "cpu"
    assert len(result.trace_loss) == 3


@pytest.fixture(scope="module")
def datasets():
    rs = np.random.RandomState(642020)
    return {f"{idx}": gauss_and_point_sources_gauss_psf(random_state=rs)
            for idx in range(2)}


def flux_init():
    return np.random.RandomState(642020).gamma(20, size=(32, 32))


def checkpointed(pkg, datasets, path, **kwargs):
    """``tests/test_io.py``'s checkpointed run in either package."""
    component = pkg.SpatialFluxComponent.from_numpy(
        flux=flux_init(), upsampling_factor=2, prior=pkg.UniformPrior())
    extra = {"device": "cpu"} if pkg is jt else {}
    deco = pkg.MAPDeconvolver(n_epochs=3, learning_rate=0.1,
                              display_progress=False, checkpoint_path=path,
                              **extra, **kwargs)
    return deco.run(datasets=datasets, components={"flux-1": component})


def test_checkpoints_match_the_jax_package(datasets, tmp_path):
    port = checkpointed(jt, datasets, tmp_path / "torch")
    jax = checkpointed(jj, datasets, tmp_path / "jax")
    names = [f"checkpoint-epoch-{epoch}.asdf" for epoch in range(3)]
    for folder in ("torch", "jax"):
        assert sorted(p.name for p in (tmp_path / folder).iterdir()) == names
    assert list(port.trace_loss["filename"]) == names
    assert list(port.trace_loss["filename"]) == list(
        jax.trace_loss["filename"])
    assert port.checkpoint_path == tmp_path / "torch"
    last = port.read_checkpoint(2, device="cpu")
    assert_array_max_ulp(last.flux_upsampled_total,
                         port.flux_upsampled_total, 1)
    assert_allclose(port.flux_upsampled_total,
                    np.asarray(jax.flux_upsampled_total), rtol=RTOL)
    for epoch in range(3):
        got = port.read_checkpoint(epoch, device="cpu")
        want = jj.MAPDeconvolverResult.read(
            tmp_path / "jax" / names[epoch])
        # the trace so far: the rows before this epoch's
        assert len(got.trace_loss) == len(want.trace_loss) == epoch
        assert got.config == {**want.config, "device": "cpu",
                              "checkpoint_path": str(tmp_path / "torch")}
        assert_allclose(got.flux_upsampled_total,
                        np.asarray(want.flux_upsampled_total), rtol=RTOL)
    with pytest.raises(FileNotFoundError, match="epoch 3"):
        port.read_checkpoint(3, device="cpu")
    unchecked = jt.MAPDeconvolverResult(config={"checkpoint_path": None},
                                        components=port.components)
    with pytest.raises(ValueError, match="without checkpoint_path"):
        unchecked.read_checkpoint(0)


def test_checkpoints_change_nothing(datasets, tmp_path):
    """The joint strategy under the GMM prior with its cycle spin: with
    and without a checkpoint each epoch, the same flux, trace and step
    losses bit for bit; epoch 1's checkpoint holds a 2-epoch run's
    flux."""
    gmm = jt.GaussianMixtureModel.from_registry("astro-snr-v1")

    def run(n_epochs, path=None):
        component = jt.SpatialFluxComponent.from_numpy(
            flux=flux_init(), prior=jt.GMMPatchPrior(gmm=gmm, stride=4,
                                                     cycle_spin=True))
        deco = jt.MAPDeconvolver(n_epochs=n_epochs, update_strategy="joint",
                                 checkpoint_path=path, device="cpu",
                                 display_progress=False)
        return deco.run(datasets, components=component)

    with_files = run(3, tmp_path / "ck")
    without = run(3)
    assert_array_equal(with_files.flux_upsampled_total,
                       without.flux_upsampled_total)
    assert_array_equal(with_files.loss_per_step, without.loss_per_step)
    for name in without.trace_loss.colnames[:-1]:
        assert_array_equal(with_files.trace_loss[name],
                           without.trace_loss[name])
    assert list(without.trace_loss["filename"]) == [""] * 3
    two = run(2)
    assert_array_max_ulp(
        with_files.read_checkpoint(1, device="cpu").flux_upsampled_total,
        two.flux_upsampled_total, 1)


def test_resume_from_a_jax_written_result(datasets, tmp_path):
    def first_run(pkg):
        component = pkg.SpatialFluxComponent.from_numpy(
            flux=flux_init(), prior=pkg.UniformPrior())
        extra = {"device": "cpu"} if pkg is jt else {}
        return pkg.MAPDeconvolver(n_epochs=3, display_progress=False,
                                  **extra).run(datasets,
                                               components=component)

    first_run(jj).write(tmp_path / "jax.fits")
    jax_read = jj.MAPDeconvolverResult.read(tmp_path / "jax.fits")
    port_read = jt.MAPDeconvolverResult.read(tmp_path / "jax.fits",
                                             device="cpu")
    assert port_read.opt_state is None and port_read.generator_state is None
    jax = jj.MAPDeconvolver(n_epochs=3, display_progress=False).run(
        datasets, components=jax_read.components, resume_from=jax_read)
    port = jt.MAPDeconvolver(n_epochs=3, display_progress=False,
                             device="cpu").run(
        datasets, components=port_read.components, resume_from=port_read)
    assert_allclose(port.flux_upsampled_total,
                    np.asarray(jax.flux_upsampled_total), rtol=RTOL)
