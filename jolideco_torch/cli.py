"""Command line interface of the port (the JAX package's ``cli.py``).

    jolideco-torch --version
    jolideco-torch test [--args "..."]
    jolideco-torch run config.yaml --output result.fits [--overwrite]

(or ``python -m jolideco_torch.cli ...``). ``run`` reads a run
configuration (the JAX package's: ``datasets``, ``components``,
``deconvolver``; the ``deconvolver`` block may name the port's
``device``), fits, and writes the result. Its body is :func:`run_config`,
which needs no click; click is imported when the command group is first
used (``cli``), pyyaml when a configuration file is read.
"""

import functools
import logging
import warnings
from pathlib import Path

import numpy as np

__all__ = ["cli", "load_datasets", "run_config"]


def load_datasets(specs):
    """The datasets of a run configuration: ``{name: {"filename": ...}}``
    read into ``{name: {key: array}}``, a FITS file by its named image
    HDUs (keys in lower case), any other file by ``np.load``."""
    from .utils.io.minifits import read_hdulist

    datasets = {}
    for name, spec in specs.items():
        filename = str(spec["filename"])
        if filename.endswith((".fits", ".fits.gz")):
            datasets[name] = {
                hdu.name.lower(): np.asarray(hdu.data)
                for hdu in read_hdulist(filename)
                if hdu.data is not None and hdu.name
            }
        else:
            with np.load(filename) as data:
                datasets[name] = {key: data[key] for key in data.files}
    return datasets


def run_config(config, output=None, overwrite=False):
    """Run a MAP deconvolution from a run configuration and write the
    result.

    Parameters
    ----------
    config : str, Path or dict
        A YAML file (read with pyyaml) or its contents: ``datasets``
        (``{name: {"filename": ...}}``, see :func:`load_datasets`),
        ``components`` (``FluxComponents.to_dict`` output; flux arrays
        may be nested lists or file names) and ``deconvolver`` (the
        keywords of `MAPDeconvolver`, ``device`` among them).
    output : str or Path, optional
        Where the result goes (FITS or ASDF by the suffix); ``None``
        writes nothing.
    overwrite : bool

    Returns
    -------
    result : `MAPDeconvolverResult`
    """
    from . import FluxComponents, MAPDeconvolver

    if not isinstance(config, dict):
        from .utils.io.yaml import load_yaml

        config = load_yaml(config)
    datasets = load_datasets(config["datasets"])
    deco = MAPDeconvolver(**config.get("deconvolver", {}))
    components = FluxComponents.from_dict(config["components"],
                                          device=deco.device)
    result = deco.run(datasets=datasets, components=components)
    if output is not None:
        result.write(output, overwrite=overwrite)
    return result


@functools.cache
def _command_group():
    import click

    from . import __version__

    def print_version(ctx, param, value):
        if not value or ctx.resilient_parsing:
            return
        click.echo(f"Jolideco-Torch version {__version__}")
        ctx.exit()

    @click.group("jolideco-torch",
                 context_settings={"help_option_names": ["-h", "--help"]})
    @click.option("--log-level", default="info",
                  help="Logging verbosity level.",
                  type=click.Choice(["debug", "info", "warning", "error"]))
    @click.option("--ignore-warnings", is_flag=True, help="Ignore warnings?")
    @click.option("--version", is_flag=True, callback=print_version,
                  expose_value=False, is_eager=True,
                  help="Print version and exit.")
    def group(log_level, ignore_warnings):
        """Jolideco-Torch command line interface (CLI).

        Joint likelihood deconvolution of low-count data on PyTorch (a
        CUDA card by default). Use ``--help`` on sub-commands for
        arguments and options.
        """
        logging.basicConfig(level=log_level.upper())
        if ignore_warnings:
            warnings.simplefilter("ignore")

    @group.command("test")
    @click.option("--args", "pytest_args", default="",
                  help="Extra pytest args")
    def test(pytest_args):
        """Run the port's tests (``tests/test_torch_*.py``)."""
        import sys

        import pytest

        tests_dir = Path(__file__).parent.parent / "tests"
        files = sorted(str(p) for p in tests_dir.glob("test_torch_*.py"))
        if not files:
            click.echo(
                "The tests are not installed with the package; run "
                "'python -m pytest tests/test_torch_*.py' from a source "
                "checkout.", err=True)
            sys.exit(1)
        sys.exit(pytest.main([*files, "-q", *pytest_args.split()]))

    @group.command("run")
    @click.argument("config", type=click.Path(exists=True))
    @click.option("--output", default="result.fits",
                  help="Output result file")
    @click.option("--overwrite", is_flag=True)
    def run(config, output, overwrite):
        """Run a MAP deconvolution from a YAML run configuration and
        write its result."""
        run_config(config, output=output, overwrite=overwrite)
        click.echo(f"wrote {output}")

    return group


def __getattr__(name):
    # the click group is built on first access, so that importing this
    # module (and run_config) needs no click
    if name == "cli":
        return _command_group()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


if __name__ == "__main__":
    _command_group()()
