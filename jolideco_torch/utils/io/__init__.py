"""I/O registries: the format from the file name, and the reader or
writer of each (object kind, format) pair.

The registries of the JAX package's ``utils/io``: results in FITS and
ASDF; dense components and component collections in FITS, ASDF and YAML;
sparse components in FITS; calibrations in FITS and YAML. Every format is
implemented here (:mod:`.minifits`, :mod:`.asdf_lite`); ASDF and YAML need
pyyaml, imported on first use. Readers take ``device=`` and put the
tensors they build there.
"""

from pathlib import Path

from .asdf import (
    read_flux_component_from_asdf,
    read_flux_components_from_asdf,
    read_map_result_from_asdf,
    write_flux_component_to_asdf,
    write_flux_components_to_asdf,
    write_map_result_to_asdf,
)
from .fits import (
    read_flux_component_from_fits,
    read_flux_components_from_fits,
    read_map_result_from_fits,
    read_npred_calibrations_from_fits,
    write_flux_component_to_fits,
    write_flux_components_to_fits,
    write_map_result_to_fits,
    write_npred_calibrations_to_fits,
)
from .yaml import (
    read_flux_component_from_yaml,
    read_flux_components_from_yaml,
    read_npred_calibrations_from_yaml,
    write_flux_component_to_yaml,
    write_flux_components_to_yaml,
    write_npred_calibrations_to_yaml,
)

__all__ = [
    "guess_format_from_filename",
    "get_reader",
    "get_writer",
    "document_io_formats",
    "IO_FORMATS_MAP_RESULT_READ",
    "IO_FORMATS_MAP_RESULT_WRITE",
    "IO_FORMATS_FLUX_COMPONENT_READ",
    "IO_FORMATS_FLUX_COMPONENT_WRITE",
    "IO_FORMATS_FLUX_COMPONENTS_READ",
    "IO_FORMATS_FLUX_COMPONENTS_WRITE",
    "IO_FORMATS_SPARSE_FLUX_COMPONENT_WRITE",
    "IO_FORMATS_SPARSE_FLUX_COMPONENT_READ",
    "IO_FORMATS_NPRED_CALIBRATIONS_READ",
    "IO_FORMATS_NPRED_CALIBRATIONS_WRITE",
]


class document_io_formats:
    """Decorator filling a ``{formats}`` docstring placeholder."""

    def __init__(self, registry):
        self.registry = set(registry)

    def __call__(self, func):
        func.__doc__ = func.__doc__.format(formats=self.registry)
        return func


def guess_format_from_filename(filename):
    """Guess the I/O format from a filename suffix."""
    path = Path(filename)
    if path.suffix == ".fits":
        return "fits"
    if path.suffix == ".asdf":
        return "asdf"
    if path.suffix in (".yml", ".yaml"):
        return "yaml"
    raise ValueError(f"Cannot guess format from filename {filename}")


def get_writer(filename, format, registry):
    """Look up a writer for the given filename/format."""
    if format is None:
        format = guess_format_from_filename(filename=filename)
    if format not in registry:
        raise ValueError(
            f"Not a valid format '{format}', choose from {list(registry)}"
        )
    return registry[format]


def get_reader(filename, format, registry):
    """Look up a reader for the given filename/format."""
    if format is None:
        format = guess_format_from_filename(filename=filename)
    if format not in registry:
        raise ValueError(
            f"Not a valid format '{format}', choose from {list(registry)}"
        )
    return registry[format]


IO_FORMATS_MAP_RESULT_READ = {
    "fits": read_map_result_from_fits,
    "asdf": read_map_result_from_asdf,
}

IO_FORMATS_MAP_RESULT_WRITE = {
    "fits": write_map_result_to_fits,
    "asdf": write_map_result_to_asdf,
}

IO_FORMATS_FLUX_COMPONENT_READ = {
    "fits": read_flux_component_from_fits,
    "yaml": read_flux_component_from_yaml,
    "asdf": read_flux_component_from_asdf,
}

IO_FORMATS_FLUX_COMPONENT_WRITE = {
    "yaml": write_flux_component_to_yaml,
    "fits": write_flux_component_to_fits,
    "asdf": write_flux_component_to_asdf,
}

IO_FORMATS_SPARSE_FLUX_COMPONENT_WRITE = {
    "fits": write_flux_component_to_fits,
}

IO_FORMATS_SPARSE_FLUX_COMPONENT_READ = {
    "fits": read_flux_component_from_fits,
}

IO_FORMATS_FLUX_COMPONENTS_READ = {
    "fits": read_flux_components_from_fits,
    "asdf": read_flux_components_from_asdf,
    "yaml": read_flux_components_from_yaml,
}

IO_FORMATS_FLUX_COMPONENTS_WRITE = {
    "fits": write_flux_components_to_fits,
    "asdf": write_flux_components_to_asdf,
    "yaml": write_flux_components_to_yaml,
}

IO_FORMATS_NPRED_CALIBRATIONS_READ = {
    "yaml": read_npred_calibrations_from_yaml,
    "fits": read_npred_calibrations_from_fits,
}

IO_FORMATS_NPRED_CALIBRATIONS_WRITE = {
    "yaml": write_npred_calibrations_to_yaml,
    "fits": write_npred_calibrations_to_fits,
}
