"""YAML serialisation of components and calibrations (the JAX package's
``utils/io/yaml.py``).

The configuration goes in the YAML file, a dense component's flux in a
FITS file beside it, one a component. pyyaml is imported on the first
read or write, so that the package imports without it.
"""

import logging
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["to_yaml_str", "from_yaml_str", "write_yaml", "load_yaml"]


def to_yaml_str(data):
    """Dump a dict to a YAML string."""
    import yaml

    return yaml.safe_dump(data, default_flow_style=False, sort_keys=False)


def from_yaml_str(yaml_str):
    """Load a dict from a YAML string."""
    import yaml

    return yaml.safe_load(yaml_str)


def write_yaml(filename, data, overwrite):
    """Write a dict to a YAML file."""
    path = Path(filename)
    if path.exists() and not overwrite:
        raise OSError(f"{filename} already exists!")
    log.info(f"Writing {filename}")
    path.write_text(to_yaml_str(data=data))


def load_yaml(filename):
    """Load a dict from a YAML file."""
    path = Path(filename)
    log.info(f"Reading {path}")
    return from_yaml_str(path.read_text())


def _sanitize(data):
    """Numpy scalars and arrays and tuples as plain Python types."""
    if isinstance(data, dict):
        return {key: _sanitize(value) for key, value in data.items()}
    if isinstance(data, (list, tuple)):
        return [_sanitize(value) for value in data]
    if isinstance(data, np.generic):
        return data.item()
    if isinstance(data, np.ndarray):
        return data.tolist()
    return data


def flux_component_to_yaml_dict(flux_component, filename, name=None):
    """A component's configuration, a dense one's flux replaced by the
    name of its FITS file (a sparse component keeps its source lists
    inline)."""
    data = flux_component.to_dict()
    if "x_pos" in data:
        return _sanitize(data)
    path = Path(filename)

    if name is None:
        name = path.stem

    filename_data = path.parent / f"{name}-data.fits"
    data["flux_upsampled"] = str(filename_data.absolute())
    return _sanitize(data)


def write_flux_component_to_yaml(flux_component, filename, overwrite):
    """Write one flux component to YAML (and its flux to FITS)."""
    data = flux_component_to_yaml_dict(
        flux_component=flux_component, filename=filename
    )
    if "flux_upsampled" in data:
        flux_component.write(data["flux_upsampled"], overwrite=overwrite)
    write_yaml(filename=filename, data=data, overwrite=overwrite)


def write_flux_components_to_yaml(flux_components, filename, overwrite):
    """Write flux components to YAML (and each dense flux to FITS)."""
    data = {}
    for name, flux_component in flux_components.items():
        data[name] = flux_component_to_yaml_dict(
            flux_component=flux_component, filename=filename, name=name
        )
        if "flux_upsampled" in data[name]:
            flux_component.write(
                data[name]["flux_upsampled"], overwrite=overwrite
            )
    write_yaml(filename=filename, data=data, overwrite=overwrite)


def read_flux_component_from_yaml(filename, device=None):
    """Read one flux component from YAML."""
    from ...models import SparseSpatialFluxComponent, SpatialFluxComponent

    data = load_yaml(filename=filename)
    if "x_pos" in data:
        return SparseSpatialFluxComponent.from_dict(data=data, device=device)
    return SpatialFluxComponent.from_dict(data=data, device=device)


def read_flux_components_from_yaml(filename, device=None):
    """Read flux components from YAML."""
    from ...models import FluxComponents

    data = load_yaml(filename=filename)
    return FluxComponents.from_dict(data=data, device=device)


def read_npred_calibrations_from_yaml(filename, device=None):
    """Read calibrations from YAML."""
    from ...models import NPredCalibrations

    data = load_yaml(filename=filename)
    return NPredCalibrations.from_dict(data=data, device=device)


def write_npred_calibrations_to_yaml(npred_calibrations, filename, overwrite):
    """Write calibrations to YAML."""
    data = _sanitize(npred_calibrations.to_dict())
    write_yaml(filename=filename, data=data, overwrite=overwrite)
