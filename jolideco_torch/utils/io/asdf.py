"""ASDF serialisation of components and results (the JAX package's
``utils/io/asdf.py``), on the package's own subset of the standard
(:mod:`.asdf_lite`)."""

import logging
from pathlib import Path

from .asdf_lite import read_asdf, write_asdf

log = logging.getLogger(__name__)


def write_flux_component_to_asdf(flux_component, filename, overwrite,
                                 **kwargs):
    """Write one flux component to ASDF."""
    data = flux_component.to_dict(include_data="numpy")
    log.info(f"writing {filename}")
    write_asdf(data, filename, overwrite=overwrite)


def read_flux_component_from_asdf(filename, device=None):
    """Read one flux component from ASDF."""
    from ...models import SpatialFluxComponent

    data = read_asdf(Path(filename))
    return SpatialFluxComponent.from_dict(data=data, device=device)


def write_flux_components_to_asdf(flux_components, filename, overwrite,
                                  **kwargs):
    """Write flux components to ASDF."""
    data = flux_components.to_dict(include_data="numpy")
    log.info(f"writing {filename}")
    write_asdf(data, filename, overwrite=overwrite)


def read_flux_components_from_asdf(filename, device=None):
    """Read flux components from ASDF."""
    from ...models import FluxComponents

    data = read_asdf(Path(filename))
    return FluxComponents.from_dict(data=data, device=device)


def write_map_result_to_asdf(result, filename, overwrite, **kwargs):
    """Write a MAP result to ASDF."""
    data = {}
    data["components"] = result.components.to_dict(include_data="numpy")

    if result.components_init is not None:
        data["components-init"] = result.components_init.to_dict(
            include_data="numpy"
        )

    if result.calibrations:
        data["calibrations"] = result.calibrations.to_dict()
    if result.calibrations_init:
        data["calibrations-init"] = result.calibrations_init.to_dict()

    data["trace-loss"] = result.trace_loss.to_dict()
    data["config"] = result.config

    log.info(f"writing {filename}")
    write_asdf(data, filename, overwrite=overwrite)


def read_map_result_from_asdf(filename, device=None):
    """Read a MAP result from ASDF."""
    from ...config import resolve_device
    from ...core import MAPDeconvolverResult
    from ...models import FluxComponents, NPredCalibrations

    device = resolve_device(device)
    log.info(f"Reading {filename}")
    data = read_asdf(Path(filename))

    components = FluxComponents.from_dict(data=data["components"],
                                          device=device)

    components_init = None
    if "components-init" in data:
        components_init = FluxComponents.from_dict(
            data=data["components-init"], device=device)

    calibrations = None
    if "calibrations" in data:
        calibrations = NPredCalibrations.from_dict(
            data=data["calibrations"], device=device)
    calibrations_init = None
    if "calibrations-init" in data:
        calibrations_init = NPredCalibrations.from_dict(
            data=data["calibrations-init"], device=device)

    return MAPDeconvolverResult(
        config=data["config"],
        components=components,
        components_init=components_init,
        calibrations=calibrations,
        calibrations_init=calibrations_init,
        trace_loss=data["trace-loss"],
    )
