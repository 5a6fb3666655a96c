"""FITS serialisation of components, calibrations, traces and results
(the JAX package's ``utils/io/fits.py``).

Dense components are IMAGE extensions whose header carries their
flattened configuration and WCS cards; sparse components, calibrations,
the trace and the configuration are binary tables; all on the package's
own FITS subset (:mod:`.minifits`). Two files written by this package and
the JAX package from the same values are the same bytes.
"""

import logging

import numpy as np

from ..misc import flatten_dict, unflatten_dict
from .minifits import BinTableHDU, ImageHDU, read_hdulist, write_hdulist

log = logging.getLogger(__name__)

SUFFIX_INIT = "-INIT"
META_SEP = "."

FITS_META = {
    "use_log_flux": "LOG_FLUX",
    "upsampling_factor": "UPSAMPLE",
    "frozen": "FROZEN",
    "shape": "SHAPE",
    "prior.type": "PTYPE",
    "prior.stride": "PSTRIDE",
    "prior.cycle_spin": "PSPIN",
    "prior.cycle_spin_subpix": "PSUBSPIN",
    "prior.jitter": "PJITTER",
    "prior.marginalize": "PMARG",
    "prior.alpha": "PALPHA",
    "prior.beta": "PBETA",
    "prior.width": "PWIDTH",
    "prior.gmm.type": "PGMMTYPE",
    "prior.gmm.stride": "PGMMSTRI",
    "prior.norm.type": "PNORMTYP",
    "prior.norm.max_value": "PNORMMAX",
    "prior.norm.alpha": "PNORMALP",
    "prior.norm.beta": "PNORMBET",
    "prior.patch_norm.type": "PNPTYPE",
}

FITS_META_INVERSE = {value: key for key, value in FITS_META.items()}


def _meta_to_header(data, header):
    meta = flatten_dict(data, sep=META_SEP)
    for key, value in meta.items():
        fits_key = FITS_META.get(key)
        if fits_key is None:
            log.debug(f"No FITS keyword mapping for {key!r}, skipping")
            continue
        header[fits_key] = value
    return header


def _meta_from_header(header):
    data = {}
    for fits_key, key in FITS_META_INVERSE.items():
        value = header.get(fits_key)
        if value is not None:
            data[key] = value
    return unflatten_dict(data, sep=META_SEP)


def sparse_flux_component_to_table_hdu(flux_component, name):
    """Sparse component -> binary-table HDU."""
    data = flux_component.to_dict()

    columns = {
        "x_pos": np.atleast_1d(data.pop("x_pos")).astype(np.float64),
        "y_pos": np.atleast_1d(data.pop("y_pos")).astype(np.float64),
        "flux": np.atleast_1d(data.pop("flux")).astype(np.float64),
    }

    from ..wcs import wcs_to_header

    header = {}
    wcs_cards = wcs_to_header(flux_component.wcs)
    if wcs_cards:
        header.update(wcs_cards)
    shape = data.pop("shape")
    data.pop("wcs", None)
    header["IMSHAPE1"] = int(shape[-2])
    header["IMSHAPE2"] = int(shape[-1])
    _meta_to_header(data, header)

    return BinTableHDU(columns=columns, header=header, name=name.upper())


def sparse_flux_component_from_table_hdu(hdu, device=None):
    """Binary-table HDU -> sparse component."""
    from ...models import SparseSpatialFluxComponent

    shape = (hdu.header["IMSHAPE1"], hdu.header["IMSHAPE2"])
    meta = _meta_from_header(hdu.header)

    kwargs = {}
    if "prior" in meta:
        from ...priors import Prior

        kwargs["prior"] = Prior.from_dict(meta["prior"])

    from ..wcs import SimpleWCS

    wcs = SimpleWCS.from_header(hdu.header)
    if wcs is not None:
        kwargs["wcs"] = wcs

    return SparseSpatialFluxComponent.from_numpy(
        x_pos=hdu.columns["x_pos"],
        y_pos=hdu.columns["y_pos"],
        flux=hdu.columns["flux"],
        shape=shape,
        use_log_flux=bool(meta.get("use_log_flux", True)),
        frozen=bool(meta.get("frozen", False)),
        device=device,
        **kwargs,
    ).to(device)


def flux_component_to_image_hdu(flux_component, name):
    """Dense component -> image HDU.

    The component's WCS is written as standard FITS WCS keywords in
    the image header: astropy builds an ``astropy.wcs.WCS`` from them.
    """
    from ..wcs import wcs_to_header

    header = {}
    wcs_cards = wcs_to_header(flux_component.wcs)
    if wcs_cards:
        header.update(wcs_cards)
    meta = flux_component.to_dict()
    meta.pop("wcs", None)  # written as real WCS cards above
    norm_config = (meta.get("prior") or {}).get("norm") or {}
    if norm_config.get("type") == "inverse-cdf":
        # the tabulated x/cdf arrays have no FITS keyword mapping:
        # the write would succeed and the read would fail — refuse
        # loudly at write time instead
        raise ValueError(
            "a component whose prior uses InverseCDFImageNorm cannot "
            "round-trip through FITS header keywords (the tabulated "
            "x/cdf arrays don't fit); write '.asdf' instead"
        )
    _meta_to_header(meta, header)
    return ImageHDU(
        header=header,
        data=flux_component.flux_upsampled_numpy,
        name=name.upper(),
    )


def flux_component_from_image_hdu(hdu, device=None):
    """Image HDU -> dense component (its WCS restored)."""
    from ...models import SpatialFluxComponent
    from ..wcs import SimpleWCS

    data = _meta_from_header(hdu.header)
    data["flux_upsampled"] = np.asarray(hdu.data)
    wcs = SimpleWCS.from_header(hdu.header)
    if wcs is not None:
        # from_dict passes a non-dict wcs through untouched — no need
        # to round-trip it through header cards a second time
        data["wcs"] = wcs
    return SpatialFluxComponent.from_dict(data=data, device=device)


def flux_components_to_hdulist(flux_components, name_suffix=""):
    """Components -> HDU list."""
    hdulist = []
    for name, component in flux_components.items():
        name = name + name_suffix
        if component.is_sparse:
            hdu = sparse_flux_component_to_table_hdu(
                flux_component=component, name=name
            )
        else:
            hdu = flux_component_to_image_hdu(
                flux_component=component, name=name
            )
        hdulist.append(hdu)
    return hdulist


def flux_components_from_hdulist(hdulist, device=None):
    """HDU list -> components (skips bookkeeping HDUs)."""
    from ...models import FluxComponents

    flux_components = FluxComponents()
    for hdu in hdulist:
        # strip only a trailing suffix: a component legitimately named
        # e.g. "disk-initial" must not be mangled mid-word
        name = hdu.name
        if name.endswith(SUFFIX_INIT):
            name = name[: -len(SUFFIX_INIT)]
        name = name.lower()
        if name in ("config", "trace_loss", "calibrations", ""):
            continue
        if isinstance(hdu, BinTableHDU):
            component = sparse_flux_component_from_table_hdu(
                hdu=hdu, device=device)
        elif hdu.data is not None:
            component = flux_component_from_image_hdu(hdu=hdu,
                                                       device=device)
        else:
            continue
        flux_components[name] = component
    return flux_components


def npred_calibrations_to_table_hdu(npred_calibrations, name="CALIBRATIONS"):
    """Calibrations -> binary-table HDU (one row per dataset)."""
    data = npred_calibrations.to_dict()
    rows = []
    for cal_name, value in data.items():
        row = {"name": cal_name}
        row.update(value)
        rows.append(row)
    return BinTableHDU.from_rows(rows, name=name)


def npred_calibrations_from_table_hdu(hdu, device=None):
    """Binary-table HDU -> calibrations."""
    from ...models import NPredCalibrations

    columns = hdu.columns
    n = len(columns["name"])
    data = {}
    for i in range(n):
        row = {key: columns[key][i] for key in columns if key != "name"}
        row = {
            key: (bool(v) if isinstance(v, np.bool_) else float(v))
            for key, v in row.items()
        }
        data[str(columns["name"][i])] = row
    return NPredCalibrations.from_dict(data=data, device=device)


def _table_to_hdu(table, name):
    columns = {}
    for col_name in table.colnames:
        values = table[col_name]
        if values.dtype == object:
            columns[col_name] = np.asarray([str(v) for v in values])
        else:
            columns[col_name] = np.asarray(values)
    return BinTableHDU(columns=columns, name=name)


def _config_to_hdu(config, name="CONFIG"):
    columns = {}
    for key, value in config.items():
        if isinstance(value, bool):
            columns[key] = np.asarray([value])
        elif isinstance(value, int):
            columns[key] = np.asarray([value], np.int64)
        elif isinstance(value, float):
            columns[key] = np.asarray([value], np.float64)
        else:
            columns[key] = np.asarray([str(value)])
    return BinTableHDU(columns=columns, name=name)


def _config_from_hdu(hdu):
    config = {}
    for key, values in hdu.columns.items():
        value = values[0]
        if isinstance(value, (np.bool_, bool)):
            config[key] = bool(value)
        elif isinstance(value, (np.integer, int)):
            config[key] = int(value)
        elif isinstance(value, (np.floating, float)):
            config[key] = float(value)
        elif str(value) == "None":
            # _config_to_hdu stringifies non-scalar values; None-valued
            # config entries (scan_chunk, fft_shape, mesh, ...) must
            # read back as None, not the truthy string "None" (the
            # ASDF path preserves None natively)
            config[key] = None
        else:
            config[key] = str(value)
    return config


# ----------------------------------------------------------------------
# public writers / readers

def write_flux_components_to_fits(flux_components, filename, overwrite):
    """Write flux components to a FITS file."""
    hdus = [ImageHDU()]
    hdus.extend(flux_components_to_hdulist(flux_components=flux_components))
    log.info(f"writing {filename}")
    write_hdulist(hdus, filename, overwrite=overwrite)


def read_flux_components_from_fits(filename, device=None):
    """Read flux components from a FITS file."""
    return flux_components_from_hdulist(read_hdulist(filename),
                                        device=device)


def write_flux_component_to_fits(flux_component, filename, overwrite):
    """Write one flux component to a FITS file."""
    if flux_component.is_sparse:
        hdus = [
            sparse_flux_component_to_table_hdu(
                flux_component=flux_component, name="primary"
            )
        ]
    else:
        hdus = [
            flux_component_to_image_hdu(
                flux_component=flux_component, name="primary"
            )
        ]
    log.info(f"writing {filename}")
    write_hdulist(hdus, filename, overwrite=overwrite)


def read_flux_component_from_fits(filename, hdu_name=0, device=None):
    """Read one flux component from a FITS file."""
    hdulist = read_hdulist(filename)
    if isinstance(hdu_name, int):
        # binary tables cannot be the primary HDU, so a sparse
        # component file leads with a data-less primary image — skip
        # HDUs that carry no payload when indexing
        with_data = [
            h for h in hdulist
            if isinstance(h, BinTableHDU) or h.data is not None
        ]
        hdu = with_data[hdu_name]
    else:
        hdu = next(h for h in hdulist if h.name == str(hdu_name).upper())
    if isinstance(hdu, BinTableHDU):
        return sparse_flux_component_from_table_hdu(hdu=hdu, device=device)
    return flux_component_from_image_hdu(hdu=hdu, device=device)


def write_npred_calibrations_to_fits(npred_calibrations, filename, overwrite):
    """Write calibrations to a FITS file."""
    hdu = npred_calibrations_to_table_hdu(npred_calibrations)
    write_hdulist([hdu], filename, overwrite=overwrite)


def read_npred_calibrations_from_fits(filename, device=None):
    """Read calibrations from a FITS file."""
    log.info(f"Reading {filename}")
    hdulist = read_hdulist(filename)
    hdu = next(h for h in hdulist if isinstance(h, BinTableHDU))
    return npred_calibrations_from_table_hdu(hdu, device=device)


def write_map_result_to_fits(result, filename, overwrite):
    """Write a MAP result to FITS."""
    hdus = [ImageHDU()]
    hdus.extend(flux_components_to_hdulist(result.components))

    if result.components_init is not None:
        hdus.extend(
            flux_components_to_hdulist(
                result.components_init, name_suffix=SUFFIX_INIT
            )
        )

    # written independently (like the ASDF path): calibrations_init
    # must not vanish just because the final calibrations are empty
    if result.calibrations:
        hdus.append(npred_calibrations_to_table_hdu(result.calibrations))
    if result.calibrations_init:
        hdus.append(
            npred_calibrations_to_table_hdu(
                result.calibrations_init, name="CALIBRATIONS" + SUFFIX_INIT
            )
        )

    hdus.append(_table_to_hdu(result.trace_loss, name="TRACE_LOSS"))
    hdus.append(_config_to_hdu(result.config))

    log.info(f"writing {filename}")
    write_hdulist(hdus, filename, overwrite=overwrite)


def read_map_result_from_fits(filename, device=None):
    """Read a MAP result from FITS."""
    from ...config import resolve_device
    from ...core import MAPDeconvolverResult
    from ...utils.table import Table

    device = resolve_device(device)
    log.info(f"Reading {filename}")
    hdulist = read_hdulist(filename)
    by_name = {hdu.name: hdu for hdu in hdulist}

    config = _config_from_hdu(by_name["CONFIG"])

    trace_hdu = by_name["TRACE_LOSS"]
    trace_loss = Table.from_dict(
        {key: list(values) for key, values in trace_hdu.columns.items()}
    )

    components = flux_components_from_hdulist(
        [h for h in hdulist if not h.name.endswith(SUFFIX_INIT)],
        device=device,
    )
    components_init = flux_components_from_hdulist(
        [h for h in hdulist if h.name.endswith(SUFFIX_INIT)],
        device=device,
    )

    calibrations = None
    if "CALIBRATIONS" in by_name:
        calibrations = npred_calibrations_from_table_hdu(
            by_name["CALIBRATIONS"], device=device
        )
    calibrations_init = None
    if "CALIBRATIONS" + SUFFIX_INIT in by_name:
        calibrations_init = npred_calibrations_from_table_hdu(
            by_name["CALIBRATIONS" + SUFFIX_INIT], device=device
        )

    return MAPDeconvolverResult(
        config=config,
        components=components,
        components_init=components_init or None,
        calibrations=calibrations,
        calibrations_init=calibrations_init,
        trace_loss=trace_loss,
    )
