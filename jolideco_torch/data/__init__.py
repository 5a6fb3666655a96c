"""Synthetic example datasets (numpy and scipy)."""

from .core import (  # noqa: F401
    disk_source_gauss_psf,
    gauss_and_point_sources_gauss_psf,
    point_source_gauss_psf,
)
