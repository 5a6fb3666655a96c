"""Stacked multi-observation losses."""

from .stacked import DataValidationError, StackedPoissonLoss  # noqa: F401
