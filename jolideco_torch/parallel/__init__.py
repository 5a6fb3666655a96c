"""Stacked multi-observation losses."""

from .stacked import StackedPoissonLoss  # noqa: F401
