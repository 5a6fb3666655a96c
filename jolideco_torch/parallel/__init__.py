"""Stacked multi-observation losses and their meshes over several
devices (``torch.distributed``)."""

from ..ops.dist_fft import spatial_fft_shape  # noqa: F401
from .mesh import make_obs_mesh, obs_block, shard_stacked  # noqa: F401
from .prior import sharded_prior_fn  # noqa: F401
from .spatial import make_obs_row_mesh, shard_stacked_spatial  # noqa: F401
from .stacked import DataValidationError, StackedPoissonLoss  # noqa: F401
