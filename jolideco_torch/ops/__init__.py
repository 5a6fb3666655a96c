"""Tensor ops: FFT convolution, image ops, patches and the GMM kernels."""

from .fft import (  # noqa: F401
    convolve_fft,
    convolve_fft_precomputed,
    fft_conv_shape,
    good_fft_size,
    kernel_fft,
)
from .gmm_score import GMMArrays, gmm_log_prob_matrix, gmm_score  # noqa: F401
from .image import (  # noqa: F401
    avg_pool,
    cycle_spin,
    cycle_spin_interp,
    cycle_spin_subpixel,
    grid_weights,
    interp1d,
    maybe_rescale_image,
    rescale_image,
    shift_image,
    sum_pool,
    upsample_bilinear,
)
from .linalg import compute_precision_cholesky  # noqa: F401
from .patches import (  # noqa: F401
    evaluate_trapez,
    extract_patches_at,
    get_pixel_weights,
    reconstruct_from_overlapping_patches,
    view_as_overlapping_patches,
    view_as_random_overlapping_patches,
)
