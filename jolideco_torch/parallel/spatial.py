"""Sharding over observations and image rows.

Counterpart of the JAX package's ``parallel/spatial.py``: for images, or
FFT intermediates, too large for one device, the image grid itself is
split over a second mesh dimension, ``row``. A rank of a 2-D ``(obs,
row)`` mesh keeps its block of the observations, and of those its block
of ``H / R`` image rows (counts, background, exposures at each
component's upsampled resolution). Under ``conv_mode="fft"`` it also
keeps its block of ``(Fw // 2 + 1) / R`` columns of the kernel spectra,
and the convolution runs through the pencil FFT of ``ops.dist_fft``,
whose two all-to-alls over the row group are the only communication of
the forward. Under ``"ct"`` and ``"mxu"`` the JAX package lets GSPMD
partition the matrix DFTs' products; here a transform along the rows
needs every row, so a rank gathers the row group's rows of its
observations (``parallel.mesh.all_gather``, whose backward is the
reduce-scatter), convolves each observation alone and keeps its own rows:
the values and gradients of the unsharded loss, and the whole
convolution's work on every rank of the row group. Parameters stay
replicated: the calibrations' shifts and an upsampled component's grid
act on the whole flux before a rank takes its rows, and a rank's rows of
an upsampled component sum-pool on the rank (``f H / R`` rows start at a
multiple of ``f``).

``"direct"`` is refused (``ValueError``): the JAX package places its
flipped kernels with their rows split over the row dimension, which
fails for every odd kernel size. ``"pfft"`` is refused too; the
deconvolver falls back to ``"fft"`` for it.
"""

from .mesh import block, check_world_size, init_mesh, mesh_size

__all__ = ["make_obs_row_mesh", "shard_stacked_spatial"]


def make_obs_row_mesh(n_obs_shards, n_row_shards, device_type=None):
    """2-D mesh over ``(obs, row)`` dimensions of every rank (rank ``i``
    at ``(i // n_row_shards, i % n_row_shards)``); ``device_type`` as in
    ``parallel.mesh.make_obs_mesh``."""
    check_world_size(n_obs_shards * n_row_shards,
                     f"make_obs_row_mesh({n_obs_shards}x{n_row_shards})")
    return init_mesh((n_obs_shards, n_row_shards), ("obs", "row"),
                     device_type)


def shard_stacked_spatial(stacked, mesh):
    """This rank's copy of a `StackedPoissonLoss` on an ``(obs, row)``
    mesh: its block of the observations (``StackedPoissonLoss.shard``,
    without ``"ct"``'s pairs) and of their image rows, and under
    ``"fft"`` of their spectra's columns.

    Needs ``conv_mode`` ``"fft"``, ``"ct"`` or ``"mxu"`` and the image
    height divisible by the row shards; under ``"fft"`` also the spectrum
    width ``Fw // 2 + 1``: build the loss with
    ``fft_shape=ops.dist_fft.spatial_fft_shape(...)`` (or
    ``row_shards=``).
    """
    mode = stacked.conv_mode
    if mode == "direct":
        raise ValueError(
            "conv_mode='direct' does not partition over a row (spatial) "
            "mesh: the JAX package splits its odd-sized kernels' rows over "
            "the row dimension, which fails; use 'fft', 'ct' or 'mxu'"
        )
    if mode not in ("fft", "ct", "mxu"):
        raise ValueError(
            f"conv_mode={mode!r} does not partition over a row (spatial) "
            "mesh; build the loss with conv_mode='fft', 'ct' or 'mxu'"
        )
    n_rows = mesh_size(mesh, "row")
    fwh = stacked.fft_shape[1] // 2 + 1
    h = int(stacked.counts.shape[-2])
    if h % n_rows or (mode == "fft" and fwh % n_rows):
        raise ValueError(
            f"conv_mode={mode!r} on a {n_rows}-row mesh needs the image "
            f"height ({h})"
            + (f" and the spectrum width Fw//2+1 ({fwh})" if mode == "fft"
               else "")
            + " divisible by the row shards; build with "
            "fft_shape=ops.dist_fft.spatial_fft_shape(...)"
        )
    new = stacked.shard(mesh)
    new.ct_pairs = None
    index = int(mesh.get_local_rank("row"))
    rows, cols = block(h, n_rows, index), block(fwh, n_rows, index)
    new.counts = new.counts[..., rows, :].clone()
    new.background = new.background[..., rows, :].clone()
    new.exposures = {
        name: new.exposures[name][..., f * rows.start:f * rows.stop, :]
        .clone()
        for name, f in zip(stacked.component_names,
                           stacked.component_factors)}
    if mode == "fft":
        new.psf_ffts = {name: kft[..., cols].clone()
                        for name, kft in new.psf_ffts.items()}
    new.row_slice, new.row_shards = rows, n_rows
    return new
