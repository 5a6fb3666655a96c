"""The prior's work split over a mesh.

Counterpart of the JAX package's ``parallel/prior.py``. The GMM patch
prior is a function of the replicated flux alone, so on a mesh every
rank would score every patch. Instead each rank evaluates
``Prior.shard_partial(flux, ..., n_shards, shard_index)`` with its flat
index over all the mesh's dimensions: for the GMM patch prior one
contiguous strip block of its patches
(``ops.gmm_fused.gmm_score_fused_partial_sum``), for a prior without a
split form the whole value over ``n_shards``. One ``all_reduce`` gives
every rank the scalar; its backward is the identity, so each rank's
gradient is that of its own part, and the gradient reduction of the
training step adds the parts up. The draws (cycle spins, jitter) must be
the same on every rank: the run draws them from one generator seeded
alike on every rank.
"""

from .mesh import all_reduce_identity, shard_index

__all__ = ["sharded_prior_fn"]


def sharded_prior_fn(mesh):
    """Build ``fn(prior_loss, fluxes, params=None, shifts=None) ->
    scalar``: the summed log-prior of ``loss.PriorLoss`` with each prior's
    work split over every rank of ``mesh`` (which spans the process
    group), the value the same on every rank. ``shifts`` (the priors'
    draws, ``PriorLoss.draw_shifts``) must be given, and alike on every
    rank."""
    index, n_shards = shard_index(mesh)

    def fn(prior_loss, fluxes, params=None, shifts=None):
        if shifts is None:
            raise ValueError(
                "sharded_prior_fn requires the priors' draws (shifts=), "
                "identical on every rank"
            )
        values = prior_loss.evaluate_sharded(
            fluxes, params=params, shifts=shifts, n_shards=n_shards,
            shard_index=index)
        return all_reduce_identity(sum(values))

    return fn
