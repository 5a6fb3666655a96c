"""Device meshes and the collectives of the multi-GPU path.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX package
shards its stacked arrays over a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives; the port runs SPMD over ``torch.distributed``
instead. Every rank runs the same program on the same numpy datasets. A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
of the initialised process group, with the named dimensions ``("obs",)``
(:func:`make_obs_mesh`) or ``("obs", "row")``
(``parallel.spatial.make_obs_row_mesh``). A rank keeps its contiguous
block of the observations (:func:`obs_block`) and, on a 2-D mesh, its
block of the image rows; parameters are replicated, and each step ends
with one ``all_reduce`` of the gradients, so that every rank takes the
same optimiser step.

The collectives take CUDA tensors under NCCL and under gloo (several
ranks on one card), CPU tensors under gloo. Three of them are
``torch.autograd.Function`` s, for the modules that differentiate
through a collective:

- :func:`all_reduce_identity`: the sum over the ranks, whose backward is
  the identity, so that each rank's gradient is that of its own term
  and the gradient reduction adds them up (``parallel.prior``);
- :func:`all_to_all`: the tiled all-to-all over a group, whose backward
  is the inverse all-to-all (``ops.dist_fft``);
- :func:`all_gather`: the group's blocks concatenated, whose backward is
  the reduce-scatter, itself differentiable (the row-sharded matrix DFTs
  of ``parallel.stacked``, which the flux-error probe differentiates
  twice).
"""

import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
    "all_reduce_identity",
    "all_reduce_sum",
    "all_to_all",
    "block",
    "broadcast_tensors",
    "check_world_size",
    "init_mesh",
    "make_obs_mesh",
    "mesh_size",
    "mesh_topology",
    "obs_block",
    "replicate",
    "shard_index",
    "shard_stacked",
]


def check_world_size(requested, what):
    """The process group's size, checked to be ``requested`` (``None``:
    any)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what}: torch.distributed is not initialised; start one "
            "process per device (torchrun --nproc-per-node N) and call "
            "torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if requested is None:
        return world
    if requested > world:
        raise ValueError(
            f"{what}: {requested} devices requested but only {world} ranks "
            "in the process group; refusing to silently build a smaller "
            "mesh. Start as many processes as the mesh has devices."
        )
    if requested < world:
        raise ValueError(
            f"{what}: {requested} devices requested but the process group "
            f"has {world} ranks; every rank runs the same program, so the "
            "mesh spans them all"
        )
    return world


def init_mesh(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_obs_mesh(n_devices=None, device_type=None):
    """1-D mesh over an ``obs`` dimension of every rank.

    Parameters
    ----------
    n_devices : int, optional
        Number of ranks (default: the process group's size). Anything but
        the group's size raises ``ValueError``.
    device_type : str, optional
        ``"cuda"`` (default where a card is visible) or ``"cpu"``.
    """
    world = check_world_size(n_devices, "make_obs_mesh")
    return init_mesh((world,), ("obs",), device_type)


def mesh_size(mesh, name):
    """Size of the mesh dimension ``name`` (1 if the mesh has none)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def mesh_topology(mesh):
    """The mesh as the JAX package writes it into a result:
    ``"obs:4"``, ``"obs:2xrow:2"``."""
    return "x".join(f"{name}:{size}"
                    for name, size in zip(mesh.mesh_dim_names, mesh.shape))


def shard_index(mesh):
    """This rank's flat index over every mesh dimension (row-major, as
    the JAX package flattens its axis indices) and the count of shards."""
    index, count = 0, 1
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        index = index * int(size) + int(mesh.get_local_rank(name))
        count *= int(size)
    return index, count


def block(n, n_parts, index):
    """Contiguous block ``index`` of ``n`` items split into ``n_parts``
    blocks whose sizes differ by at most one: a ``slice``."""
    return slice(index * n // n_parts, (index + 1) * n // n_parts)


def obs_block(n_obs, mesh):
    """This rank's contiguous block of ``n_obs`` observations."""
    if "obs" not in mesh.mesh_dim_names:
        return slice(0, n_obs)
    return block(n_obs, mesh_size(mesh, "obs"),
                 int(mesh.get_local_rank("obs")))


def _map_tensors(fn, tree):
    """``fn`` of every tensor in a nest of dicts and tuples (``None``
    stays ``None``), in the nest's shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map_tensors(fn, value) for key, value in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_tensors(fn, value) for value in tree)
    return fn(tree)


def shard_stacked(tree, mesh):
    """This rank's block of the leading (obs) axis of every tensor in a
    nest of dicts and tuples (``None`` stays ``None``), copied, so that
    the whole stack can be freed: the counterpart of the JAX package's
    placement sharded on that axis."""
    return _map_tensors(
        lambda t: t[obs_block(t.shape[0], mesh)].clone(), tree)


def replicate(tree, mesh):
    """Copies of every tensor in a nest of dicts and tuples holding rank
    0's values on every rank of ``mesh`` (which spans the process group):
    the counterpart of the JAX package's replicated placement."""
    copies = _map_tensors(torch.clone, tree)
    leaves = []
    _map_tensors(leaves.append, copies)
    broadcast_tensors(leaves)
    return copies


def all_reduce_sum(tensor, group=None):
    """Sum ``tensor`` over the ranks of ``group`` (default: all), in
    place; returns it."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def broadcast_tensors(tensors, src=0):
    """Overwrite ``tensors`` with rank ``src``'s values, in one
    broadcast of their concatenation."""
    tensors = list(tensors)
    if not tensors or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _AllReduceIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_identity(x, group=None):
    """``x`` summed over the ranks of ``group``; the backward passes the
    cotangent through unchanged, so that each rank's gradient is that of
    its own ``x`` and a sum of the ranks' gradients is the gradient of
    the sum."""
    return _AllReduceIdentity.apply(x, group)


def _all_to_all(x, split_dim, concat_dim, group):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    complex_ = x.is_complex()
    if complex_:
        x = torch.view_as_real(x)
    parts = torch.stack(torch.chunk(x, n, dim=split_dim))
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    y = torch.cat(out.unbind(0), dim=concat_dim)
    return torch.view_as_complex(y) if complex_ else y


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims = (split_dim, concat_dim)
        ctx.group = group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_AllToAll.apply(grad.contiguous(), concat_dim, split_dim,
                                ctx.group), None, None, None)


def _gather(x, dim, group):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    # the rank's block sent to every rank; each receives the blocks in
    # rank order
    return _all_to_all(torch.cat([x] * n, dim=dim), dim, dim, group)


def _reduce_scatter(y, dim, group):
    n = dist.get_world_size(group)
    if n == 1:
        return y
    parts = torch.stack(torch.chunk(y, n, dim=dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return out.sum(0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad.contiguous(), *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.args = (dim, group)
        return _reduce_scatter(y, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllGather.apply(grad.contiguous(), *ctx.args), None, None


def all_gather(x, dim, group):
    """The blocks ``x`` of every rank of ``group`` (of one shape)
    concatenated along ``dim`` (counted from the front) in rank order, on
    every rank. The backward is the reduce-scatter: each rank's
    gradient of the whole summed over the ranks, and this rank's block
    of the sum kept; it is itself differentiable. Both run on
    ``all_to_all_single``, which gloo takes for CUDA tensors too."""
    if dim < 0:
        raise ValueError("all_gather takes a dimension counted from the front")
    return _AllGather.apply(x.contiguous(), dim, group)


def all_to_all(x, split_dim, concat_dim, group):
    """Tiled all-to-all over ``group`` (``jax.lax.all_to_all(...,
    tiled=True)``): ``x`` splits along ``split_dim`` into one chunk per
    rank, chunk ``i`` goes to the group's rank ``i``, and the chunks a
    rank receives are concatenated along ``concat_dim`` in rank order.
    Dimensions count from the front (``>= 0``). Differentiable (the
    backward is the inverse all-to-all), complex tensors included."""
    if split_dim < 0 or concat_dim < 0:
        raise ValueError("all_to_all takes dimensions counted from the front")
    if x.shape[split_dim] % dist.get_world_size(group):
        raise ValueError(
            f"all_to_all: dimension {split_dim} of size "
            f"{x.shape[split_dim]} does not split over "
            f"{dist.get_world_size(group)} ranks"
        )
    return _AllToAll.apply(x.contiguous(), split_dim, concat_dim, group)
