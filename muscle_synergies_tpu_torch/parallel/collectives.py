"""Named collective operations used by the sharded solvers and filters.

Port of :mod:`muscle_synergies_tpu.parallel.collectives`, on
``torch.distributed``.  Each function runs inside a sharded function of
this package, which binds its mesh (``_spmd.bound``); ``axis_name``
names a mesh dimension, whose process group carries the operation.
The results are new tensors: like JAX's ``psum``, nothing reduces a
caller's tensor in place.
"""

from __future__ import annotations

import torch

from . import _spmd

__all__ = [
    "axis_sum",
    "time_sum",
    "gather_time",
    "axis_index",
    "axis_size",
    "ring_shift",
    "edge_shift",
    "mark_varying",
]


def _group(axis_name: str):
    mesh = _spmd.current()
    return mesh, _spmd.axis_dim(mesh, axis_name)


def axis_sum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum of every process's ``x`` over a mesh axis (``all_reduce``).

    Used for the time-reduced Grams of the sharded NMF solvers, the
    channel-reduced ones of the tensor-parallel solvers, and the
    stopping statistics.
    """
    import torch.distributed as dist

    mesh, dim = _group(axis_name)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(dim))
    return out


# historical name from the sequence-parallel solvers
time_sum = axis_sum


def gather_time(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Every process's ``x`` over a mesh axis, stacked on a new leading
    axis in the axis's order (``all_gather``'s layout).

    Used for the block states of the sequence-parallel filters.
    """
    import torch.distributed as dist

    mesh, dim = _group(axis_name)
    n = mesh.size(dim)
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty((n * flat.numel(),))
    # all_gather_into_tensor's newer name, where the installed torch has it
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, flat, group=mesh.get_group(dim))
    return out.reshape((n,) + tuple(x.shape))


def axis_index(axis_name: str) -> int:
    """This process's position along a mesh axis."""
    mesh, dim = _group(axis_name)
    return mesh.get_local_rank(dim)


def axis_size(axis_name: str) -> int:
    """Number of processes along a mesh axis."""
    mesh, dim = _group(axis_name)
    return mesh.size(dim)


def _exchange(x: torch.Tensor, axis_name: str, dest, src) -> torch.Tensor:
    """Send ``x`` to position ``dest`` and receive from ``src`` along
    the axis (``None``: no partner); zeros where nothing arrives."""
    import torch.distributed as dist

    mesh, dim = _group(axis_name)
    me = mesh.get_local_rank(dim)
    x = x.contiguous()
    out = torch.zeros_like(x)
    if dest == me and src == me:
        return out.copy_(x)
    group = mesh.get_group(dim)
    ops = []
    if dest is not None:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dest), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def ring_shift(x: torch.Tensor, axis_name: str, shift: int = 1) -> torch.Tensor:
    """Rotate shards around a mesh axis: position ``i`` receives the
    shard of ``i - shift`` (modulo the axis size)."""
    n, me = axis_size(axis_name), axis_index(axis_name)
    return _exchange(x, axis_name, (me + shift) % n, (me - shift) % n)


def edge_shift(x: torch.Tensor, axis_name: str, shift: int = 1) -> torch.Tensor:
    """Shift shards along a mesh axis without wraparound: position ``i``
    receives the shard of ``i - shift``, and a position with no source
    receives zeros, the zero-padded boundary of the convolutive model's
    causal shifts.  Used for the lag halos of the sequence-parallel
    convolutive NMF and the moving RMS."""
    n, me = axis_size(axis_name), axis_index(axis_name)
    dest, src = me + shift, me - shift
    return _exchange(x, axis_name, dest if 0 <= dest < n else None,
                     src if 0 <= src < n else None)


def mark_varying(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The identity: JAX marks loop carries as varying over a mesh axis
    for ``shard_map``'s type check, which torch does not have."""
    return x
