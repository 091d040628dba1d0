"""The port's ``shard_map``: local shards in, DTensors out.

A sharded function of this package takes plain tensors (the same
global tensor on every process) or DTensors, runs its body on this
process's shards, and returns its fields as DTensors whose placements
are the JAX function's ``out_specs``, so ``.full_tensor()`` is the
JAX function's global array.  A spec is a tuple over a tensor's
dimensions: ``None`` (whole), an axis name, or a tuple of axis names
(sharded over those mesh dimensions together, the first one major).
Every sharding here is even: a dimension that does not divide raises,
as ``shard_map`` does.  The work runs where the caller's tensors lie: a
tensor on another kind of device than the mesh's raises rather than
being moved there.

While a body runs, :func:`bound` holds the mesh in a context variable,
so :mod:`.collectives` resolves an axis name to its process group.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Sequence

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def bound(mesh) -> Iterator[None]:
    """Make ``mesh`` the one the collectives' axis names refer to."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def current():
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError(
            "collectives run inside a sharded function (no mesh is bound)"
        )
    return mesh


def axis_dim(mesh, name: str) -> int:
    """The mesh dimension named ``name``."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise KeyError(f"mesh {tuple(names)} has no axis {name!r}")
    return names.index(name)


def axis_size(mesh, name: str) -> int:
    return mesh.size(axis_dim(mesh, name))


def mesh_device(mesh) -> torch.device:
    """The device this process computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def on_mesh(x, mesh, name: str = "input") -> torch.Tensor:
    """``x`` on this process's device for ``mesh``.  A tensor on another
    kind of device raises (a mesh of CPU processes never computes on
    card tensors, nor the reverse); array-likes are placed there."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, torch.Tensor):
        if x.device.type != mesh.device_type:
            raise ValueError(
                f"{name} lies on {x.device.type!r} but the mesh's processes "
                f"compute on {mesh.device_type!r}: build the mesh with "
                f"make_mesh(..., device={x.device.type!r}) or move the tensor"
            )
        return x if isinstance(x, DTensor) else x.to(mesh_device(mesh))
    return torch.as_tensor(x, device=mesh_device(mesh))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: Sequence) -> list:
    """One placement per mesh dimension for a tensor with ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            out[axis_dim(mesh, name)] = Shard(dim)
    return out


def _shard_of(mesh, entry):
    """``(index, count)`` of this process's shard along a tensor
    dimension with spec ``entry``."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for name in _names(entry):
        dim = axis_dim(mesh, name)
        index = index * mesh.size(dim) + coord[dim]
        count *= mesh.size(dim)
    return index, count


def local(x, mesh, spec: Sequence, name: str = "input") -> torch.Tensor:
    """This process's shard of ``x`` (a global tensor or a DTensor), on
    the mesh's device (:func:`on_mesh`)."""
    from torch.distributed.tensor import DTensor

    x = on_mesh(x, mesh, name)
    if isinstance(x, DTensor):
        want = placements(mesh, spec)
        if list(x.placements) != want:
            x = x.redistribute(mesh, want)
        shape = tuple(x.shape)
        out = x.to_local()
    else:
        out = x
        shape = tuple(out.shape)
        for dim, entry in enumerate(spec):
            index, count = _shard_of(mesh, entry)
            if count > 1:
                size = shape[dim] // count
                out = out.narrow(dim, index * size, size)
    for dim, entry in enumerate(spec):
        count = _shard_of(mesh, entry)[1]
        if shape[dim] % count:
            raise ValueError(
                f"{name}: dimension {dim} of shape {shape} does not divide "
                f"over the mesh's {count} shards of {_names(entry)}"
            )
    return out.contiguous()


def wrap(t: torch.Tensor, mesh, spec: Sequence, shape: Optional[Sequence[int]] = None):
    """A local shard as a DTensor with ``spec``; ``shape`` is the global
    shape (default: the local one times the shard counts)."""
    from torch.distributed.tensor import DTensor

    if shape is None:
        shape = list(t.shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= _shard_of(mesh, entry)[1]
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, placements(mesh, spec),
                              run_check=False, shape=shape, stride=stride)


def full(x) -> torch.Tensor:
    """The global tensor of a DTensor (a plain tensor passes)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    if x.dtype == torch.bool:  # gathered as bytes: not every backend takes bool
        return x.to(torch.uint8).full_tensor().bool()
    return x.full_tensor()


def usable_mesh(mesh, caller: str, n: Optional[int] = None,
                halo: Optional[int] = None, *, what: str = "trial length",
                then: str = "local single-device solver", hint: str = ""):
    """``mesh`` when a meshed path of ``caller`` can take it, else
    ``None`` after a warning in the JAX package's words, for the
    caller's local path.

    The mesh must carry the ``(data, time)`` axes; given the sample
    count ``n``, its time axis must divide ``n`` and, given a lag
    ``halo``, one time shard must cover it.  ``what`` names ``n`` in the
    warning, ``then`` the path taken instead, and ``hint`` is appended.
    """
    import warnings

    from .mesh import DATA_AXIS, TIME_AXIS

    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    missing = {DATA_AXIS, TIME_AXIS} - set(names)
    if missing:
        reason = (f"mesh {names} lacks the {sorted(missing)} axis "
                  "(a (data, time) mesh is required)")
    else:
        n_time = axis_size(mesh, TIME_AXIS)
        if n is None or (n % n_time == 0 and (halo or 0) <= n // n_time):
            return mesh
        axis = f"the mesh's {n_time}-way time axis"
        if halo is None:
            reason = f"{what} {n} does not divide over {axis}"
        elif halo:
            reason = (f"{what} {n} must divide over {axis} with one shard "
                      f"covering the lag halo ({halo})")
        else:
            reason = f"{what} {n} must divide over {axis}"
    warnings.warn(f"{caller}: {reason}; falling back to the {then}.{hint}",
                  stacklevel=3)
    return None


def pad_fits(n_shards: int, *arrays):
    """``arrays`` with copies of their first fit appended until the
    leading (fit) axis divides ``n_shards``: every fit is independent,
    so the copies change nothing, and :func:`gathered` drops them."""
    pad = (-arrays[0].shape[0]) % n_shards
    if not pad:
        return arrays
    return tuple(torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) for a in arrays)


def gathered(state, n_fits: int):
    """A sharded solver's NamedTuple of DTensors as whole tensors, the
    padded fits dropped."""
    return type(state)(*(full(f)[:n_fits] for f in state))


def gather_fits(mesh, fn, *arrays):
    """``fn`` on the leading (fit) axis of ``arrays`` split over every
    process of ``mesh``, gathered back (:func:`pad_fits`).  ``fn``
    returns a NamedTuple of tensors with that leading axis."""
    n_fits = arrays[0].shape[0]
    spec = (tuple(mesh.mesh_dim_names),)
    arrays = pad_fits(mesh.size(), *arrays)
    out = fn(*(local(a, mesh, spec + (None,) * (a.ndim - 1)) for a in arrays))
    return gathered(type(out)(*(wrap(f, mesh, spec + (None,) * (f.ndim - 1))
                                for f in out)), n_fits)
