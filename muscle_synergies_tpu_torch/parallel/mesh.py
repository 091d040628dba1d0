"""Process groups, device meshes and shardings over ``torch.distributed``.

Port of :mod:`muscle_synergies_tpu.parallel.mesh`.  A JAX ``Mesh`` of
devices becomes a :class:`~torch.distributed.device_mesh.DeviceMesh`
of processes (one per card, or per CPU worker) whose dimensions carry
the JAX axis names (``"data"``, ``"time"``, ``"model"``), and a
``NamedSharding`` becomes a :class:`Sharding`: the mesh and one
``Shard``/``Replicate`` placement per mesh dimension, which
``distribute_tensor`` applies.

The process group is NCCL on the card (the default) and gloo with
``device="cpu"``.  A plain single process gets a group of one on an
in-memory store, so library code can build a mesh unconditionally; a
job of several processes is joined through :func:`init_distributed`
(torchrun's environment, or explicit arguments).  On a machine
without a card the default raises instead of falling back to the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
TIME_AXIS = "time"
MODEL_AXIS = "model"

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "MODEL_AXIS",
    "init_distributed",
    "make_mesh",
    "batch_sharding",
    "replicated",
]

# True while the process group is the one-process group that
# init_distributed made on its own (nothing to detect, no arguments)
_ALONE = False


def _kind(device) -> str:
    """``"cpu"`` or ``"cuda"`` (the default, ``device=None``)."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return kind


def _backend(device) -> str:
    """``"gloo"`` for ``device="cpu"``, ``"nccl"`` for the card (the
    default), which must be present."""
    if _kind(device) == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the mesh runs on the card (NCCL) by default; "
            "pass device='cpu' for a gloo group of CPU processes"
        )
    return "nccl"


def _cluster_env_configured() -> bool:
    """True when the environment advertises a job of more than one
    process (torchrun, SLURM, Open MPI); one-process values do not count."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        val = os.environ.get(var, "")
        if val.isdigit() and int(val) > 1:
            return True
    return False


def _torchrun_env() -> bool:
    return all(os.environ.get(v) for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    **kwargs,
) -> int:
    """Join this process to a job of several processes (idempotent).

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` map onto ``init_process_group``'s
    ``init_method="tcp://host:port"``, ``world_size`` and ``rank``; left
    out, they are read from torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` /
    ``RANK``.  With nothing to detect (a plain single process) the group
    is one process on an in-memory store, so library code can call this
    unconditionally.  ``kwargs`` go to ``init_process_group`` (e.g.
    ``timeout``).  The backend is NCCL on the card, the default, and
    gloo for ``device="cpu"``; on the card each process takes the card
    ``LOCAL_RANK`` (or its rank) modulo the card count.

    A later call returns the group's size, unless the group is the
    one-process group made on its own and this call asks for more
    processes (explicitly, or through a cluster environment of several
    processes): then it raises, since going on would run N independent
    single-process jobs.  It also raises when the existing group's
    backend is not the one ``device`` asks for (a gloo group never
    stands in for the card).  A failed NCCL or gloo initialisation
    raises.

    Returns:
        the number of processes in the job.
    """
    import torch.distributed as dist

    global _ALONE
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None or bool(kwargs))
    if dist.is_initialized():
        wants_more = (num_processes is not None and num_processes > 1) or (
            _cluster_env_configured() and not explicit)
        if _ALONE and wants_more:
            raise RuntimeError(
                "init_distributed: this process already runs as a job of one "
                "process (a mesh was built before the job was joined); call "
                "init_distributed before make_mesh"
            )
        want = "gloo" if _kind(device) == "cpu" else "nccl"
        if dist.get_backend() != want:
            raise RuntimeError(
                f"init_distributed: the process group runs on "
                f"{dist.get_backend()!r}, but device={device!r} needs {want!r}; "
                "pass the device the group was made for"
            )
        return dist.get_world_size()
    backend = _backend(device)
    single = (num_processes == 1 and coordinator_address is None) or (
        not explicit and not _torchrun_env())
    if single:
        if not explicit and _cluster_env_configured():
            raise RuntimeError(
                "init_distributed: the environment advertises several "
                "processes but not torchrun's MASTER_ADDR/WORLD_SIZE/RANK; "
                "pass coordinator_address, num_processes and process_id"
            )
        rank, world = 0, 1
        init = dict(store=dist.HashStore(), world_size=1, rank=0)
    else:
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else os.environ["RANK"])
        method = (f"tcp://{coordinator_address}" if coordinator_address is not None
                  else "env://")
        init = dict(init_method=method, world_size=world, rank=rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **init, **kwargs)
    _ALONE = single
    return world


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = (DATA_AXIS, TIME_AXIS),
    devices: Optional[Sequence[int]] = None,
    device=None,
):
    """Build a 2-D ``(data, time)`` mesh over the job's processes.

    Args:
        shape: ``(n_data, n_time)``; defaults to every process on the
            data axis.  Either entry may be ``-1`` to infer it from the
            process count.
        axis_names: names of the two mesh dimensions.
        devices: the global ranks to lay out, in order (default: all of
            the job's processes).  Every process of the job calls this.
        device: ``"cuda"`` (the default; NCCL) or ``"cpu"`` (gloo).  The
            job is joined first if it was not (:func:`init_distributed`);
            a group of the other backend raises.  The sharded functions
            take tensors on this kind of device only.

    Returns:
        a :class:`~torch.distributed.device_mesh.DeviceMesh` whose
        ``mesh_dim_names`` are ``axis_names``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    init_distributed(device=device)
    ranks = list(range(dist.get_world_size())) if devices is None else [
        int(r) for r in devices]
    n_avail = len(ranks)
    if shape is None:
        shape = (n_avail, 1)
    n_data, n_time = shape
    if n_data == -1 and n_time == -1:
        raise ValueError("at most one mesh axis may be -1")
    if n_data == -1 or n_time == -1:
        known = n_time if n_data == -1 else n_data
        if known <= 0 or n_avail % known != 0:
            raise ValueError(
                f"cannot infer mesh shape {shape}: {n_avail} processes "
                f"do not split evenly by {known}"
            )
        n_data, n_time = (
            (n_avail // known, known) if n_data == -1 else (known, n_avail // known)
        )
    if n_data * n_time != n_avail:
        raise ValueError(
            f"mesh shape {(n_data, n_time)} needs {n_data * n_time} "
            f"processes, got {n_avail} (the job's world size is "
            f"{dist.get_world_size()}). Pass shape=(-1, n) to fit the "
            f"available processes, or start {n_data * n_time} of them "
            f"(torchrun --nproc-per-node {n_data * n_time}; on the CPU "
            'with device="cpu", one gloo process each).'
        )
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(n_data, n_time)
    return DeviceMesh(_kind(device), grid, mesh_dim_names=tuple(axis_names))


@dataclass(frozen=True)
class Sharding:
    """A mesh and one placement per mesh dimension (``Shard(d)`` or
    ``Replicate()``): the port's ``NamedSharding``, applied with
    ``torch.distributed.tensor.distribute_tensor``."""

    mesh: object
    placements: tuple

    def apply(self, t: torch.Tensor):
        """``t`` (the same global tensor on every process) as a DTensor
        with these placements; a ``Shard`` of a dimension ``t`` lacks
        becomes ``Replicate``.  ``t`` lies on the mesh's kind of device
        (see :func:`._spmd.on_mesh`)."""
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        from ._spmd import on_mesh

        placements = [p if not isinstance(p, Shard) or p.dim < t.ndim else Replicate()
                      for p in self.placements]
        return distribute_tensor(on_mesh(t, self.mesh), self.mesh, placements)


def batch_sharding(mesh, time_sharded: bool = False) -> Sharding:
    """Sharding for a ``(B, N, L)`` trial batch.

    Trials spread over the ``data`` dimension; with ``time_sharded``
    the sample axis also splits over the ``time`` dimension.
    """
    from torch.distributed.tensor import Replicate, Shard

    def placement(name):
        if name == DATA_AXIS:
            return Shard(0)
        if name == TIME_AXIS and time_sharded:
            return Shard(1)
        return Replicate()

    return Sharding(mesh, tuple(placement(n) for n in mesh.mesh_dim_names))


def replicated(mesh) -> Sharding:
    """Every process holds the whole tensor."""
    from torch.distributed.tensor import Replicate

    return Sharding(mesh, tuple(Replicate() for _ in mesh.mesh_dim_names))
