"""A pool of gloo processes for the PyTorch port's multi-process tests.

The port's sharded functions run SPMD: every process of a job calls them
with the same global inputs.  :class:`MeshPool` starts ``world`` worker
processes (spawned, one torch thread each) that join one gloo process
group through ``parallel.init_distributed`` and then serve calls from
a queue: each call names a function of the port, its arguments (NumPy
arrays become float64 tensors; the string ``"MESH"`` becomes the mesh
the call asks for) and returns, from every rank, the result with each
tensor and DTensor gathered to a NumPy array.  A call that does not
come back from every rank in time (a deadlock in a collective, say)
fails, and the pool is torn down and started again for the next call.

This module imports torch and the port only: the workers never import
JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import queue
import socket
import traceback
from datetime import timedelta

import numpy as np
import pytest

MESH = "MESH"


@pytest.fixture(autouse=True)
def no_leftover_group():
    """Tear down, after each test of a module that imports this, a
    process group the test made in the test process (``make_mesh(...,
    device="cpu")`` makes a one-process gloo group), so no later test
    inherits it."""
    yield
    import torch.distributed as dist

    from muscle_synergies_tpu_torch.parallel import mesh

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    mesh._ALONE = False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(obj):
    """Tensors, DTensors and the containers of the port's results as
    NumPy (dicts for NamedTuples and dataclasses)."""
    import torch

    from muscle_synergies_tpu_torch.parallel._spmd import full

    if isinstance(obj, torch.Tensor):
        return full(obj).detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: _to_host(v) for k, v in zip(obj._fields, obj)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_host(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if hasattr(obj, "__dict__") and type(obj).__module__.startswith("muscle_"):
        return {k: _to_host(v) for k, v in vars(obj).items()}
    return obj


def _resolve(name: str):
    """A function of the port (``"parallel.sharded_fit_mu"``) or of this
    module (``"pool.probe_collectives"``)."""
    module, attr = name.rsplit(".", 1)
    if module == "pool":
        return globals()[attr]
    return getattr(importlib.import_module("muscle_synergies_tpu_torch." + module), attr)


def probe_collectives(mesh):
    """Every collective of ``parallel.collectives`` over both mesh axes,
    on a tensor that names its process: ``x[i] = 100 * rank + i``."""
    import torch

    from muscle_synergies_tpu_torch.parallel import _spmd, collectives as c

    rank = torch.distributed.get_rank()
    x = 100.0 * rank + torch.arange(3, dtype=torch.float64)
    before = x.clone()
    out = {}
    with _spmd.bound(mesh):
        for axis in mesh.mesh_dim_names:
            out[axis] = dict(
                sum=c.axis_sum(x, axis), gather=c.gather_time(x, axis),
                index=c.axis_index(axis), size=c.axis_size(axis),
                ring=c.ring_shift(x, axis), ring_back=c.ring_shift(x, axis, -1),
                edge=c.edge_shift(x, axis), edge_back=c.edge_shift(x, axis, -1),
                varying=c.mark_varying(x, axis),
            )
    out["rank"], out["untouched"] = rank, bool(torch.equal(x, before))
    out["coordinate"] = list(mesh.get_coordinate())
    return out


def _worker(rank: int, world: int, port: int, inbox, outbox) -> None:
    import torch

    torch.set_num_threads(1)
    from muscle_synergies_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout=timedelta(seconds=90))
    meshes = {}

    def mesh_for(spec):
        shape, names = spec
        key = (tuple(shape), tuple(names))
        if key not in meshes:
            meshes[key] = make_mesh(tuple(shape), tuple(names), device="cpu")
        return meshes[key]

    def arg(value, mesh):
        if isinstance(value, str) and value == MESH:
            return mesh
        if isinstance(value, np.ndarray) and value.dtype.kind == "f":
            return torch.as_tensor(value)
        return value

    while True:
        task = inbox.get()
        if task is None:
            break
        try:
            mesh = mesh_for(task["mesh"]) if task.get("mesh") else None
            fn = _resolve(task["fn"])
            args = [arg(a, mesh) for a in task.get("args", ())]
            kwargs = {k: arg(v, mesh) for k, v in task.get("kwargs", {}).items()}
            out = _to_host(fn(*args, **kwargs))
            outbox.put((rank, True, out))
        except BaseException:  # noqa: BLE001 - reported to the test
            outbox.put((rank, False, traceback.format_exc()))


class MeshPool:
    """``world`` gloo processes serving :meth:`call`."""

    def __init__(self, world: int = 4, timeout: float = 120.0):
        self.world, self.timeout = world, timeout
        self._procs = []

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = _free_port()
        self._inbox = [ctx.Queue() for _ in range(self.world)]
        self._outbox = ctx.Queue()
        env = dict(os.environ)
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self._procs = [ctx.Process(target=_worker, daemon=True,
                                       args=(r, self.world, port, self._inbox[r],
                                             self._outbox))
                           for r in range(self.world)]
            for p in self._procs:
                p.start()
        finally:
            os.environ.clear()
            os.environ.update(env)

    def call(self, fn: str, *args, on=None, timeout=None, **kwargs):
        """Run ``muscle_synergies_tpu_torch.<fn>(*args, **kwargs)`` on every
        rank; ``on=((n_data, n_other), axis_names)`` builds the mesh that
        ``"MESH"`` in the arguments stands for.  Returns each rank's result."""
        if not self._procs:
            self._start()
        task = dict(fn=fn, args=args, kwargs=kwargs, mesh=on)
        for box in self._inbox:
            box.put(task)
        got, errors = {}, []
        deadline = timeout or self.timeout
        try:
            while len(got) + len(errors) < self.world:
                rank, ok, out = self._outbox.get(timeout=deadline)
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break  # the other ranks may wait in a collective
        except queue.Empty:
            self.close()
            raise AssertionError(
                f"{fn}: {self.world - len(got)} of {self.world} ranks did not "
                f"return within {deadline} s (a hang in a collective?)") from None
        if errors:
            self.close()
            raise AssertionError(f"{fn} raised:\n" + "\n".join(errors))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for box in getattr(self, "_inbox", ()):
            try:
                box.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []


def filter_a_dtensor(sos, x, mesh):
    """``sharded_sosfiltfilt`` of ``x`` placed on the mesh as a DTensor
    sharded over time first."""
    from muscle_synergies_tpu_torch.parallel import sharded_sosfiltfilt
    from muscle_synergies_tpu_torch.parallel._spmd import local, wrap

    placed = wrap(local(x, mesh, ("time", None)), mesh, ("time", None))
    return sharded_sosfiltfilt(sos, placed, mesh)


def stack_sharded(trials, mesh, time_sharded):
    """``io.stack_trials`` placed by ``parallel.batch_sharding``: the
    gathered batch and each tensor's placements."""
    from muscle_synergies_tpu_torch.io.batch import stack_trials
    from muscle_synergies_tpu_torch.parallel import batch_sharding

    batch = stack_trials(trials, sharding=batch_sharding(mesh, time_sharded),
                         device="cpu")
    return dict(data=batch.data, mask=batch.mask, lengths=batch.lengths,
                placements=[str(batch.data.placements), str(batch.mask.placements)],
                local=tuple(batch.data.to_local().shape))


def prefetch_sharded(items, mesh):
    """``io.device_prefetch`` of ``items`` placed by ``batch_sharding``."""
    from muscle_synergies_tpu_torch.io.batch import device_prefetch
    from muscle_synergies_tpu_torch.parallel import batch_sharding

    staged = list(device_prefetch(iter(items), 2, sharding=batch_sharding(mesh),
                                  device="cpu"))
    return [dict(full=s, local=tuple(s.to_local().shape)) for s in staged]


def orbax_roundtrip(directory, arrays, meta):
    """Every rank saves the same key to an ``orbax`` store, then loads it."""
    from muscle_synergies_tpu_torch.utils.checkpoint import GridCheckpoint

    store = GridCheckpoint(directory, backend="orbax")
    store.save("chunk_0", arrays, meta=meta)
    return store.completed_keys(), store.load("chunk_0")


def with_warnings(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of the port and the messages of the warnings
    it raised."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = _resolve(fn)(*args, **kwargs)
    return out, [str(w.message) for w in caught if issubclass(w.category, UserWarning)]


def fit_dtensors(x, w, h, mesh):
    """``sharded_fit_mu`` of DTensor inputs: ``x`` and ``w`` placed as the
    function shards them, ``h`` replicated (so it is redistributed)."""
    from muscle_synergies_tpu_torch.parallel import replicated, sharded_fit_mu
    from muscle_synergies_tpu_torch.parallel._spmd import local, wrap

    spec = ("data", "time", None)
    placed = [wrap(local(a, mesh, spec), mesh, spec) for a in (x, w)]
    return sharded_fit_mu(*placed, replicated(mesh).apply(h), mesh, max_iter=30,
                          tol=0.0)
