"""Trial batching and host->device feeding.

Port of :mod:`muscle_synergies_tpu.io.batch`: ragged trials become one
padded ``(B, N, L)`` tensor with a ``(B, N)`` mask
(:func:`stack_trials`, :func:`batch_iterator`), and
:func:`device_prefetch` stages upcoming items on the device from a
producer thread while the consumer computes on the current one.

On the card the staging is asynchronous for real: the producer copies
each host array into pinned memory (or takes a pinned tensor as it is),
issues the host->device copy on a side CUDA stream that it makes
current in its own thread, and records an event after it.  The consumer
makes its current stream wait on that event before it yields the item,
marks every staged tensor as used by its stream (``record_stream``, so
the caching allocator cannot hand the memory to the next item while the
consumer's kernels still read it) and keeps the pinned sources alive
until the copy has completed.  With ``device="cpu"`` the same thread
and bounded queue run with no streams.

``sharding=`` (a :class:`~muscle_synergies_tpu_torch.parallel.mesh.Sharding`
of ``parallel.batch_sharding`` or ``parallel.replicated``) places each
staged tensor on a device mesh with ``distribute_tensor``: every process
of the job passes the same trials and holds its shard of the result.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass, replace
from typing import Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._common import entry_placement
from ..models.batch import pad_and_stack

__all__ = ["TrialBatch", "stack_trials", "batch_iterator", "device_prefetch"]

@dataclass
class TrialBatch:
    """A padded batch of trials ready for the batched solvers.

    Attributes:
        data: ``(B, N, L)`` padded measurements (a tensor).
        mask: ``(B, N)`` validity mask (1 = real sample), same dtype.
        lengths: original per-trial lengths (NumPy, on the host).
        names: optional per-trial identifiers.
    """

    data: torch.Tensor
    mask: torch.Tensor
    lengths: np.ndarray
    names: Optional[List[str]] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


def stack_trials(
    trials: Sequence[np.ndarray],
    pad_to: Optional[int] = None,
    names: Optional[Sequence[str]] = None,
    sharding=None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> TrialBatch:
    """Pad/stack ragged trials and place them on the device.

    Args:
        trials: ``(N_i, L)`` arrays sharing the channel count.
        pad_to: pad every trial to this length (defaults to the max).
        names: one identifier per trial.
        sharding: optional ``parallel`` sharding: ``data`` and ``mask``
            become DTensors placed by it (a ``Shard`` of a dimension the
            mask lacks replicates it).
        dtype, device: where the batch goes: the card by default, in
            float32 there unless ``dtype`` says otherwise; with
            ``device="cpu"``, ``dtype=None`` keeps the trials' dtype.
    """
    if names is not None and len(names) != len(trials):
        raise ValueError(f"got {len(names)} names for {len(trials)} trials")
    device, dtype = entry_placement(device, dtype)
    data, mask = pad_and_stack([np.asarray(t) for t in trials], pad_to=pad_to)
    data = torch.as_tensor(data).to(device=device, dtype=dtype)
    mask = torch.as_tensor(mask).to(device=device, dtype=data.dtype)
    if sharding is not None:
        data, mask = sharding.apply(data), sharding.apply(mask)
    return TrialBatch(
        data=data,
        mask=mask,
        lengths=np.array([t.shape[0] for t in trials]),
        names=list(names) if names is not None else None,
    )


def batch_iterator(
    trials: Sequence[np.ndarray],
    batch_size: int,
    pad_to: Optional[int] = None,
    drop_remainder: bool = False,
    names: Optional[Sequence] = None,
    **stack_kwargs,
) -> Iterator[TrialBatch]:
    """Yield :class:`TrialBatch` chunks of ``batch_size`` trials.

    ``names`` (one per trial) is sliced alongside the trials so every
    batch's ``names[i]`` labels its own ``data[i]``; ``stack_kwargs``
    go to :func:`stack_trials` (``dtype``, ``device``).
    """
    if names is not None and len(names) != len(trials):
        raise ValueError(f"got {len(names)} names for {len(trials)} trials")
    if pad_to is None:
        pad_to = max(t.shape[0] for t in trials)
    for start in range(0, len(trials), batch_size):
        chunk = trials[start : start + batch_size]
        if drop_remainder and len(chunk) < batch_size:
            return
        chunk_names = names[start : start + batch_size] if names is not None else None
        yield stack_trials(chunk, pad_to=pad_to, names=chunk_names, **stack_kwargs)


def _tree_map(fn, item):
    """``fn`` on every array or tensor leaf of lists, tuples (named ones
    too), dicts and :class:`TrialBatch` (its ``data`` and ``mask``; its
    ``lengths`` and ``names`` stay host metadata); other leaves pass."""
    if isinstance(item, TrialBatch):
        return replace(item, data=fn(item.data), mask=fn(item.mask))
    if isinstance(item, dict):
        return type(item)((k, _tree_map(fn, v)) for k, v in item.items())
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(_tree_map(fn, v) for v in item))
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_map(fn, v) for v in item)
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    return item


def _host_tensor(a) -> torch.Tensor:
    """A leaf as a CPU tensor (a NumPy array without a copy)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class _Staged(NamedTuple):
    """An item on its way to the card: the item with its leaves on the
    device, the event recorded after their copies on the side stream,
    and the pinned host sources that must outlive those copies."""

    item: object
    event: Optional[torch.cuda.Event]
    sources: Sequence[torch.Tensor]


def device_prefetch(
    iterable: Iterable,
    buffer_size: int = 2,
    sharding=None,
    device="cuda",
) -> Iterator:
    """Asynchronously stage upcoming items onto the device.

    A background thread pulls from ``iterable`` and stages each item's
    arrays and CPU tensors on ``device``, at most ``buffer_size`` items
    ahead of the consumer (a bounded queue), so host-side parsing and
    padding and the host->device copy overlap device compute on the
    current item.  An exception in the producer is raised again in the
    consumer; a consumer that stops early releases the producer.

    On the card each leaf is copied into pinned memory (a pinned CPU
    tensor is used as it is), sent with ``non_blocking=True`` on a side
    stream, and the consumer's stream waits on the copy's event before
    the item is yielded.  ``device="cpu"`` turns NumPy leaves into CPU
    tensors (no copy) and runs no streams.  With ``sharding`` (a
    ``parallel`` sharding) each staged tensor becomes a DTensor placed
    by it, in the consumer's thread, so its collectives keep the
    program order of every process.
    """
    device, _ = entry_placement(device, None)
    on_card = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _END = object()
    _ERROR = object()
    stop = threading.Event()

    def offer(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(item, stream) -> _Staged:
        if not on_card:
            return _Staged(_tree_map(_host_tensor, item), None, ())
        sources = []

        def to_card(leaf):
            host = _host_tensor(leaf)
            if host.is_cuda:
                return host
            if not host.is_pinned():
                pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                pinned.copy_(host)
                host = pinned
            sources.append(host)
            return host.to(device, non_blocking=True)

        with torch.cuda.stream(stream):
            staged = _tree_map(to_card, item)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(staged, event, sources)

    def producer():
        try:
            # a stream made current here is current in this thread only
            stream = torch.cuda.Stream(device) if on_card else None
            for item in iterable:
                if not offer(stage(item, stream)):
                    return  # consumer abandoned the generator
        except BaseException as exc:  # propagate to the consumer
            offer((_ERROR, exc))
        else:
            offer(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    in_flight: deque = deque()  # (event, pinned sources) until the copy ends
    try:
        while True:
            got = q.get()
            if got is _END:
                break
            if isinstance(got, tuple) and len(got) == 2 and got[0] is _ERROR:
                raise got[1]
            if got.event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(got.event)
                _tree_map(lambda t: t.record_stream(current) if t.is_cuda else None,
                          got.item)
                in_flight.append((got.event, got.sources))
                while in_flight and in_flight[0][0].query():
                    in_flight.popleft()
            if sharding is not None:
                yield _tree_map(lambda t: sharding.apply(_host_tensor(t)), got.item)
                continue
            yield got.item
    finally:
        # unblock the producer on early exit (break / GeneratorExit) so
        # it releases the upstream iterator's resources
        stop.set()
        for event, _ in in_flight:
            event.synchronize()
