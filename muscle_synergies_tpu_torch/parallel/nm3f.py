"""Mesh-sharded space-by-time (NM3F) factorization: data x time.

Port of :mod:`muscle_synergies_tpu.parallel.nm3f`.  The shared modules
couple every trial, so:

- trials and their coefficients ``A_b`` shard over ``data``; the A
  update is parallel over trials;
- the shared time base ``W`` shards over ``time``: every sum over
  samples (``Wt W``, the A numerators, the S numerator) closes with an
  ``all_reduce`` over ``time``, and the W update, whose output axis is
  time, needs none;
- ``S`` stays replicated; its update reduces over trials and samples;
- the stopping rule is global (one total error, one converged flag),
  the squared errors summed over both axes: every process leaves the
  loop at the same chunk.
"""

from __future__ import annotations

import torch

from .._common import matmul_precision
from ..models.mu import EPSILON, _guard
from ..models.nm3f import NM3FState
from . import _spmd
from .collectives import axis_sum
from .mesh import DATA_AXIS, TIME_AXIS
from .nmf import _run, _wrap_state

__all__ = ["sharded_fit_nm3f"]


def _local_nm3f_step(xb, w, ab, s, data_axis: str, time_axis: str, precision=None):
    """One A-then-W-then-S update of :func:`~..models.nm3f.nm3f_update`,
    trial sums over ``data`` and sample sums over ``time``; xb
    ``(b_loc, t_loc, L)``, w ``(t_loc, P)``, ab ``(b_loc, P, Q)``, s
    ``(Q, L)`` replicated."""
    with matmul_precision(precision):
        wtw = axis_sum(w.T @ w, time_axis)
        sst = s @ s.T
        num_a = axis_sum(torch.einsum("tp,btl,ql->bpq", w, xb, s), time_axis)
        den_a = torch.einsum("pr,brm,mq->bpq", wtw, ab, sst)
        ab = ab * (num_a / _guard(den_a))
        num_w = axis_sum(torch.einsum("btl,ql,bpq->tp", xb, s, ab), data_axis)
        gram_w = axis_sum(torch.einsum("bpq,qm,brm->pr", ab, sst, ab), data_axis)
        w = w * (num_w / _guard(w @ gram_w))
        wtw = axis_sum(w.T @ w, time_axis)
        num_s = axis_sum(axis_sum(torch.einsum("bpq,tp,btl->ql", ab, w, xb),
                                  data_axis), time_axis)
        gram_s = axis_sum(torch.einsum("bpq,pr,brm->qm", ab, wtw, ab), data_axis)
        s = s * (num_s / _guard(gram_s @ s))
    return w, ab, s


def _local_nm3f_error(xb, w, ab, s, data_axis: str, time_axis: str, precision=None):
    """Total Frobenius error, trial and sample sums over both axes."""
    with matmul_precision(precision):
        diff = xb - torch.einsum("tp,bpq,ql->btl", w, ab, s)
    return axis_sum(axis_sum((diff * diff).sum(), data_axis), time_axis).sqrt()


def sharded_fit_nm3f(
    xs, w0, a0, s0, mesh,
    max_iter: int = 500,
    tol: float = 1e-5,
    check_every: int = 10,
    precision=None,
) -> NM3FState:
    """The space-by-time factorization on a ``(data, time)`` mesh.

    Args:
        xs: ``(B, T, L)`` trials, sharded ``(data, time, None)``.
        w0: ``(T, P)`` temporal modules, sharded ``(time, None)``.
        a0: ``(B, P, Q)`` coefficients, sharded over ``data``.
        s0: ``(Q, L)`` spatial modules, replicated.
        precision: matmul precision of every product, the stopping
            checks' included (``None``: full float32).

    Returns:
        :class:`~..models.nm3f.NM3FState` of DTensors with those
        placements; the semantics of :func:`~..models.nm3f.fit_nm3f`
        (global stopping; ``max_iter`` a hard cap, the last chunk cut).

    Raises:
        ValueError: when ``B`` or ``T`` does not divide over its shards.
    """
    for dim, axis, what in ((0, DATA_AXIS, "trial"), (1, TIME_AXIS, "sample")):
        n_shards = _spmd.axis_size(mesh, axis)
        if xs.shape[dim] % n_shards:
            raise ValueError(
                f"{what} count {xs.shape[dim]} must divide over {n_shards} "
                f"{axis} shards"
            )
    specs = ((DATA_AXIS, TIME_AXIS, None), (TIME_AXIS, None), (DATA_AXIS, None, None),
             (None, None))
    xb, w, ab, s = (_spmd.local(a, mesh, sp) for a, sp in zip((xs, w0, a0, s0), specs))
    w, ab, s = (f.to(xb.dtype) for f in (w, ab, s))

    def loop():
        nonlocal w, ab, s
        err0 = _local_nm3f_error(xb, w, ab, s, DATA_AXIS, TIME_AXIS, precision)
        prev = err0
        n_iter, converged = 0, torch.zeros((), dtype=torch.bool, device=xb.device)
        while n_iter < max_iter and not bool(converged):
            steps = min(check_every, max_iter - n_iter)
            for _ in range(steps):
                w, ab, s = _local_nm3f_step(xb, w, ab, s, DATA_AXIS, TIME_AXIS,
                                            precision)
            n_iter += steps
            error = _local_nm3f_error(xb, w, ab, s, DATA_AXIS, TIME_AXIS, precision)
            improvement = (prev - error) / err0.clamp(min=EPSILON)
            converged = (improvement < tol) & (n_iter % check_every == 0)
            prev = error
        count = torch.tensor(n_iter, dtype=torch.int32, device=xb.device)
        return w, ab, s, count, prev, converged

    out = _run(mesh, loop)
    return _wrap_state(NM3FState, out, mesh, specs[1:] + ((), (), ()))
