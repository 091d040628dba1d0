"""Sequence-parallel convolutive NMF over a ``(data, time)`` mesh.

Port of :mod:`muscle_synergies_tpu.parallel.cnmf`.  The convolution
couples neighbouring time shards only through ``D - 1`` rows (the lag
depth), so the sharding is a halo exchange:

- the lag stack ``Cs[d, t] = C[t-d]`` needs the left neighbour's last
  ``D-1`` activation rows (:func:`~.collectives.edge_shift`, zeros at
  the global edge: the causal zero padding of the local model);
- the S update's numerators and denominators are time reductions,
  local contributions and one ``all_reduce`` pair, after which every
  process of a time group holds the same synergies;
- the C update's lag sums read ``D-1`` rows ahead, the right
  neighbour's first rows of X and of the reconstruction: one
  right-halo exchange of each.

The loop is the sharded solvers' (:func:`~..models.mu.fit_chunked`):
per-fit stopping every ``check_every`` iterations, the last chunk cut
at ``max_iter``.  Plain PyTorch, batched over the local fits.
"""

from __future__ import annotations

import functools

import torch

from .._common import matmul_precision
from ..models.cnmf import CNMFState, _lag_stack
from ..models.mu import _guard, fit_chunked
from . import _spmd
from .collectives import axis_sum, edge_shift, time_sum
from .mesh import DATA_AXIS, MODEL_AXIS, TIME_AXIS
from .nmf import _run, _wrap_state

__all__ = ["sharded_fit_cnmf", "sharded_fit_cnmf_tp"]

_B = (DATA_AXIS,)


def _lag_stack_sharded(c, n_lags: int, axis_name: str):
    """This shard's slice of the global lag stack:
    ``(b, t_loc, K) -> (b, D, t_loc, K)``, the rows before the shard's
    start from the left neighbour's tail (zeros at the global edge)."""
    halo = n_lags - 1
    if halo == 0:
        return c[:, None]
    ext = torch.cat([edge_shift(c[:, -halo:], axis_name, 1), c], dim=1)
    t_loc = c.shape[1]
    return torch.stack([ext[:, halo - d : halo - d + t_loc] for d in range(n_lags)],
                       dim=1)


def _local_cnmf_step(x, c, s, axis_name: str, n_lags: int, precision=None):
    """One S-then-C update of :func:`~..models.cnmf.cnmf_update` on
    time shards: x ``(b, t_loc, L)``, c ``(b, t_loc, K)``, s
    ``(b, K, D, L)`` (replicated over the time group)."""
    halo = n_lags - 1
    with matmul_precision(precision):
        cs = _lag_stack_sharded(c, n_lags, axis_name)
        xhat = torch.einsum("bdtk,bkdl->btl", cs, s)
        num_s = time_sum(torch.einsum("bdtk,btl->bkdl", cs, x), axis_name)
        den_s = time_sum(torch.einsum("bdtk,btl->bkdl", cs, xhat), axis_name)
        s = s * (num_s / _guard(den_s))
        xhat = torch.einsum("bdtk,bkdl->btl", cs, s)
        if halo:
            x_ext = torch.cat([x, edge_shift(x[:, :halo], axis_name, -1)], dim=1)
            xh_ext = torch.cat([xhat, edge_shift(xhat[:, :halo], axis_name, -1)], dim=1)
        else:
            x_ext, xh_ext = x, xhat
        g_num = torch.einsum("btl,bkdl->bdtk", x_ext, s)
        g_den = torch.einsum("btl,bkdl->bdtk", xh_ext, s)
    t_loc = x.shape[1]
    num_c = sum(g_num[:, d, d : d + t_loc] for d in range(n_lags))
    den_c = sum(g_den[:, d, d : d + t_loc] for d in range(n_lags))
    return c * (num_c / _guard(den_c)), s


def _local_cnmf_error(x, c, s, axis_name: str, n_lags: int, precision=None):
    """Per-fit Frobenius error of the reconstruction, time-summed."""
    with matmul_precision(precision):
        diff = x - torch.einsum("bdtk,bkdl->btl",
                                _lag_stack_sharded(c, n_lags, axis_name), s)
    return time_sum((diff * diff).sum(dim=(-1, -2)), axis_name).sqrt()


def sharded_fit_cnmf(
    xs, c0, s0, mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    precision=None,
) -> CNMFState:
    """Batched convolutive NMF on a ``(data, time)`` mesh.

    Args:
        xs: ``(B, T, L)`` trials, sharded ``(data, time, None)``.
        c0: ``(B, T, K)`` activations, sharded like ``xs``.
        s0: ``(B, K, D, L)`` synergies, sharded over ``data`` only.
        precision: matmul precision of the contractions, the stopping
            checks' included (``None``: full float32).

    Returns:
        :class:`~..models.cnmf.CNMFState` of DTensors with those
        placements; per-fit stopping, converged fits frozen.

    Raises:
        ValueError: when ``T`` does not divide over the time shards, or
            the lag halo exceeds one shard.
    """
    n_lags = s0.shape[2]
    t = xs.shape[1]
    n_time = _spmd.axis_size(mesh, TIME_AXIS)
    if t % n_time:
        raise ValueError(f"time length {t} must divide over {n_time} time shards")
    if n_lags - 1 > t // n_time:
        raise ValueError(
            f"lag halo {n_lags - 1} exceeds one time shard "
            f"({t // n_time} samples); use fewer time shards or lags"
        )
    x_spec, s_spec = (DATA_AXIS, TIME_AXIS, None), (DATA_AXIS, None, None, None)
    step = functools.partial(_local_cnmf_step, axis_name=TIME_AXIS, n_lags=n_lags,
                             precision=precision)
    error = functools.partial(_local_cnmf_error, axis_name=TIME_AXIS, n_lags=n_lags,
                              precision=precision)
    xb, cb, sb = (_spmd.local(a, mesh, s, name=n) for a, s, n in
                  zip((xs, c0, s0), (x_spec, x_spec, s_spec), ("xs", "c0", "s0")))
    out = _run(mesh, lambda: fit_chunked(xb, cb.to(xb.dtype), sb.to(xb.dtype), step,
                                         error, max_iter, tol, check_every))
    return _wrap_state(CNMFState, out, mesh, (x_spec, s_spec, _B, _B, _B))


def _local_cnmf_step_tp(x, c, s, axis_name: str, n_lags: int, precision=None):
    """One convolutive update on CHANNEL shards: time is whole (the lag
    stack needs no halo), the S update is local, and only the C
    update's channel sums cross shards (one ``all_reduce`` pair), after
    which every process of a model group holds the same C.  Shapes:
    x ``(b, T, l_loc)``, c ``(b, T, K)``, s ``(b, K, D, l_loc)``."""
    with matmul_precision(precision):
        cs = _lag_stack(c, n_lags)
        xhat = torch.einsum("bdtk,bkdl->btl", cs, s)
        num_s = torch.einsum("bdtk,btl->bkdl", cs, x)
        den_s = torch.einsum("bdtk,btl->bkdl", cs, xhat)
        s = s * (num_s / _guard(den_s))
        xhat = torch.einsum("bdtk,bkdl->btl", cs, s)
        g_num = axis_sum(torch.einsum("btl,bkdl->bdtk", x, s), axis_name)
        g_den = axis_sum(torch.einsum("btl,bkdl->bdtk", xhat, s), axis_name)

    def lag_sum(g):
        return sum(torch.nn.functional.pad(g[:, d, d:], (0, 0, 0, d))
                   for d in range(n_lags))

    return c * (lag_sum(g_num) / _guard(lag_sum(g_den))), s


def _local_cnmf_error_tp(x, c, s, axis_name: str, n_lags: int, precision=None):
    """Frobenius error with the channel sums summed over the model axis."""
    with matmul_precision(precision):
        diff = x - torch.einsum("bdtk,bkdl->btl", _lag_stack(c, n_lags), s)
    return axis_sum((diff * diff).sum(dim=(-1, -2)), axis_name).sqrt()


def sharded_fit_cnmf_tp(
    xs, c0, s0, mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    precision=None,
) -> CNMFState:
    """Batched convolutive NMF on a ``(data, model)`` mesh.

    The tensor-parallel counterpart of :func:`sharded_fit_cnmf` for wide
    channel counts: the synergies and ``X``'s channel axis shard over
    ``"model"``, the activations stay replicated within a model group.

    Args:
        xs: ``(B, T, L)`` trials, sharded ``(data, None, model)``.
        c0: ``(B, T, K)`` activations, sharded over ``data`` only.
        s0: ``(B, K, D, L)`` synergies, sharded ``(data, None, None, model)``.

    Raises:
        ValueError: when ``L`` does not divide over the model shards.
    """
    n_lags = s0.shape[2]
    n_model = _spmd.axis_size(mesh, MODEL_AXIS)
    if xs.shape[2] % n_model:
        raise ValueError(
            f"channel count {xs.shape[2]} must divide over {n_model} model shards"
        )
    x_spec, c_spec = (DATA_AXIS, None, MODEL_AXIS), (DATA_AXIS, None, None)
    s_spec = (DATA_AXIS, None, None, MODEL_AXIS)
    step = functools.partial(_local_cnmf_step_tp, axis_name=MODEL_AXIS, n_lags=n_lags,
                             precision=precision)
    error = functools.partial(_local_cnmf_error_tp, axis_name=MODEL_AXIS,
                              n_lags=n_lags, precision=precision)
    xb, cb, sb = (_spmd.local(a, mesh, s, name=n) for a, s, n in
                  zip((xs, c0, s0), (x_spec, c_spec, s_spec), ("xs", "c0", "s0")))
    out = _run(mesh, lambda: fit_chunked(xb, cb.to(xb.dtype), sb.to(xb.dtype), step,
                                         error, max_iter, tol, check_every))
    return _wrap_state(CNMFState, out, mesh, (c_spec, s_spec, _B, _B, _B))
