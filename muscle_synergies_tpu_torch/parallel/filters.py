"""Time-sharded IIR filtering and moving RMS: exact sequence parallelism.

Port of :mod:`muscle_synergies_tpu.parallel.filters`.  The time axis of
an ``(N, C)`` signal shards over a mesh axis, and each process filters
its block through the whole cascade at once with the causal kernel
(K6, :func:`~..ops.filter_cuda.sosfilt_cuda`, on the card;
:func:`~..ops.filter_cuda.sosfilt_plain` elsewhere).  The cascade's
state is linear: a block of ``n`` samples entered with state ``z``
leaves with ``A^n z + d``, where ``A`` is the cascade's ``(2S, 2S)``
one-sample map and ``d`` the block's exit from a zero state.  So a pass
is:

1. one K6 launch from a zero state, giving the block's ``d``;
2. one ``all_gather`` of the ``d``s over the time group;
3. each process folds the blocks before it (after it, for the backward
   pass) in float64, ``z <- A^n z + d``, from the pass's own entry
   state, to get its block's exact entry state;
4. one K6 launch from that state, emitting the block.

A causal filter is one pass (two launches); a zero-phase filter is two
passes plus scipy's edge pads, which are built from the global edges
and run on every process (one launch for the left pad, two for the
right pad's remainder when the blocks did not take all of it).  The JAX
package gathers per section instead (``2 S`` gathers a pass); the
result is the same up to rounding.

The moving RMS is a box (FIR) window, so its communication is a halo
exchange: each process receives ``window // 2`` samples from its left
neighbour and ``(window - 1) // 2`` from its right one
(:func:`~.collectives.edge_shift`, zeros at the global edges, which is
``'same'`` mode's zero padding) and sums its extended block's squares
in float64, as the port's :func:`~..ops.emg.moving_rms` does.

Inputs are ``(N, C)`` tensors, the same on every process (a DTensor is
gathered first); outputs are DTensors sharded over the time axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._common import resolve_impl
from ..ops.filter_cuda import chunk_power, sosfilt_cuda, sosfilt_plain
from ..ops.filters import _EXTENSIONS, _normalize_sos, _resolve_padding, sosfilt_zi
from . import _spmd
from .collectives import axis_index, axis_size, edge_shift, gather_time
from .mesh import TIME_AXIS

__all__ = ["sharded_sosfilt", "sharded_sosfiltfilt", "sharded_moving_rms"]


def _cascade(sos_np, x: torch.Tensor, zi: Optional[torch.Tensor]):
    """One causal pass of ``x (n, C)`` from states ``zi (S, 2, C)``
    (``None``: zeros): K6 for a CUDA float32 block, the plain version
    otherwise.  Returns ``(y, zf)``."""
    run = sosfilt_cuda if resolve_impl("auto", x) == "cuda" else sosfilt_plain
    y, zf = run(sos_np, x[None], None if zi is None else zi[None])
    return y[0], zf[0]


def _block_pass(sos_np, blk, z_first, axis_name: str, reverse: bool):
    """The pass over the time-sharded blocks (see the module docstring).

    ``z_first`` ``(S, 2, C)`` enters the globally first sample of the
    pass (the last process's block leads when ``reverse``).  Returns the
    local output block and the pass's exit state after the last block,
    ``(S, 2, C)`` in float64 on every process.
    """
    n_loc, c = blk.shape
    s = sos_np.shape[0]
    seg = blk.flip(0) if reverse else blk
    _, d = _cascade(sos_np, seg, None)
    ds = gather_time(d.reshape(2 * s, c).to(torch.float64), axis_name)
    power = torch.as_tensor(chunk_power(sos_np, n_loc), dtype=torch.float64,
                            device=blk.device)
    me, n_dev = axis_index(axis_name), axis_size(axis_name)
    z = z_first.reshape(2 * s, c).to(torch.float64)
    z_in = z
    for j in (range(n_dev - 1, -1, -1) if reverse else range(n_dev)):
        if j == me:
            z_in = z
        z = power @ z + ds[j]
    y, _ = _cascade(sos_np, seg, z_in.reshape(s, 2, c))
    return (y.flip(0) if reverse else y), z.reshape(s, 2, c)


def _global(x, mesh) -> torch.Tensor:
    """The whole signal on the mesh's device (see :func:`._spmd.on_mesh`)."""
    x = _spmd.on_mesh(_spmd.full(x), mesh, "x")
    if x.ndim != 2:
        raise ValueError(f"expected an (N, C) signal, got shape {tuple(x.shape)}")
    return x


def _blocks(x: torch.Tensor, mesh, axis_name: str):
    """``x`` zero-padded at its end to divide over the axis, and this
    process's block of it."""
    n_dev = _spmd.axis_size(mesh, axis_name)
    extra = (-x.shape[0]) % n_dev
    if extra:
        x = torch.cat([x, x.new_zeros((extra, x.shape[1]))])
    return _spmd.local(x, mesh, (axis_name, None))


def _trimmed(y: torch.Tensor, mesh, axis_name: str, n: int):
    """The local block ``y`` of the padded output as a DTensor of the
    first ``n`` samples (the last blocks trimmed, chunk by chunk)."""
    start = y.shape[0] * mesh.get_coordinate()[_spmd.axis_dim(mesh, axis_name)]
    keep = max(0, min(y.shape[0], n - start))
    return _spmd.wrap(y[:keep], mesh, (axis_name, None), shape=(n, y.shape[1]))


def sharded_sosfilt(sos: np.ndarray, x, mesh, axis_name: str = TIME_AXIS):
    """Causal SOS filtering of a time-sharded ``(N, C)`` signal.

    :func:`~..ops.filters.sosfilt` from zero states, the time axis
    sharded over ``axis_name``.  Any length: an indivisible one is
    zero-padded at its end (a causal filter's first ``N`` outputs do not
    see appended samples) and trimmed.
    """
    sos_np = _normalize_sos(sos)
    x = _global(x, mesh)
    n = x.shape[0]
    blk = _blocks(x, mesh, axis_name)
    zeros = blk.new_zeros((sos_np.shape[0], 2, blk.shape[1]))
    with _spmd.bound(mesh):
        y, _ = _block_pass(sos_np, blk, zeros, axis_name, reverse=False)
    return _trimmed(y, mesh, axis_name, n)


def _edge_pads(x: torch.Tensor, padlen: int, padtype: Optional[str]):
    """scipy's left and right extensions, each ``(padlen, C)``, from the
    global edges (the rules :func:`~..ops.filters.fold_extend` applies)."""
    rule = _EXTENSIONS[padtype]
    return (rule(x[: padlen + 1], padlen)[:padlen].contiguous(),
            rule(x[-padlen - 1 :], padlen)[-padlen:].contiguous())


def sharded_sosfiltfilt(
    sos: np.ndarray,
    x,
    mesh,
    axis_name: str = TIME_AXIS,
    padtype: Optional[str] = "odd",
    padlen: Optional[int] = None,
):
    """Zero-phase SOS filtering of a time-sharded ``(N, C)`` signal.

    scipy ``sosfiltfilt`` semantics, with ``padtype`` ``"odd"``
    (default), ``"even"``, ``"constant"`` or ``None``.  The edge pads
    are built from the global edges and filtered on every process; only
    the blocks' zero-state exits cross processes.  Total over lengths:
    when ``N`` does not divide, the first samples of the right
    extension ride with the data blocks (the extended sequence is
    scipy's, so the result is exact) and the output is trimmed to
    ``N``; when the extension is shorter than that gap, the signal is
    filtered whole on every process by :func:`~..ops.filters.sosfiltfilt`
    (K3 on the card) and returned as a plain tensor.

    Raises:
        ValueError: if ``padlen >= N`` (scipy's contract) or ``padtype``
            is not one of the four accepted values.
    """
    sos_np = _normalize_sos(sos)
    x = _global(x, mesh)
    n, c = x.shape
    padlen = _resolve_padding(sos_np, n, padtype, padlen)
    extra = (-n) % _spmd.axis_size(mesh, axis_name)
    if extra > padlen:
        from ..ops.filters import sosfiltfilt

        return sosfiltfilt(sos_np, x, padtype=padtype, padlen=padlen)
    zi_unit = torch.as_tensor(sosfilt_zi(sos_np), dtype=x.dtype, device=x.device)
    zi_unit = zi_unit[:, :, None]
    if padlen > 0:
        left, right_refl = _edge_pads(x, padlen, padtype)
        _, fwd_states = _cascade(sos_np, left, zi_unit * left[0])
    else:
        fwd_states, right_refl = zi_unit * x[0], x[:0]
    x_ext = torch.cat([x, right_refl[:extra]]) if extra else x
    blk = _spmd.local(x_ext, mesh, (axis_name, None))
    with _spmd.bound(mesh):
        y, end_states = _block_pass(sos_np, blk, fwd_states, axis_name, reverse=False)
        right_rem = right_refl[extra:]
        if right_rem.shape[0] > 0:
            fwd_right, _ = _cascade(sos_np, right_rem, end_states.to(x.dtype))
            y0 = fwd_right[-1]
            _, bwd_states = _cascade(sos_np, fwd_right.flip(0), zi_unit * y0)
        else:
            # the whole reflection rode with the blocks: the backward pass
            # starts from the globally last forward output
            y0 = gather_time(y[-1], axis_name)[-1]
            bwd_states = zi_unit * y0
        out, _ = _block_pass(sos_np, y, bwd_states, axis_name, reverse=True)
    return _trimmed(out, mesh, axis_name, n)


def sharded_moving_rms(x, window: int, mesh, axis_name: str = TIME_AXIS):
    """Moving-window RMS of a time-sharded ``(N, C)`` signal.

    :func:`~..ops.emg.moving_rms`'s semantics (``np.convolve(x**2,
    ones(w) / w, 'same')`` with zero-padded edges, the square root
    after) with the sample axis sharded over ``axis_name``, by a halo
    exchange (see the module docstring).  An indivisible ``N`` is
    zero-padded to divide (appended zeros change no in-range window)
    and trimmed; a window whose halo exceeds one block is computed
    whole on every process and returned as a plain tensor.

    Raises:
        ValueError: if ``window < 1`` or ``window > N``.
    """
    window = int(window)
    if window < 1:
        raise ValueError(f"window must contain at least one sample, got {window}")
    x = _global(x, mesh)
    n = x.shape[0]
    if window > n:
        raise ValueError(
            f"window ({window} samples) is longer than the signal ({n} samples)"
        )
    n_dev = _spmd.axis_size(mesh, axis_name)
    block = -(-n // n_dev)
    hl, hr = window // 2, (window - 1) // 2
    if hl > block or hr > block:
        from ..ops.emg import moving_rms

        return moving_rms(x, window)
    blk = _blocks(x, mesh, axis_name)
    with _spmd.bound(mesh):
        parts = [blk]
        if hl:
            parts.insert(0, edge_shift(blk[-hl:], axis_name, 1))
        if hr:
            parts.append(edge_shift(blk[:hr], axis_name, -1))
    ext = torch.cat(parts)
    running = torch.cumsum(ext * ext, dim=0, dtype=torch.float64)
    running = torch.cat([running.new_zeros((1, ext.shape[1])), running])
    nb = blk.shape[0]
    mean_sq = (running[window : window + nb] - running[:nb]) / window
    y = mean_sq.clamp(min=0.0).sqrt().to(x.dtype)
    return _trimmed(y, mesh, axis_name, n)
