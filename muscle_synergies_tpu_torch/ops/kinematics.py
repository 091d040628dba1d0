"""Kinematics and force-plate joint analysis on tensors.

Port of :mod:`muscle_synergies_tpu.ops.kinematics`: array transforms
for the trajectory and force-plate streams plus cross-rate alignment,
so marker kinematics, ground reactions and EMG synergies can be
analyzed on a common time base.  Plain torch functions on ``(N, ...)``
blocks; each keeps its input's device (NumPy input becomes a CPU
tensor, float64 unless it is float32), as :mod:`.emg` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .._common import as_tensor
from .emg import interp

__all__ = [
    "finite_difference",
    "marker_velocity",
    "marker_acceleration",
    "marker_speed",
    "upsample_to_fast",
    "cop_path_length",
    "grf_impulse",
    "loading_rate",
]


def finite_difference(x, sampling_frequency: float, order: int = 1) -> torch.Tensor:
    """Central-difference time derivative of a ``(N, D)`` block.

    Second-order accurate in the interior, one-sided at the edges —
    shape-preserving so derived signals stay frame-aligned.

    Example:
        >>> finite_difference([0.0, 1.0, 4.0], 1.0).tolist()
        [1.0, 2.0, 3.0]
    """
    out = as_tensor(x)
    for _ in range(order):
        interior = (out[2:] - out[:-2]) * (sampling_frequency / 2.0)
        first = (out[1:2] - out[0:1]) * sampling_frequency
        last = (out[-1:] - out[-2:-1]) * sampling_frequency
        out = torch.cat([first, interior, last], dim=0)
    return out


def marker_velocity(traj, sampling_frequency: float) -> torch.Tensor:
    """``(N, 3)`` velocity of one marker (units/s)."""
    return finite_difference(traj, sampling_frequency, order=1)


def marker_acceleration(traj, sampling_frequency: float) -> torch.Tensor:
    """``(N, 3)`` acceleration of one marker (units/s^2)."""
    return finite_difference(traj, sampling_frequency, order=2)


def marker_speed(traj, sampling_frequency: float) -> torch.Tensor:
    """``(N,)`` scalar speed of one marker."""
    vel = marker_velocity(traj, sampling_frequency)
    return torch.sqrt(torch.sum(vel * vel, dim=-1))


def upsample_to_fast(
    slow, num_subframes: int, num_fast: Optional[int] = None
) -> torch.Tensor:
    """Resample a slow-rate block onto the fast (forces/EMG) time base.

    Linear interpolation against the framework's frame/subframe
    alignment: slow sample ``f`` (frame ``f+1``) sits at fast index
    ``f * num_subframes`` (both streams' first samples coincide at
    frame 1, subframe 0); past the last slow sample the value holds,
    as ``jnp.interp`` clamps.

    Args:
        slow: ``(N_slow, D)`` or ``(N_slow,)`` trajectory-rate block.
        num_subframes: fast samples per frame
            (``SamplingFreq.num_subframes``).
        num_fast: output length (defaults to ``N_slow * num_subframes``).

    Example:
        >>> upsample_to_fast([0.0, 2.0], 2).tolist()
        [0.0, 1.0, 2.0, 2.0]
    """
    slow = as_tensor(slow)
    n_slow = slow.shape[0]
    if num_fast is None:
        num_fast = n_slow * num_subframes
    dtype = torch.promote_types(slow.dtype, torch.float32)
    src = torch.arange(n_slow, dtype=dtype, device=slow.device)
    dst = torch.arange(num_fast, dtype=dtype, device=slow.device) / num_subframes
    if slow.ndim == 1:
        return interp(dst, src, slow[:, None].to(dtype))[:, 0]
    return interp(dst, src, slow.to(dtype))


def cop_path_length(cop, mask=None) -> torch.Tensor:
    """Total center-of-pressure excursion of a ``(N, 2|3)`` CoP track.

    ``mask`` (``(N,)``) restricts to loaded samples (e.g. one phase).
    """
    cop = as_tensor(cop)
    steps = torch.sqrt(torch.sum((cop[1:] - cop[:-1]) ** 2, dim=-1))
    if mask is not None:
        mask = as_tensor(mask, cop.device)
        steps = steps * (mask[1:] * mask[:-1])
    return torch.sum(steps)


def grf_impulse(force, sampling_frequency: float, mask=None) -> torch.Tensor:
    """Trapezoidal impulse of a ``(N,)`` or ``(N, D)`` reaction (N*s)."""
    force = as_tensor(force)
    if mask is not None:
        shape = (-1,) + (1,) * (force.ndim - 1)
        force = force * as_tensor(mask, force.device).reshape(shape)
    mids = 0.5 * (force[1:] + force[:-1])
    return torch.sum(mids, dim=0) / sampling_frequency


def _convolve_same(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``numpy.convolve(a, v, mode="same")`` for 1-D tensors: the full
    convolution's central ``max(len(a), len(v))`` samples, starting at
    ``(min(len(a), len(v)) - 1) // 2`` (so an even window leans the way
    numpy's does)."""
    n, w = a.shape[0], v.shape[0]
    full = F.conv1d(F.pad(a[None, None], (w - 1, w - 1)),
                    v.flip(0)[None, None])[0, 0]
    start = (min(n, w) - 1) // 2
    return full[start:start + max(n, w)]


def loading_rate(fz, sampling_frequency: float, window: int = 5) -> torch.Tensor:
    """Peak rate of change of vertical ground reaction (N/s).

    The derivative is smoothed with a ``window``-sample moving average
    (``numpy.convolve(..., mode="same")``'s centring, even windows
    included) before taking the max magnitude, the usual definition for
    impact loading analysis.
    """
    fz = as_tensor(fz)
    dfz = finite_difference(fz[:, None], sampling_frequency)[:, 0]
    kernel = torch.ones(window, dtype=dfz.dtype, device=dfz.device) / window
    smooth = _convolve_same(dfz, kernel)
    return torch.max(torch.abs(smooth))
