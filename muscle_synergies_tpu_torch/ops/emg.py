"""EMG preprocessing on ``(num_samples, num_channels)`` tensors.

Port of :mod:`muscle_synergies_tpu.ops.emg`: :func:`zero_center`,
:func:`rectify`, :func:`digital_filter`, :func:`linear_envelope`,
:func:`moving_rms`, :func:`normalize`, :func:`subsample`,
:func:`time_normalize`, :func:`fft_spectrum` and :func:`vaf`.  Time
runs along axis 0.

Grids: ``time_normalize`` resamples onto ``linspace(0, 1, reduce_to)``.
``torch.linspace`` and ``jnp.linspace`` differ by up to 1 ulp in
float64, so both grids here are built by :func:`unit_grid` in float64
on the host (``numpy.linspace``, which equals ``jnp.linspace`` at these
sizes) and then cast; against the JAX package the resampled values
then agree to float64 rounding (the tests hold them to 1e-12).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .._common import as_tensor
from .filters import sos_design, sosfilt, sosfiltfilt

__all__ = [
    "zero_center",
    "rectify",
    "digital_filter",
    "linear_envelope",
    "moving_rms",
    "rms_window",
    "windowed_rms",
    "normalize",
    "subsample",
    "time_normalize",
    "fft_spectrum",
    "vaf",
    "interp",
    "unit_grid",
]


def zero_center(x, axis: int = 0, device=None, dtype: Optional[torch.dtype] = None):
    """Subtract each channel's mean (time axis defaults to 0).

    Example:
        >>> zero_center([[1.0], [3.0]]).ravel().tolist()
        [-1.0, 1.0]
    """
    x = as_tensor(x, device, dtype)
    return x - x.mean(dim=axis, keepdim=True)


def rectify(x, device=None, dtype: Optional[torch.dtype] = None):
    """Full-wave rectification.

    Example:
        >>> rectify([-2.0, 0.5]).tolist()
        [2.0, 0.5]
    """
    return as_tensor(x, device, dtype).abs()


def digital_filter(
    x,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    order: int,
    filter_type: str = "butter",
    band_type: str = "lowpass",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    padtype: Optional[str] = "odd",
    device=None,
    dtype: Optional[torch.dtype] = None,
):
    """Butterworth/Chebyshev filtering of a ``(N, C)`` block.

    ``zero_lag=True`` filters forward and backward (scipy
    ``sosfiltfilt``); otherwise one causal pass (scipy ``sosfilt`` from
    zero states).  An ``(B, N, C)`` batch is filtered along axis 1 in
    one call, which for a CUDA float32 tensor is one launch of the
    filter's kernel (K3 or K6).  ``padtype`` applies to ``zero_lag``
    only.
    """
    sos = sos_design(
        order, critical_freqs, sampling_frequency, filter_type=filter_type,
        band_type=band_type, cheby_param=cheby_param,
    )
    x = as_tensor(x, device, dtype)
    if zero_lag:
        return sosfiltfilt(sos, x, padtype=padtype)
    return sosfilt(sos, x)


def linear_envelope(
    x,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    order: int,
    filter_type: str = "butter",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    zero_center_: bool = True,
    device=None,
    dtype: Optional[torch.dtype] = None,
):
    """Linear envelope: (zero-center) -> rectify -> low-pass filter.

    Time runs along axis 0 of a ``(N, C)`` block and along axis 1 of a
    ``(B, N, C)`` batch.
    """
    x = as_tensor(x, device, dtype)
    if zero_center_:
        x = zero_center(x, axis=1 if x.ndim == 3 else 0)
    return digital_filter(
        rectify(x), critical_freqs=critical_freqs,
        sampling_frequency=sampling_frequency, order=order,
        filter_type=filter_type, band_type="lowpass", zero_lag=zero_lag,
        cheby_param=cheby_param,
    )


def rms_window(window_size: Union[int, float],
               sampling_frequency: Optional[float] = None) -> int:
    """The RMS window in samples: ``round(size * fs)`` for seconds."""
    if sampling_frequency is not None:
        window = int(round(window_size * sampling_frequency))
    else:
        window = int(window_size)
    if window < 1:
        raise ValueError(f"window must contain at least one sample, got {window}")
    return window


def windowed_rms(x: torch.Tensor, window: int) -> torch.Tensor:
    """Moving RMS along dim -2 of a ``(..., N, C)`` tensor (no checks).

    Output ``i`` averages the squares of samples ``i - window // 2``
    through ``i + (window - 1) // 2``, zero outside the signal and
    divided by the full window, which is
    ``np.convolve(x**2, ones(w) / w, "same")``.  The windowed sums are
    differences of one running sum taken in float64: a running sum in
    float32 grows to the whole signal's energy, and a quiet tail after a
    large transient would then read 0.  Float64 keeps 53 bits, more than
    the JAX package's compensated float32 (hi, lo) scan, so the result
    is at least as accurate.
    """
    n = x.shape[-2]
    running = torch.cumsum(x * x, dim=-2, dtype=torch.float64)
    running = torch.cat([torch.zeros_like(running[..., :1, :]), running], dim=-2)
    idx = torch.arange(n, device=x.device)
    lo = (idx - window // 2).clamp(0, n)
    hi = (idx + (window - 1) // 2 + 1).clamp(0, n)
    mean_sq = (running.index_select(-2, hi) - running.index_select(-2, lo)) / window
    # rounding can leave tiny negatives where the true sum is ~0
    return mean_sq.clamp(min=0.0).sqrt().to(x.dtype)


def moving_rms(
    x,
    window_size: Union[int, float],
    sampling_frequency: Optional[float] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
):
    """Moving-window RMS of a ``(N, C)`` block, stride 1, same length.

    The reference's semantics (square, average over a ``"same"``-placed
    window with zero-padded edges, square root; see
    :func:`windowed_rms`).

    Args:
        window_size: window in samples, or in seconds when
            ``sampling_frequency`` is given (``round(size * fs)``).

    Raises:
        ValueError: for an empty window, or one longer than the signal
            (``np.convolve`` would return the window's length).
    """
    window = rms_window(window_size, sampling_frequency)
    x = as_tensor(x, device, dtype)
    if window > x.shape[0]:
        raise ValueError(
            f"window ({window} samples) is longer than the signal "
            f"({x.shape[0]} samples)"
        )
    squeeze = x.ndim == 1
    out = windowed_rms(x[:, None] if squeeze else x, window)
    return out[:, 0] if squeeze else out


def subsample(x, keep_every: Optional[int] = None, device=None,
              dtype: Optional[torch.dtype] = None):
    """Keep every ``keep_every``-th sample along the time axis.

    The reference's documented decimation (its code head-slices, which
    its own docstring contradicts; the JAX package keeps decimation).
    """
    x = as_tensor(x, device, dtype)
    return x if keep_every is None else x[::keep_every]


def fft_spectrum(x, sampling_frequency: float, device=None,
                 dtype: Optional[torch.dtype] = None):
    """Amplitude spectrum at strictly positive frequencies.

    Returns:
        ``(freqs, amplitudes)``: a NumPy array of frequencies in the
        units of ``sampling_frequency`` and ``|FFT|`` per channel.
    """
    x = as_tensor(x, device, dtype)
    freqs = np.fft.fftfreq(x.shape[0], d=1.0 / sampling_frequency)
    positive = freqs > 0
    spectrum = torch.fft.fft(x, dim=0).abs()
    index = torch.as_tensor(np.flatnonzero(positive), device=x.device)
    return freqs[positive], spectrum.index_select(0, index)


def vaf(x, reconstruction, device=None, dtype: Optional[torch.dtype] = None):
    """Variance accounted for by ``reconstruction`` of ``x``.

    ``VAF = 1 - ||x - x_r||^2 / ||x||^2`` (Frobenius).

    Returns:
        ``(overall, per_channel)``: a scalar and an ``(L,)`` vector for
        an ``(N, L)`` signal.
    """
    x = as_tensor(x, device, dtype)
    err = x - as_tensor(reconstruction, x.device, x.dtype)
    e2, x2 = err * err, x * x
    return 1.0 - e2.sum() / x2.sum(), 1.0 - e2.sum(dim=0) / x2.sum(dim=0)


def normalize(x, axis: int = 0, device=None, dtype: Optional[torch.dtype] = None):
    """Divide each channel by its maximum absolute value.

    An all-zero channel stays zero (the JAX package's guard).
    """
    x = as_tensor(x, device, dtype)
    denom = x.abs().amax(dim=axis, keepdim=True)
    return x / torch.where(denom == 0, torch.ones_like(denom), denom)


def unit_grid(n: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``linspace(0, 1, n)`` built as ``jnp.linspace`` builds it (see module doc)."""
    return torch.as_tensor(np.linspace(0.0, 1.0, n), dtype=dtype, device=device)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` along dim -2 of ``fp``, for 1-D ``x`` and ``xp``.

    ``fp`` is ``(..., len(xp), C)``; the result is ``(..., len(x), C)``.
    Same formula and edge behaviour as ``jnp.interp``: the bracketing
    index is ``searchsorted(xp, x, side='right')`` clipped to
    ``[1, len(xp) - 1]``, the value ``fp[i-1] + (x - xp[i-1]) / dx * df``
    (``fp[i-1]`` where ``|dx|`` is below the dtype's smallest eps
    spacing), and ``fp[0]`` / ``fp[-1]`` outside ``[xp[0], xp[-1]]``.
    """
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    lo = fp.index_select(-2, i - 1)
    df = fp.index_select(-2, i) - lo
    dx = (xp[i] - xp[i - 1])[:, None]
    delta = (x - xp[i - 1])[:, None]
    np_dtype = np.dtype(str(xp.dtype).removeprefix("torch."))
    tiny = float(np.spacing(np.finfo(np_dtype).eps))
    dx0 = dx.abs() <= tiny
    f = torch.where(dx0, lo, lo + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where((x < xp[0])[:, None], fp[..., :1, :], f)
    return torch.where((x > xp[-1])[:, None], fp[..., -1:, :], f)


def time_normalize(x, reduce_to: int, device=None, dtype: Optional[torch.dtype] = None):
    """Linearly resample the block onto ``reduce_to`` points in [0, 1].

    The input time base is ``linspace(0, 1, N)`` and the output one
    ``linspace(0, 1, reduce_to)`` (normalized gait-cycle time).
    """
    x = as_tensor(x, device, dtype)
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    src = unit_grid(x2.shape[0], x2.dtype, x2.device)
    dst = unit_grid(reduce_to, x2.dtype, x2.device)
    out = interp(dst, src, x2)
    return out[:, 0] if squeeze else out
