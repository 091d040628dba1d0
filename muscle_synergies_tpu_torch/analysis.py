"""Pandas-level analysis API mirroring the reference's ``analysis`` module.

Port of :mod:`muscle_synergies_tpu.analysis`: every function keeps the
reference's signature and DataFrame semantics (one 1-D signal per
column, optional ``inplace``), and the numerics run through
:mod:`muscle_synergies_tpu_torch.ops.emg`.  Like the package's other
entry points they compute on the card unless given ``device="cpu"``
(``dtype=None`` then keeps the frame's float64); on the card the causal
and zero-phase filters are the CUDA kernels K6 and K3.

pandas is imported only when a function is called, so importing this
module (and the package) needs none.  :func:`find_synergies`,
:class:`NMFModel` and :class:`SynergyRunResult` are re-exported from
:mod:`.models.select`, as the JAX module re-exports them.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from ._common import as_tensor, entry_placement, to_numpy
from .ops import emg as _emg

__all__ = [
    "zero_center",
    "digital_filter",
    "linear_envelope",
    "rms",
    "normalize",
    "subsample",
    "time_normalize",
    "fft_spectrum",
    "vaf",
    "NMFModel",
    "SynergyRunResult",
    "find_synergies",
]


def _recreate_signal(signal_df, inplace: bool = False, with_array=None):
    """Return ``signal_df`` itself (inplace) or a copy, optionally refilled."""
    import pandas

    if not inplace:
        signal_df = pandas.DataFrame(signal_df, copy=True)
    if with_array is not None:
        signal_df[:] = to_numpy(with_array)
    return signal_df


def zero_center(signal_df, inplace: bool = False, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Subtract each column's mean from it."""
    device, dtype = entry_placement(device, dtype)
    arr = _emg.zero_center(signal_df.to_numpy(), device=device, dtype=dtype)
    return _recreate_signal(signal_df, inplace, arr)


def digital_filter(
    signal_df,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: int,
    order: int,
    filter_type: str = "butter",
    band_type: str = "lowpass",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    inplace: bool = False,
    padtype: Optional[str] = "odd",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Apply a Butterworth/Chebyshev filter to each column.

    ``zero_lag=True`` filters forward and backward (zero-phase);
    otherwise one causal pass.  ``cheby_param`` is the passband ripple
    (cheby1) or stopband attenuation (cheby2) in dB; ``padtype`` the
    zero-lag edge extension (scipy semantics).
    """
    if filter_type not in {"butter", "cheby1", "cheby2"}:
        raise ValueError("filter type not understood.")
    device, dtype = entry_placement(device, dtype)
    arr = _emg.digital_filter(
        signal_df.to_numpy(), critical_freqs=critical_freqs,
        sampling_frequency=sampling_frequency, order=order,
        filter_type=filter_type, band_type=band_type, zero_lag=zero_lag,
        cheby_param=cheby_param, padtype=padtype, device=device, dtype=dtype,
    )
    return _recreate_signal(signal_df, inplace, arr)


def linear_envelope(
    signal_df,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: int,
    order: int,
    filter_type: str = "butter",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    zero_center_: bool = True,
    inplace: bool = False,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Linear envelope: (zero-center) -> rectify -> low-pass filter."""
    device, dtype = entry_placement(device, dtype)
    arr = _emg.linear_envelope(
        signal_df.to_numpy(), critical_freqs=critical_freqs,
        sampling_frequency=sampling_frequency, order=order,
        filter_type=filter_type, zero_lag=zero_lag, cheby_param=cheby_param,
        zero_center_=zero_center_, device=device, dtype=dtype,
    )
    return _recreate_signal(signal_df, inplace, arr)


def rms(
    signal_df,
    window_size: Union[int, float],
    inplace: bool = False,
    sampling_frequency: Optional[int] = None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Moving-window RMS with stride 1 and same-length output.

    ``window_size`` counts samples, or seconds when
    ``sampling_frequency`` is given (``round(size * fs)`` samples).
    """
    device, dtype = entry_placement(device, dtype)
    arr = _emg.moving_rms(signal_df.to_numpy(), window_size=window_size,
                          sampling_frequency=sampling_frequency, device=device,
                          dtype=dtype)
    return _recreate_signal(signal_df, inplace, arr)


def normalize(signal_df, inplace: bool = False, device="cuda",
              dtype: Optional[torch.dtype] = None):
    """Divide each column by its maximum absolute value."""
    device, dtype = entry_placement(device, dtype)
    arr = _emg.normalize(signal_df.to_numpy(), device=device, dtype=dtype)
    return _recreate_signal(signal_df, inplace, arr)


def subsample(signal_df, keep_every: Optional[int] = None):
    """Keep every ``keep_every``-th row (a pandas slice, on the host).

    The reference's documented decimation; its code head-slices, which
    its own docstring contradicts.
    """
    if keep_every is None:
        return signal_df.iloc[:]
    return signal_df.iloc[::keep_every]


def time_normalize(
    signal_df,
    reduce_to: int,
    kind: Optional[Union[int, str]] = "linear",
    fill_value="extrapolate",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Resample each column onto ``reduce_to`` points over [0, 1].

    Linear interpolation runs through :func:`~.ops.emg.time_normalize`
    on ``device``; other ``kind`` values use
    :func:`scipy.interpolate.interp1d` on the host, as in the JAX
    package.
    """
    import pandas

    if kind == "linear":
        device, dtype = entry_placement(device, dtype)
        arr = to_numpy(_emg.time_normalize(signal_df.to_numpy(), reduce_to,
                                        device=device, dtype=dtype))
    else:
        from scipy import interpolate

        n = signal_df.shape[0]
        interp = interpolate.interp1d(
            np.linspace(0, 1, n), signal_df.to_numpy(), axis=0, copy=False,
            kind=kind, fill_value=fill_value,
        )
        arr = interp(np.linspace(0, 1, reduce_to))
    index = np.linspace(0, 1, reduce_to)
    return pandas.DataFrame(arr, index=index, columns=signal_df.columns)


def fft_spectrum(signal_df, sampling_frequency: int, device="cuda",
                 dtype: Optional[torch.dtype] = None):
    """Amplitude spectrum at positive frequencies (index = frequency)."""
    import pandas

    device, dtype = entry_placement(device, dtype)
    signal_df = pandas.DataFrame(signal_df)
    freqs, ampl = _emg.fft_spectrum(signal_df.to_numpy(), sampling_frequency,
                                    device=device, dtype=dtype)
    return pandas.DataFrame(to_numpy(ampl), index=freqs, columns=signal_df.columns)


def vaf(
    original_df,
    transformed_signal: Optional[Any] = None,
    components: Optional[Any] = None,
    reconstructed_signal: Optional[Any] = None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Variance accounted for by a reconstruction.

    ``VAF = 1 - ||x - x_r||^2 / ||x||^2`` (Frobenius norm), where
    ``x_r`` is ``reconstructed_signal`` or ``transformed_signal @
    components``.

    Returns:
        a 1-row DataFrame: column ``"All signals"`` holds the overall
        VAF and each remaining column the per-muscle VAF.
    """
    import pandas

    device, dtype = entry_placement(device, dtype)
    x = as_tensor(original_df.to_numpy(dtype=float), device, dtype)
    if reconstructed_signal is None:
        reconstructed_signal = (as_tensor(transformed_signal, x.device, x.dtype)
                                @ as_tensor(components, x.device, x.dtype))
    overall, per_col = _emg.vaf(x, reconstructed_signal)
    labels = ["All signals"] + original_df.columns.tolist()
    # plain Python floats: float64 columns whatever the device dtype
    values = [float(overall)] + [float(v) for v in to_numpy(per_col).ravel()]
    return pandas.DataFrame({lbl: [val] for lbl, val in zip(labels, values)})


# Reference parity: the reference defines find_synergies in its analysis
# module, so `from ... analysis import find_synergies` resolves here too;
# the implementations live in models.select.
from .models.select import (  # noqa: E402
    NMFModel,
    SynergyRunResult,
    find_synergies,
)
