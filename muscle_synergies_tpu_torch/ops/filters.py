"""IIR filtering: scipy filter design on the host, SOS cascades in torch.

Port of :mod:`muscle_synergies_tpu.ops.filters`.  The design stage
(tiny, scalar) stays scipy on the host and produces second-order
sections in float64.  The application stage is :func:`sosfiltfilt`,
with scipy's ``sosfiltfilt`` semantics exactly: the signal is extended
by ``padlen`` samples at both ends (odd reflection by default), each
pass starts from the steady-state ``zi`` scaled by its input's first
sample, and the backward pass runs over the forward output reversed;
and :func:`sosfilt`, one causal pass from given states with scipy's
``sosfilt`` semantics, optionally returning the final states.

Two implementations sit behind ``impl`` of each, all in
:mod:`.filter_cuda`:

- ``"cuda"``: the hand-written kernels (float32 CUDA tensors; chunked
  scans over each signal column), K3 for ``sosfiltfilt`` and K6 for
  ``sosfilt``;
- ``"torch"``: their plain versions, a loop over time vectorized over
  columns (:func:`_cascade`), on any device and dtype.

``"auto"`` (the default) takes the kernel for a CUDA float32 tensor and
the plain version for a CPU tensor.

Time runs along axis 0 of an ``(N,)`` or ``(N, C)`` signal and along
axis 1 of an ``(B, N, C)`` batch of trials.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy import signal as _scipy_signal

from .._common import as_tensor, resolve_impl

__all__ = [
    "sos_design",
    "sosfilt_zi",
    "sosfilt",
    "sosfiltfilt",
    "default_padlen",
]


def sos_design(
    order: int,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    filter_type: str = "butter",
    band_type: str = "lowpass",
    cheby_param: Optional[float] = None,
) -> np.ndarray:
    """Design an IIR filter, returning ``(n_sections, 6)`` SOS in float64.

    Example:
        >>> sos_design(4, 10.0, 2000.0).shape
        (2, 6)

    Args:
        order: filter order.
        critical_freqs: cutoff (scalar for low/highpass, pair for
            bandpass/bandstop), in the units of ``sampling_frequency``.
        sampling_frequency: sampling rate in Hz.
        filter_type: ``"butter"``, ``"cheby1"`` or ``"cheby2"``.
        band_type: ``"lowpass"``, ``"highpass"``, ``"bandpass"`` or
            ``"bandstop"``.
        cheby_param: passband ripple (cheby1) or stopband attenuation
            (cheby2) in positive dB; ignored for Butterworth.
    """
    if filter_type == "butter":
        return _scipy_signal.butter(
            order, critical_freqs, btype=band_type, output="sos",
            fs=sampling_frequency,
        )
    if filter_type == "cheby1":
        design = _scipy_signal.cheby1
    elif filter_type == "cheby2":
        design = _scipy_signal.cheby2
    else:
        raise ValueError("filter type not understood.")
    return design(
        order, cheby_param, critical_freqs, btype=band_type, output="sos",
        fs=sampling_frequency,
    )


def _normalize_sos(sos: np.ndarray) -> np.ndarray:
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must have shape (n_sections, 6), got {sos.shape}")
    return sos / sos[:, 3:4]  # enforce a0 == 1


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state filter states for a unit step, shape ``(n_sections, 2)``.

    Equivalent to ``scipy.signal.sosfilt_zi``: per-section steady state
    ``zi = (I - A)^-1 B`` scaled by the cumulative DC gain of the
    preceding sections.
    """
    sos = _normalize_sos(sos)
    zi = np.empty((sos.shape[0], 2))
    scale = 1.0
    for k, (b0, b1, b2, _, a1, a2) in enumerate(sos):
        a = np.array([[-a1, 1.0], [-a2, 0.0]])
        b = np.array([b1 - a1 * b0, b2 - a2 * b0])
        zi[k] = scale * np.linalg.solve(np.eye(2) - a, b)
        scale *= (b0 + b1 + b2) / (1.0 + a1 + a2)  # section DC gain
    return zi


def default_padlen(sos: np.ndarray) -> int:
    """scipy's default ``sosfiltfilt`` pad length for this cascade."""
    sos = np.asarray(sos)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return 3 * int(ntaps)


def _resolve_padding(
    sos_np: np.ndarray, n_samples: int, padtype: Optional[str], padlen
) -> int:
    """Validate ``padtype`` and resolve ``padlen`` (scipy semantics)."""
    if padtype not in ("odd", "even", "constant", None):
        raise ValueError(
            "padtype must be 'odd', 'even', 'constant', or None; "
            f"got {padtype!r}"
        )
    if padtype is None:
        padlen = 0
    elif padlen is None:
        padlen = default_padlen(sos_np)
    _check_length(n_samples, padlen)
    return int(padlen)


def _check_length(n_samples: int, padlen: int) -> None:
    """scipy's refusal of a signal no longer than its edge extension."""
    if padlen >= n_samples:
        raise ValueError(
            f"the length of the input vector x must be greater than padlen, "
            f"which is {padlen}"
        )


# Edge extensions along the time axis (dim -2 of a (..., N, C) block),
# scipy's odd_ext / even_ext / const_ext.
def _odd_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    first, last = x[..., :1, :], x[..., -1:, :]
    left = 2 * first - x[..., 1 : padlen + 1, :].flip(-2)
    right = 2 * last - x[..., -padlen - 1 : -1, :].flip(-2)
    return torch.cat([left, x, right], dim=-2)


def _even_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    left = x[..., 1 : padlen + 1, :].flip(-2)
    right = x[..., -padlen - 1 : -1, :].flip(-2)
    return torch.cat([left, x, right], dim=-2)


def _const_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    shape = x.shape[:-2] + (padlen, x.shape[-1])
    left = x[..., :1, :].expand(shape)
    right = x[..., -1:, :].expand(shape)
    return torch.cat([left, x, right], dim=-2)


_EXTENSIONS = {"odd": _odd_ext, "even": _even_ext, "constant": _const_ext}


def fold_extend(x: torch.Tensor, padlen: int, padtype: Optional[str]) -> torch.Tensor:
    """A fresh ``(N_ext, B*C)`` buffer: every column's extended signal, time-major.

    One copy of the signal: the body is transposed into place and only
    the two edges go through scipy's extension rule.
    """
    b, n, c = x.shape
    if padtype is None:
        padlen = 0
    ext = x.new_empty((n + 2 * padlen, b, c))
    ext[padlen : padlen + n] = x.transpose(0, 1)
    if padlen:
        rule = _EXTENSIONS[padtype]
        left = rule(x[:, : padlen + 1], padlen)[:, :padlen]
        right = rule(x[:, -padlen - 1 :], padlen)[:, -padlen:]
        ext[:padlen] = left.transpose(0, 1)
        ext[padlen + n :] = right.transpose(0, 1)
    return ext.reshape(n + 2 * padlen, b * c)


def _cascade(
    sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal SOS cascade over dim 0 of ``x`` (N, C) from states ``zi``.

    The plain recurrence, one time step at a time, vectorized over the
    columns: ``sos`` is normalized (``a0 == 1``), ``zi`` is
    ``(n_sections, 2, C)``.  Same transposed direct form II update as
    the JAX package's scan and the CUDA kernels.

    Returns:
        ``(y, zf)``: the output ``(N, C)`` and the final states
        ``(n_sections, 2, C)``.
    """
    rows = sos.tolist()
    b0 = [r[0] for r in rows]
    bb1 = [r[1] - r[4] * r[0] for r in rows]
    bb2 = [r[2] - r[5] * r[0] for r in rows]
    a1 = [r[4] for r in rows]
    a2 = [r[5] for r in rows]
    s1 = [zi[s, 0].clone() for s in range(len(rows))]
    s2 = [zi[s, 1].clone() for s in range(len(rows))]
    y = torch.empty_like(x)
    for t in range(x.shape[0]):
        v = x[t]
        for s in range(len(rows)):
            out = b0[s] * v + s1[s]
            s1[s], s2[s] = (
                -a1[s] * s1[s] + s2[s] + bb1[s] * v,
                -a2[s] * s1[s] + bb2[s] * v,
            )
            v = out
        y[t] = v
    return y, torch.stack([torch.stack(s1), torch.stack(s2)], dim=1)


def sosfilt(
    sos: np.ndarray,
    x,
    zi=None,
    return_zf: bool = False,
    impl: str = "auto",
    device=None,
    dtype: Optional[torch.dtype] = None,
):
    """Causal SOS filtering along the time axis (scipy ``sosfilt``).

    The JAX package's ``sosfilt``; its TPU kernel is ``cascade_pallas``,
    whose counterpart here is the CUDA kernel K6
    (:func:`~.filter_cuda.sosfilt_cuda`).  A whole ``(B, N, C)`` batch is
    one launch.  Carrying ``zf`` from one call into the next call's
    ``zi`` filters a signal in chunks (streaming): exactly as in one pass
    in float64; in float32 the states are rounded to float32 between
    calls, which on the card keeps the chunks within about 1e-6 x
    max|y| of one launch.

    Args:
        x: ``(N,)`` or ``(N, C)`` signal (time major), or a ``(B, N, C)``
            batch of trials filtered along axis 1.
        zi: optional initial states: ``(n_sections, 2)`` (broadcast over
            channels and trials), ``(n_sections, 2, C)`` for an
            ``(N, C)`` signal, or ``(B, n_sections, 2, C)`` for a batch.
        return_zf: also return the final states, shaped as a full
            ``zi`` (``(n_sections, 2)`` for a 1-D signal), in ``x``'s
            dtype.
        impl: ``"auto"``, ``"torch"`` or ``"cuda"`` (see the module
            docstring).
        device, dtype: where and in what type to compute; ``None`` keeps
            the input's.
    """
    x = as_tensor(x, device, dtype)
    if x.ndim not in (1, 2, 3):
        raise ValueError(f"expected a 1-D, 2-D or 3-D input, got shape {tuple(x.shape)}")
    sos_np = _normalize_sos(sos)
    impl = resolve_impl(impl, x)
    x3 = x.reshape(1, -1, 1) if x.ndim == 1 else (x[None] if x.ndim == 2 else x)
    b, _, c = x3.shape
    n_sections = sos_np.shape[0]
    zi_t = None
    if zi is not None:
        zi_t = as_tensor(zi, x3.device, x3.dtype)
        full = (n_sections, 2, c) if x.ndim < 3 else (b, n_sections, 2, c)
        if zi_t.shape == (n_sections, 2):
            zi_t = zi_t[None, :, :, None].expand(b, n_sections, 2, c)
        elif zi_t.shape == full:
            zi_t = zi_t.reshape(b, n_sections, 2, c)
        else:
            raise ValueError(
                f"zi must have shape ({n_sections}, 2) or {full}, "
                f"got {tuple(zi_t.shape)}"
            )
    from . import filter_cuda

    run = filter_cuda.sosfilt_cuda if impl == "cuda" else filter_cuda.sosfilt_plain
    y, zf = run(sos_np, x3, zi_t)
    zf = zf.to(x.dtype)
    if x.ndim == 1:
        y, zf = y.reshape(-1), zf[0, :, :, 0]
    elif x.ndim == 2:
        y, zf = y[0], zf[0]
    return (y, zf) if return_zf else y


def sosfiltfilt(
    sos: np.ndarray,
    x,
    padtype: Optional[str] = "odd",
    padlen: Optional[int] = None,
    impl: str = "auto",
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Zero-phase forward-backward filtering (scipy ``sosfiltfilt``).

    Args:
        sos: ``(n_sections, 6)`` cascade.
        x: ``(N,)`` or ``(N, C)`` block (time major), or a ``(B, N, C)``
            batch of trials filtered along axis 1.
        padtype: ``"odd"`` (default), ``"even"``, ``"constant"`` or
            ``None`` (no extension; ``padlen`` is then 0).
        padlen: edge extension length; defaults to scipy's formula.
        impl: ``"auto"``, ``"torch"`` or ``"cuda"`` (see the module
            docstring).
        device, dtype: where and in what type to compute; ``None`` keeps
            the input's.
    """
    x = as_tensor(x, device, dtype)
    if x.ndim not in (1, 2, 3):
        raise ValueError(f"expected a 1-D, 2-D or 3-D input, got shape {tuple(x.shape)}")
    sos_np = _normalize_sos(sos)
    impl = resolve_impl(impl, x)
    squeeze = x.ndim == 1
    x3 = x.reshape(1, -1, 1) if squeeze else (x[None] if x.ndim == 2 else x)
    padlen = _resolve_padding(sos_np, x3.shape[1], padtype, padlen)
    from . import filter_cuda

    run = filter_cuda.sosfiltfilt_cuda if impl == "cuda" else filter_cuda.sosfiltfilt_plain
    y = run(sos_np, x3, padlen, padtype)
    if squeeze:
        return y.reshape(-1)
    return y[0] if x.ndim == 2 else y
