"""Masked, batched preprocessing over padded ``(B, N, L)`` trial stacks.

Port of :mod:`muscle_synergies_tpu.ops.batched`:
:func:`zero_center_batch`, :func:`moving_rms_batch`,
:func:`time_normalize_batch`, :func:`normalize_batch` and
:func:`linear_envelope_batch`.  The batch dimension is written out (the
JAX package vmaps); ragged batches arrive zero-padded with a ``(B, N)``
validity mask (:func:`muscle_synergies_tpu_torch.models.batch.pad_and_stack`)
and every transform here is exact under that padding:

- ``zero_center``: means over valid samples only;
- ``moving_rms``: the zero padding is the reference's zero-padded
  window edge, so each trial equals its own RMS (output re-masked);
- the causal envelope (``zero_lag=False``) of zero-centred trials: a
  causal pass never reads the samples after the one it writes;
- ``time_normalize``: each trial's valid span maps onto [0, 1] using
  its own length;
- ``normalize``: padded zeros never win a max-abs.

The zero-phase envelope is exact only for equal-length trials (the odd
reflection must touch the true last sample), so in
:func:`linear_envelope_batch`, as in the JAX package, the mask only
re-zeroes the padding.  Ragged captures go through
:func:`_ragged_zero_phase_envelope`, which filters each trial over its
own length: one K3 launch for the whole padded batch on the card
(:func:`muscle_synergies_tpu_torch.dataset.preprocess_trials`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .._common import as_tensor, resolve_impl
from .emg import linear_envelope, unit_grid, windowed_rms
from .filters import _resolve_padding, sos_design

__all__ = [
    "zero_center_batch",
    "moving_rms_batch",
    "time_normalize_batch",
    "normalize_batch",
    "linear_envelope_batch",
]


def _lengths(xs: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.full((xs.shape[0],), xs.shape[1], dtype=xs.dtype,
                          device=xs.device)
    return mask.sum(dim=1)


def zero_center_batch(xs, mask=None, device=None, dtype: Optional[torch.dtype] = None):
    """Subtract per-trial per-channel means over valid samples."""
    xs = as_tensor(xs, device, dtype)
    if mask is None:
        return xs - xs.mean(dim=1, keepdim=True)
    m = as_tensor(mask, xs.device, xs.dtype)[..., None]
    means = (xs * m).sum(dim=1, keepdim=True) / _lengths(xs, m[..., 0]).clamp(
        min=1.0
    )[:, None, None]
    return (xs - means) * m


def moving_rms_batch(xs, window: int, mask=None, device=None,
                     dtype: Optional[torch.dtype] = None):
    """Reference-exact moving RMS over a padded ``(B, N, L)`` batch.

    The padding is zeros, which is exactly the reference's zero-padded
    window edge, so every trial's valid span equals its own
    :func:`~.emg.moving_rms`; the output is re-masked.

    Raises:
        ValueError: when ``window`` exceeds any trial's true length
            (from ``mask``), or the batch's length without one.  The
            JAX package can only poison such trials with NaN while it
            traces; PyTorch runs eagerly, so here the check always
            raises.
    """
    xs = as_tensor(xs, device, dtype)
    if mask is not None:
        mask = as_tensor(mask, xs.device, xs.dtype)
        shortest = int(mask.sum(dim=1).min())
        if shortest < window:
            raise ValueError(
                f"window ({window} samples) is longer than the shortest "
                f"trial ({shortest} valid samples)"
            )
    elif window > xs.shape[1]:
        raise ValueError(
            f"window ({window} samples) is longer than the signal "
            f"({xs.shape[1]} samples)"
        )
    out = windowed_rms(xs, window)
    return out if mask is None else out * mask[..., None]


def time_normalize_batch(
    xs, reduce_to: int, mask=None, device=None, dtype: Optional[torch.dtype] = None
):
    """Resample every trial's *valid* span onto ``reduce_to`` points.

    Each trial's source grid is ``arange(N) / (length - 1)``, so the
    query grid ``linspace(0, 1, reduce_to)`` only ever reads real
    samples (position 1.0 is exactly the trial's last valid sample).
    Same formula and edges as ``jnp.interp`` (see
    :func:`muscle_synergies_tpu_torch.ops.emg.interp`).
    """
    xs = as_tensor(xs, device, dtype)
    if mask is not None:
        mask = as_tensor(mask, xs.device, xs.dtype)
    b, n, c = xs.shape
    lengths = _lengths(xs, mask)
    dst = unit_grid(reduce_to, xs.dtype, xs.device)  # (R,)
    src = torch.arange(n, dtype=xs.dtype, device=xs.device)[None, :] / (
        lengths - 1.0
    ).clamp(min=1.0)[:, None]  # (B, N)
    q = dst[None, :].expand(b, reduce_to).contiguous()
    i = torch.searchsorted(src, q, right=True).clamp(1, n - 1)  # (B, R)
    gather = lambda idx: xs.gather(1, idx[..., None].expand(b, reduce_to, c))  # noqa: E731
    lo = gather(i - 1)
    df = gather(i) - lo
    x_lo = src.gather(1, i - 1)
    dx = (src.gather(1, i) - x_lo)[..., None]
    delta = (q - x_lo)[..., None]
    # |dx| never falls to the eps-spacing guard of jnp.interp here:
    # source grids are strictly increasing steps of 1 / (length - 1)
    f = lo + (delta / dx) * df
    f = torch.where((q < src[:, :1])[..., None], xs[:, :1], f)
    return torch.where((q > src[:, -1:])[..., None], xs[:, -1:], f)


def normalize_batch(xs, mask=None, device=None, dtype: Optional[torch.dtype] = None):
    """Per-trial per-channel max-abs normalization (padding-safe)."""
    xs = as_tensor(xs, device, dtype)
    denom = xs.abs().amax(dim=1, keepdim=True)
    out = xs / torch.where(denom == 0, torch.ones_like(denom), denom)
    if mask is not None:
        out = out * as_tensor(mask, xs.device, xs.dtype)[..., None]
    return out


def linear_envelope_batch(
    xs,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    order: int,
    mask=None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    **kwargs,
):
    """Linear envelope of every trial of a ``(B, N, L)`` batch.

    The whole batch is one filter call: the lowpass runs over the
    trials' ``B*L`` columns, which is what the CUDA kernels (K3 for the
    zero-phase filter, K6 for the causal one) run over.  ``kwargs`` are
    :func:`~.emg.linear_envelope`'s.  Exact for equal-length trials, and
    for ragged ones under the causal filter once they are zero-centred
    with the mask (:func:`zero_center_batch`, then ``zero_center_=False``
    here); the mask re-zeroes the padding.
    """
    xs = as_tensor(xs, device, dtype)
    out = linear_envelope(
        xs, critical_freqs=critical_freqs,
        sampling_frequency=sampling_frequency, order=order, **kwargs,
    )
    if mask is not None:
        out = out * as_tensor(mask, xs.device, xs.dtype)[..., None]
    return out


def _ragged_zero_phase_envelope(
    xs: torch.Tensor,
    mask: torch.Tensor,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    order: int,
    filter_type: str = "butter",
    cheby_param: Optional[float] = None,
) -> torch.Tensor:
    """Rectify and zero-phase lowpass every trial over its own length.

    ``xs`` is a zero-padded ``(B, N, L)`` batch (already zero-centred),
    ``mask`` its ``(B, N)`` validity mask.  Each trial is filtered as
    scipy's ``sosfiltfilt`` filters it alone: the odd extension reflects
    about its own last valid sample.  On the card that is one launch of
    K3 with ``lengths = mask.sum(1)``; on the CPU the plain version,
    trial lengths in groups.  The padding comes back zero.
    """
    from . import filter_cuda

    sos = sos_design(order, critical_freqs, sampling_frequency,
                     filter_type=filter_type, band_type="lowpass",
                     cheby_param=cheby_param)
    lengths = mask.sum(dim=1).round().to(torch.int64)
    padlen = _resolve_padding(sos, int(lengths.min()), "odd", None)
    cuda = resolve_impl("auto", xs) == "cuda"
    run = filter_cuda.sosfiltfilt_cuda if cuda else filter_cuda.sosfiltfilt_plain
    return run(sos, xs.abs(), padlen, "odd", lengths)
