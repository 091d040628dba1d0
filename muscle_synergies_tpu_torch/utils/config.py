"""Declarative pipeline presets.

Port of :mod:`muscle_synergies_tpu.utils.config`, field for field, so a
configuration written by either package as JSON (:meth:`PipelineConfig.to_json`)
loads in the other (:meth:`PipelineConfig.from_json`).  ``solver_impl``
takes the JAX package's values as well as this package's: ``"auto"``,
``"torch"`` and ``"cuda"`` here, where ``"xla"`` reads as ``"torch"``
and ``"pallas"`` as ``"cuda"`` (see :func:`torch_impl`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["FilterSpec", "PipelineConfig", "torch_impl"]

_IMPL_NAMES = {"auto": "auto", "torch": "torch", "cuda": "cuda",
               "xla": "torch", "pallas": "cuda"}


def torch_impl(name: str) -> str:
    """This package's name for a ``solver_impl`` value of either package."""
    try:
        return _IMPL_NAMES[name]
    except KeyError:
        raise ValueError(
            f"solver_impl must be one of {sorted(_IMPL_NAMES)}, got {name!r}"
        ) from None


@dataclass(frozen=True)
class FilterSpec:
    """An IIR filter design, as consumed by ``ops.filters.sos_design``."""

    order: int = 4
    critical_freqs: Tuple[float, ...] = (4.0,)
    filter_type: str = "butter"
    band_type: str = "lowpass"
    cheby_param: Optional[float] = None
    zero_lag: bool = True

    def cutoff(self):
        """``critical_freqs`` as ``sos_design`` takes it (scalar or list)."""
        if len(self.critical_freqs) == 1:
            return self.critical_freqs[0]
        return list(self.critical_freqs)

    def design(self, sampling_frequency: float):
        from ..ops.filters import sos_design

        return sos_design(
            self.order, self.cutoff(), sampling_frequency,
            filter_type=self.filter_type, band_type=self.band_type,
            cheby_param=self.cheby_param,
        )


@dataclass(frozen=True)
class PipelineConfig:
    """A full EMG -> synergies pipeline, declaratively.

    Attributes:
        envelope: low-pass filter for the linear envelope (used when
            ``use_rms`` is False).
        use_rms / rms_window_s: moving-RMS smoothing over a window of
            ``rms_window_s`` seconds instead of the filtered envelope.
        reduce_to: time-normalization target length (None to skip).
        amplitude_normalize: divide channels by their max abs value.
        min_rank / max_rank: VAF rank-sweep range.
        solver / max_iter / tol: NMF solver settings.
        solver_impl: batched-solver implementation, ``"auto"`` (the
            CUDA kernels for CUDA float32 data, plain PyTorch
            otherwise), ``"torch"`` or ``"cuda"``; the JAX names
            ``"xla"`` and ``"pallas"`` are accepted.
        inner_iter: accelerated-MU inner repetitions per outer
            iteration (1 = sklearn-exact plain MU).
    """

    envelope: FilterSpec = FilterSpec()
    zero_center: bool = True
    use_rms: bool = False
    rms_window_s: float = 0.5
    reduce_to: Optional[int] = 200
    amplitude_normalize: bool = True
    min_rank: int = 1
    max_rank: int = 4
    solver: str = "cd"
    beta_loss: str = "frobenius"
    max_iter: int = 100_000
    tol: float = 1e-6
    solver_impl: str = "auto"
    inner_iter: int = 1

    # -- execution ---------------------------------------------------------
    def preprocess(self, x, sampling_frequency: float, device="cuda", dtype=None):
        """Apply the configured preprocessing chain to ``(N, L)`` data.

        Runs on the card unless ``device="cpu"``, in float32 there unless
        ``dtype`` says otherwise (``dtype=None`` on the CPU keeps the
        input's).
        """
        from .._common import as_tensor, entry_placement
        from ..ops import emg as _emg

        x = as_tensor(x, *entry_placement(device, dtype))
        if self.use_rms:
            if self.zero_center:
                x = _emg.zero_center(x)
            x = _emg.moving_rms(x, self.rms_window_s,
                                sampling_frequency=sampling_frequency)
        else:
            x = _emg.linear_envelope(
                x, critical_freqs=self.envelope.cutoff(),
                sampling_frequency=sampling_frequency, order=self.envelope.order,
                filter_type=self.envelope.filter_type,
                zero_lag=self.envelope.zero_lag,
                cheby_param=self.envelope.cheby_param,
                zero_center_=self.zero_center,
            )
        if self.reduce_to is not None:
            x = _emg.time_normalize(x, self.reduce_to)
        if self.amplitude_normalize:
            x = _emg.normalize(x.abs())
        return x

    def find_synergies(self, processed_emg_df, **overrides):
        """Run the configured rank sweep on an already-processed frame.

        :func:`~muscle_synergies_tpu_torch.models.select.find_synergies`
        from ``min_rank`` to ``max_rank`` with this config's solver
        settings; ``overrides`` (``device=``, ``sweep=``, ...) win.
        """
        from ..models.select import find_synergies

        kwargs = dict(max_iter=self.max_iter, tol=self.tol, solver=self.solver,
                      beta_loss=self.beta_loss)
        kwargs.update(overrides)
        return find_synergies(processed_emg_df, self.min_rank, self.max_rank,
                              **kwargs)

    # -- serialization -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        raw = json.loads(text)
        raw["envelope"] = FilterSpec(
            **{**raw["envelope"],
               "critical_freqs": tuple(raw["envelope"]["critical_freqs"])}
        )
        return cls(**raw)
