"""EMG preprocessing, IIR filtering and kinematics on tensors."""

from .batched import (
    linear_envelope_batch,
    moving_rms_batch,
    normalize_batch,
    time_normalize_batch,
    zero_center_batch,
)
from .emg import (
    digital_filter,
    fft_spectrum,
    linear_envelope,
    moving_rms,
    normalize,
    rectify,
    subsample,
    time_normalize,
    vaf,
    zero_center,
)
from .filters import default_padlen, sos_design, sosfilt, sosfilt_zi, sosfiltfilt
from .kinematics import (
    cop_path_length,
    finite_difference,
    grf_impulse,
    loading_rate,
    marker_acceleration,
    marker_speed,
    marker_velocity,
    upsample_to_fast,
)

__all__ = [
    "cop_path_length",
    "default_padlen",
    "digital_filter",
    "fft_spectrum",
    "finite_difference",
    "grf_impulse",
    "linear_envelope",
    "linear_envelope_batch",
    "loading_rate",
    "marker_acceleration",
    "marker_speed",
    "marker_velocity",
    "moving_rms",
    "moving_rms_batch",
    "normalize",
    "normalize_batch",
    "rectify",
    "sos_design",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
    "subsample",
    "time_normalize",
    "time_normalize_batch",
    "upsample_to_fast",
    "vaf",
    "zero_center",
    "zero_center_batch",
]
