"""Ingest layer: Vicon Nexus CSV parsing, streaming and trial batching
(no pandas)."""

from .batch import TrialBatch, batch_iterator, device_prefetch, stack_trials

from .stream import DeviceStream, SectionHeader, ViconChunk, stream_vicon_file
from .vicon import (
    ViconCSVError,
    load_vicon_file,
    load_vicon_files,
    load_vicon_lines,
)

__all__ = [
    "load_vicon_file",
    "load_vicon_files",
    "load_vicon_lines",
    "ViconCSVError",
    "stream_vicon_file",
    "ViconChunk",
    "SectionHeader",
    "DeviceStream",
    "TrialBatch",
    "stack_trials",
    "batch_iterator",
    "device_prefetch",
]
