"""Configuration presets, checkpointing, profiling."""

from .checkpoint import GridCheckpoint, SweepCheckpoint, find_synergies_checkpointed
from .config import FilterSpec, PipelineConfig
from .profiling import Timer, annotate, debug_nans, solver_report

__all__ = [
    "FilterSpec",
    "PipelineConfig",
    "GridCheckpoint",
    "SweepCheckpoint",
    "find_synergies_checkpointed",
    "Timer",
    "annotate",
    "debug_nans",
    "solver_report",
]
