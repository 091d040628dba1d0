"""Gait segmentation from force-plate ground reactions (no pandas but
:func:`reactions` and :func:`phase_summary`, which return pandas objects)."""

from .joint import phase_summary
from .gait import (
    Cycle,
    Phase,
    Segmenter,
    Segments,
    Trecho,
    reactions,
    transition_indices,
)

__all__ = [
    "Phase",
    "Trecho",
    "Cycle",
    "Segments",
    "reactions",
    "transition_indices",
    "Segmenter",
    "phase_summary",
]
