"""Gait segmentation from force-plate ground reactions (no pandas but
:func:`reactions` and :func:`phase_summary`, which return pandas objects,
and :class:`SegmentPlotter`, which plots them with matplotlib)."""

from .joint import phase_summary
from .gait import (
    Cycle,
    Phase,
    SegmentPlotter,
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
    "SegmentPlotter",
    "phase_summary",
]
