"""PyTorch / CUDA port of muscle_synergies_tpu for NVIDIA Hopper cards.

The capture front and the dataset synergy paths of the JAX package,
with the same public names, layouts and result types.  A Vicon Nexus
capture loads with :func:`load_vicon_file` (a native C++ decoder, no
pandas) into a :class:`ViconNexusData` of :class:`DeviceData` arrays,
:class:`segment.Segmenter` cuts its gait cycles by
``(frame, subframe)``, and the cut EMG arrays are the trials.  EMG
trials go through the envelope
pipeline (zero-center, then rectify and a zero-phase or causal
Butterworth lowpass, or a moving RMS; time-normalize,
amplitude-normalize), then one batched solve fits every
``(rank, trial)`` pair by CD, Frobenius MU or beta-divergence MU
(:func:`analyze_dataset`), or every ``(trial, restart)`` pair by
convolutive NMF (:func:`analyze_dataset_time_varying`), or the whole
stack by space-by-time NMF (:func:`analyze_dataset_space_by_time`).
The per-capture API is :mod:`.analysis` (pandas-level transforms),
:class:`NMFModel` and :func:`find_synergies`, and for the convolutive
and space-by-time models ``models.CNMFModel``,
:func:`find_time_varying_synergies`, ``models.NM3FModel`` and
:func:`find_space_by_time_synergies`; ``models.decode_trials`` decodes
task labels from per-trial coefficients (scikit-learn, imported when
it runs).  The entry points run on
the card by default, where the filters and the solvers are hand-written
CUDA kernels (``csrc/``, built with ``nvcc`` at first use); with
``device="cpu"``, plain PyTorch.

    >>> import numpy as np
    >>> from muscle_synergies_tpu_torch import analyze_dataset
    >>> rng = np.random.default_rng(0)
    >>> trials = [rng.random((600, 4)) for _ in range(2)]
    >>> result = analyze_dataset(trials, 1000.0, ranks=(1, 2), max_iter=50,
    ...                          device="cpu")
    >>> result.vaf_overall.shape
    (2, 2)

The package imports torch, numpy and scipy, never jax; pandas only
inside the functions that take or return DataFrames or Series (the
result classes' table helpers, :mod:`.analysis`, :func:`find_synergies`,
the ``find_*`` finders of the convolutive and space-by-time models,
``DeviceData.df`` and its row access, ``time_seq``,
:func:`segment.reactions`, :func:`segment.phase_summary`,
:func:`save_synergy_run` / :func:`load_synergy_run` and the rank
sweep's checkpoints, ``utils.find_synergies_checkpointed``).  Fitted
models persist in the JAX package's file format (:func:`save_model`,
:func:`load_model`), long bootstraps and CVs resume from checkpoints
(``models.resume``), and ``models.export_transform`` serves a transform
through ``torch.export`` to a process that has only torch.
``analyze_dataset_pipelined`` overlaps parsing capture files with the
card's work (pinned chunks copied on a side CUDA stream), the plots of
:mod:`.viz` need matplotlib, and ``python -m muscle_synergies_tpu_torch``
is the command line (``describe``, ``analyze``, ``analyze-dataset``,
``export-transform``; ``--platform cpu`` without a card).
:mod:`.parallel` runs the solvers and filters sharded over a
``torch.distributed`` device mesh (NCCL on the card, gloo with
``device="cpu"``), and every ``mesh=`` keyword takes such a mesh.
"""

from . import analysis, dataset, io, models, ops, parallel, segment, utils, viz
from .analysis import (
    digital_filter,
    fft_spectrum,
    linear_envelope,
    normalize,
    rms,
    subsample,
    time_normalize,
    vaf,
    zero_center,
)
from .data import (
    DeviceData,
    DeviceType,
    ForcePlateMeasurement,
    SectionType,
    ViconNexusData,
)
from .dataset import (
    DatasetResult,
    SpaceByTimeDatasetResult,
    TimeVaryingDatasetResult,
    analyze_dataset,
    analyze_dataset_pipelined,
    analyze_dataset_space_by_time,
    analyze_dataset_time_varying,
    preprocess_trials,
)
from .frames import ForcesEMGFrameTracker, FrameSubfr, SamplingFreq, TrajFrameTracker
from .io import ViconCSVError, load_vicon_file
from .models.cnmf import TimeVaryingSynergyResult, find_time_varying_synergies
from .models.nm3f import SpaceByTimeResult, find_space_by_time_synergies
from .models.persist import load_model, load_synergy_run, save_model, save_synergy_run
from .models.select import NMFModel, SynergyRunResult, find_synergies
from .utils.config import FilterSpec, PipelineConfig
from .viz import plot_fft, plot_signal, synergy_heatmap

__all__ = [
    "DatasetResult",
    "DeviceData",
    "DeviceType",
    "FilterSpec",
    "ForcePlateMeasurement",
    "ForcesEMGFrameTracker",
    "FrameSubfr",
    "NMFModel",
    "PipelineConfig",
    "SamplingFreq",
    "SectionType",
    "SpaceByTimeDatasetResult",
    "SpaceByTimeResult",
    "SynergyRunResult",
    "TimeVaryingDatasetResult",
    "TimeVaryingSynergyResult",
    "TrajFrameTracker",
    "ViconCSVError",
    "ViconNexusData",
    "analysis",
    "analyze_dataset",
    "analyze_dataset_pipelined",
    "analyze_dataset_space_by_time",
    "analyze_dataset_time_varying",
    "dataset",
    "digital_filter",
    "fft_spectrum",
    "find_space_by_time_synergies",
    "find_synergies",
    "find_time_varying_synergies",
    "io",
    "linear_envelope",
    "load_model",
    "load_synergy_run",
    "load_vicon_file",
    "models",
    "normalize",
    "ops",
    "parallel",
    "plot_fft",
    "plot_signal",
    "preprocess_trials",
    "rms",
    "save_model",
    "save_synergy_run",
    "segment",
    "subsample",
    "synergy_heatmap",
    "time_normalize",
    "utils",
    "vaf",
    "viz",
    "zero_center",
]
