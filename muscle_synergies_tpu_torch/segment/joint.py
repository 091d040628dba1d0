"""Joint analysis: per-phase force-plate and EMG summaries.

Port of :mod:`muscle_synergies_tpu.segment.joint`.  Combines the gait
:class:`~muscle_synergies_tpu_torch.segment.Segmenter` with the
kinematics ops to produce a tidy per-phase table — impulse
and CoP excursion per plate, per-muscle EMG activity — the
"kinematics/force-plate joint analysis" deliverable of BASELINE
config 5.  :func:`phase_summary` returns a DataFrame, so it imports
pandas when called.
"""

from __future__ import annotations

from typing import Optional

from ..data import ViconNexusData
from ..ops.kinematics import cop_path_length, grf_impulse
from .gait import Segmenter

__all__ = ["phase_summary"]


def phase_summary(
    data: ViconNexusData,
    segmenter: Optional[Segmenter] = None,
    emg_df=None,
):
    """Per-(trecho, cycle, phase) summary of reactions and EMG.

    Args:
        data: the loaded capture.
        segmenter: fitted segmenter (built from ``data`` if omitted).
        emg_df: processed EMG aligned to the fast time base (defaults
            to the raw EMG frame; pass an envelope for meaningful
            activity numbers).

    Returns:
        a DataFrame with one row per phase occurrence: its span in
        samples, per-plate vertical impulse and CoP path length, and
        the mean of each EMG column over the phase.
    """
    import pandas as pd

    if segmenter is None:
        segmenter = Segmenter(data)
    if emg_df is None:
        emg_df = data.emg.df
    fs = data.sampling_frequency("fp")
    dev = data.forcepl[0]

    rows = []
    # iterate the segmenter's own keys (enums for the reference 4x2
    # protocol, 1-based ints for custom n_trechos/n_cycles layouts)
    for trecho, cycles in segmenter.segments.items():
        for cyc, phases in cycles.items():
            for phase in phases:
                seg = phases[phase]
                start = dev.to_index(seg.start)
                stop = dev.to_index(seg.stop) + 1
                row = {
                    "trecho": getattr(trecho, "name", trecho),
                    "cycle": getattr(cyc, "name", cyc),
                    "phase": phase.value,
                    "start_index": start,
                    "stop_index": stop,
                    "duration_s": (stop - start) / fs,
                }
                for p, plate in enumerate(data.forcepl[:2]):
                    arr = plate.array[start:stop]
                    cols = {c: j for j, c in enumerate(plate.coords)}
                    fz_key = next(
                        (c for c in cols if c.lower() == "fz"), None
                    )
                    if fz_key is None:
                        raise ValueError(
                            f"force plate {plate.name!r} has no 'Fz' "
                            f"column (coords: {list(cols)}); cannot "
                            "compute vertical impulse"
                        )
                    fz = arr[:, cols[fz_key]]
                    row[f"plate{p}_impulse_z"] = float(
                        grf_impulse(fz, fs)
                    )
                    if {"Cx", "Cy"} <= set(cols):
                        cop = arr[:, [cols["Cx"], cols["Cy"]]]
                        loaded = (fz != 0).astype(float)
                        row[f"plate{p}_cop_path"] = float(
                            cop_path_length(cop, loaded)
                        )
                emg_slice = emg_df.iloc[start:stop]
                for col in emg_df.columns:
                    row[f"emg_{col}_mean"] = float(emg_slice[col].mean())
                rows.append(row)
    return pd.DataFrame(rows)
