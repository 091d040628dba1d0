"""Synthetic capture generators for tests and benchmarks.

The reference tutorial's quantitative anchors (overall VAF 0.956665 at
rank 2 and 0.975424 at rank 3 on ``dynamic_trial.csv``; reference
docs/source/tutorials/"Finding muscle synergies.ipynb" cell 28) cannot
be regression-tested directly because that capture is absent from the
mirror (``.MISSING_LARGE_BLOBS``).  :func:`synthesize_gait_emg` fills
the gap: a statistically similar 8-channel gait EMG whose
envelope-pipeline output lands in the same VAF regime —
0.956695 / 0.975237 with the calibrated defaults — so the full
zero-center → RMS → time-normalize → normalize → NMF chain is pinned
end-to-end (tests/test_vaf_anchor.py).  If the real file ever appears,
swap the anchors (TODO.md tracks it).

Port of :mod:`muscle_synergies_tpu.testing`.  The capture writers need
no pandas: each float64 is written as its ``repr``, the shortest string
that reads back to the same bits, so both packages' loaders parse a
file written here into the arrays the JAX package's writer gives.
:func:`synthesize_gait_emg` keeps its DataFrame return and imports
pandas when called.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "synthesize_gait_emg",
    "write_synthetic_capture",
    "write_reference_fulldata_twin",
    "GAIT_MUSCLES",
    "REFERENCE_TRAJ_MARKERS",
    "FP_COLS",
    "FP_UNITS",
]

#: The tutorial trial's electrode montage (reference notebook cell 8).
GAIT_MUSCLES = ("VL", "RF", "GMED", "TFL", "GMAXS", "GMAXI", "BF", "ST")


def _smooth_nonneg(noise: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian-smooth along axis 0 and rectify."""
    from scipy.ndimage import gaussian_filter1d

    return np.maximum(gaussian_filter1d(noise, sigma, axis=0), 0.0)


def synthesize_gait_emg(
    n_samples: int = 20_000,
    sampling_frequency: float = 2000.0,
    unique_weight: float = 0.66,
    noise: float = 0.02,
    stride_period: float = 1.1,
    seed: int = 12345,
):
    """Raw 8-channel gait-like surface EMG with two shared synergies.

    Construction: two raised-cosine activation patterns phase-shifted
    across the stride (the stance/swing pair the tutorial's rank-2
    factorization captures) drive all channels through a random
    nonnegative mixing matrix; each channel additionally carries
    slowly-varying idiosyncratic activity (``unique_weight`` scales it
    relative to the shared envelope) that no low-rank factorization can
    explain — the quantity that sets the VAF plateau.  The envelopes
    modulate white carriers, like rectifiable raw EMG.

    With the defaults, running the tutorial pipeline (zero-center →
    0.5 s RMS → time-normalize to 200 → amplitude-normalize → NMF)
    yields overall VAF 0.956695 (rank 2) and 0.975237 (rank 3),
    matching the reference notebook's 0.956665 / 0.975424 regime.

    Returns:
        ``(n_samples, 8)`` DataFrame with the tutorial's muscle labels
        (pandas is imported here; :func:`_gait_emg_array` is the same
        block as an array).
    """
    import pandas as pd

    raw = _gait_emg_array(n_samples, sampling_frequency, unique_weight,
                          noise, stride_period, seed)
    return pd.DataFrame(raw, columns=list(GAIT_MUSCLES))


def _gait_emg_array(
    n_samples: int = 20_000,
    sampling_frequency: float = 2000.0,
    unique_weight: float = 0.66,
    noise: float = 0.02,
    stride_period: float = 1.1,
    seed: int = 12345,
) -> np.ndarray:
    """:func:`synthesize_gait_emg`'s ``(n_samples, 8)`` float64 block."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sampling_frequency
    phase = 2.0 * np.pi * t / stride_period
    shared = np.stack(
        [
            np.maximum(0.0, np.cos(phase)) ** 2,
            np.maximum(0.0, np.cos(phase - 2.2)) ** 2,
        ],
        axis=1,
    )
    mixing = rng.random((2, len(GAIT_MUSCLES))) + 0.1
    envelope = shared @ mixing

    idiosyncratic = _smooth_nonneg(
        rng.standard_normal((n_samples, len(GAIT_MUSCLES))), sigma=400.0
    )
    # short captures can leave a channel's smoothed noise entirely
    # clamped to zero; skip rescaling those instead of dividing 0/0
    idio_std = idiosyncratic.std(axis=0, keepdims=True)
    idio_std[idio_std == 0] = 1.0
    idiosyncratic = (
        idiosyncratic / idio_std * envelope.std(axis=0, keepdims=True)
    )
    envelope = envelope + unique_weight * idiosyncratic

    carrier = rng.standard_normal((n_samples, len(GAIT_MUSCLES)))
    return envelope * carrier + noise * rng.standard_normal(
        (n_samples, len(GAIT_MUSCLES))
    )


FP_COLS = ("Fx", "Fy", "Fz", "Mx", "My", "Mz", "Cx", "Cy", "Cz")
FP_UNITS = ("N", "N", "N", "N.mm", "N.mm", "N.mm", "mm", "mm", "mm")


def _write_section(fh, title, freq, device_headers, col_names, units, body,
                   frames, subframes):
    """Emit one Vicon CSV section (shared by the capture writers).

    ``device_headers`` is a list of ``(name, n_cols)`` pairs — each
    device name appears over its first column and spans ``n_cols``
    columns, matching the export grammar the parser sniffs.
    """
    fh.write(f"{title}\n{freq}\n")
    headers = [""] * 2
    for name, n_cols in device_headers:
        headers += [name] + [""] * (n_cols - 1)
    fh.write(",".join(headers) + "\n")
    fh.write("Frame,Sub Frame," + ",".join(col_names) + "\n")
    fh.write(",," + ",".join(units) + "\n")
    # one row a line: frame, subframe, then each float64 as its repr
    # (shortest round-trip), in blocks so the text stays small
    frames, subframes = np.asarray(frames), np.asarray(subframes)
    body = np.asarray(body, dtype=np.float64)
    for start in range(0, body.shape[0], 8192):
        stop = start + 8192
        fh.write("".join(
            f"{fr},{sub},{','.join(map(repr, row))}\n"
            for fr, sub, row in zip(frames[start:stop].tolist(),
                                    subframes[start:stop].tolist(),
                                    body[start:stop].tolist())
        ))


def _forces_emg_headers(plate_name, emg_name="EMG2000 - Voltage"):
    """Device headers for 2 force plates (Force/Moment/CoP triplets)
    plus one 8-channel EMG, as ``(name, n_cols)`` pairs."""
    headers = []
    for plate in (1, 2):
        for meas in ("Force", "Moment", "CoP"):
            headers.append((f"{plate_name} #{plate} - {meas}", 3))
    headers.append((emg_name, 8))
    return headers


def write_synthetic_capture(
    path: str,
    state_len: int = 600,
    n_trechos: int = 4,
    n_cycles: int = 2,
    freq_forces: int = 2000,
    freq_traj: int = 100,
    n_markers: int = 4,
    seed: int = 12345,
) -> str:
    """Write a full synthetic gait capture as a Vicon Nexus CSV.

    A drop-in stand-in for the reference's missing
    ``dynamic_trial.csv`` (used by the executable tutorial): two force
    plates whose ``Fz`` traces follow the lateral-walk support grammar
    the reference's ``Segmenter`` expects (single-support lead-in, then
    ``n_trechos`` passes of ``n_cycles`` alternating double/single
    cycles each, separated by single-support gaps — reference
    project/segment.py:667-917), an 8-channel EMG from
    :func:`synthesize_gait_emg` (same VAF regime as the reference
    notebook), and smooth trajectory markers at the slow rate.

    Returns ``path``.
    """
    states = ["L"]
    for t in range(n_trechos):
        for c in range(n_cycles):
            single = "L" if c % 2 == 0 else "R"
            other = "R" if c % 2 == 0 else "L"
            states += ["B", single, "B", other]
        states += ["B", "L"]

    left, right = [], []
    for state in states:
        left += [-100.0 if state in "LB" else 0.0] * state_len
        right += [-50.0 if state in "RB" else 0.0] * state_len
    subframes = freq_forces // freq_traj
    n = len(left)
    pad = (-n) % subframes
    left = np.pad(np.asarray(left), (0, pad))
    right = np.pad(np.asarray(right), (0, pad))
    n = len(left)
    n_frames = n // subframes

    rng = np.random.default_rng(seed)
    emg = _gait_emg_array(n_samples=n, sampling_frequency=freq_forces, seed=seed)

    def plate_block(fz):
        block = np.round(rng.standard_normal((n, 9)) * 5.0, 5)
        block[:, 2] = fz
        return block

    fp1 = plate_block(left)
    fp2 = plate_block(right)
    t_slow = np.arange(n_frames) / freq_traj
    traj = np.round(
        np.stack(
            [
                500.0 * np.sin(2 * np.pi * (0.3 + 0.1 * i) * t_slow + i)
                for i in range(n_markers * 3)
            ],
            axis=1,
        ),
        5,
    )

    with open(path, "w", newline="") as fh:
        _write_section(
            fh, "Devices", freq_forces,
            _forces_emg_headers("Synthetic Force Plate"),
            list(FP_COLS) * 2 + list(GAIT_MUSCLES),
            list(FP_UNITS) * 2 + ["V"] * 8,
            np.column_stack([fp1, fp2, np.round(emg, 6)]),
            frames=np.repeat(np.arange(1, n_frames + 1), subframes),
            subframes=np.tile(np.arange(subframes), n_frames),
        )
        fh.write("\n")
        _write_section(
            fh, "Trajectories", freq_traj,
            [(f"Subject:M{i:02d}", 3) for i in range(n_markers)],
            ["X", "Y", "Z"] * n_markers,
            ["mm"] * (n_markers * 3),
            traj,
            frames=np.arange(1, n_frames + 1),
            subframes=np.zeros(n_frames, dtype=int),
        )
    return path


#: Angelica marker montage of the reference's full trial (reference
#: tests/func/conftest.py:424-464) — needed to satisfy its name checks.
REFERENCE_TRAJ_MARKERS = (
    "HV", "AUXH_D", "AUXH_E", "SEL", "C7", "T8", "IJ", "PX",
    "CIAS_D", "CIAS_E", "CIPS_D", "CIPS_E", "AUXP_D", "AUXP_E",
    "TROC_E", "PFC_E", "CM_E", "CL_E", "TROC_D", "PFC_D", "CM_D",
    "CL_D", "TT_E", "FH_E", "MM_E", "ML_E", "TT_D", "FH_D", "MM_D",
    "ML_D", "CAL_E", "MT1_E", "MT5_E", "CAL_D", "MT1_D", "MT5_D",
    "ELAST_DA", "ELAST_EA", "ELAST_EP", "ELAST_DP",
)


def write_reference_fulldata_twin(path: str) -> str:
    """Write a CSV satisfying the reference's ``TestFullData`` battery.

    ``dynamic_trial.csv`` is absent from the mirror, but every
    assertion of the reference's statistical suite (reference
    tests/func/test_data_loading.py:64-149, conftest.py:390-512) is a
    deterministic property — device counts/names/columns/units,
    124,460 x 9/8 @ 2000 Hz and 6,223 x 3 @ 100 Hz shapes, the
    ``Angelica:HV`` column means and the mean of force plate #2's last
    5000 samples — so a synthetic twin can pin them: the asserted
    columns are constant at the reference's hardcoded expectation
    values, everything else is zeros.  A pairwise-summed mean of N
    equal doubles is not guaranteed bit-identical to the value itself,
    but the reference's own assertions use ``np.isclose``
    (conftest.py:490-512), which the constant columns satisfy with
    margin.  Lets the reference's own full-data tests run against this
    framework without the original capture.

    Returns ``path``.
    """
    n_fast, n_slow, subframes = 124_460, 6_223, 20
    hv_mean = (62.87261584, 533.8539248, 1710.959518)
    fp2_mean = (
        0.6619629388, -22.88525715, -250.2051074, -24750.45294,
        -1610.309803, 405.6094715, 225.1692542, 827.3422018, 0.0,
    )
    n_markers = len(REFERENCE_TRAJ_MARKERS)

    fp2 = np.zeros((n_fast, 9))
    fp2[-5000:] = np.asarray(fp2_mean)
    traj = np.zeros((n_slow, n_markers * 3))
    traj[:, :3] = np.asarray(hv_mean)

    with open(path, "w", newline="") as fh:
        _write_section(
            fh, "Devices", 2000,
            _forces_emg_headers("Imported AMTI OR6 Series Force Plate"),
            list(FP_COLS) * 2 + list(GAIT_MUSCLES),
            list(FP_UNITS) * 2 + ["V"] * 8,
            np.column_stack(
                [np.zeros((n_fast, 9)), fp2, np.zeros((n_fast, 8))]
            ),
            frames=np.repeat(np.arange(1, n_slow + 1), subframes),
            subframes=np.tile(np.arange(subframes), n_slow),
        )
        fh.write("\n")
        _write_section(
            fh, "Trajectories", 100,
            [(f"Angelica:{marker}", 3) for marker in REFERENCE_TRAJ_MARKERS],
            ["X", "Y", "Z"] * n_markers,
            ["mm"] * (n_markers * 3),
            traj,
            frames=np.arange(1, n_slow + 1),
            subframes=np.zeros(n_slow, dtype=int),
        )
    return path
