"""Whole-dataset synergy analysis: many trials, many ranks, one solve.

Port of :mod:`muscle_synergies_tpu.dataset`'s local paths:

1. every trial is preprocessed through a
   :class:`~muscle_synergies_tpu_torch.utils.PipelineConfig`: zero-center,
   then either rectify and lowpass (zero-phase, or causal with
   ``FilterSpec(zero_lag=False)``) or a moving RMS (``use_rms=True``),
   then time-normalize and amplitude-normalize.  Ragged trials run as
   one padded batch with a mask: the causal filter and the moving RMS
   are exact under trailing zero padding, and the zero-phase filter
   takes each trial's length (its odd reflection must touch the trial's
   true last sample), so each is one filter launch on the card;
2. :func:`analyze_dataset`: factors for every rank are zero-padded to
   the largest rank; padded components stay exactly zero, so each grid
   entry equals an independent fit;
3. one batched solve fits all ``R x B`` problems with per-problem
   convergence: on a CUDA float32 batch, one launch of the CD, MU or
   beta-MU kernel;
4. :func:`analyze_dataset_time_varying`: every trial's restarts of a
   convolutive (time-varying) synergy fit join one batched solve, one
   launch of the convolutive kernel on the card, and each trial keeps
   its lowest-error restart;
5. :func:`analyze_dataset_space_by_time`: one space-by-time (NM3F) fit
   over the whole preprocessed stack, its restarts at once, in batched
   PyTorch products on the device (NM3F has no kernel).

The entry points run on the card unless the caller passes
``device="cpu"``.  With ``mesh=`` (a ``(data, time)`` mesh of
:func:`~muscle_synergies_tpu_torch.parallel.make_mesh`) every process
of the job calls the entry point on the same trials: the time-axis
preprocessing runs through the sequence-parallel filters when the
mesh's time axis has more than one process, and the solve through the
sharded solvers of :mod:`~muscle_synergies_tpu_torch.parallel` (plain
PyTorch, no kernel); every process gets the whole result.  pandas is
imported only by the result classes' table helpers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ._common import as_tensor, entry_placement, to_numpy
from .models.batch import (
    fit_cd_batch,
    fit_mu_batch,
    fit_mu_beta_batch,
    init_batch,
    vaf_batch,
)
from .models.beta import beta_loss_to_float
from .models.cnmf import (
    TimeVaryingSynergyResult,
    cnmf_reconstruct,
    fit_cnmf_batch,
    init_cnmf,
    normalize_synergies,
)
from .models.mu import EPSILON
from .models.nm3f import (
    SpaceByTimeResult,
    _fit_space_by_time,
    _temporal_frame,
    _validate_trial_stack,
)
from .models.select import compute_regularization
from .ops import batched as _b
from .ops.emg import rms_window
from .parallel._spmd import axis_size, gathered, pad_fits, usable_mesh
from .parallel.mesh import DATA_AXIS
from .utils.config import PipelineConfig, torch_impl

__all__ = [
    "DatasetResult",
    "SpaceByTimeDatasetResult",
    "TimeVaryingDatasetResult",
    "analyze_dataset",
    "analyze_dataset_pipelined",
    "analyze_dataset_space_by_time",
    "analyze_dataset_time_varying",
    "preprocess_trials",
]



def _channel_names(first) -> Optional[List[str]]:
    """Column labels of the first trial, when it carries any: a
    DataFrame's columns or a :class:`~.data.DeviceData`'s coords."""
    columns = getattr(first, "columns", None)
    if columns is not None:
        return list(columns)
    if hasattr(first, "coords"):  # DeviceData
        return list(first.coords)
    return None


def _normalize_trials_subjects(trials, subjects):
    """Flatten a ``{subject: trials}`` mapping / validate ``subjects=``."""
    if isinstance(trials, Mapping):
        if subjects is not None:
            raise ValueError(
                "pass either a {subject: trials} mapping or subjects=, not both"
            )
        subjects = [s for s, ts in trials.items() for _ in ts]
        trials = [t for ts in trials.values() for t in ts]
    if subjects is not None:
        subjects = list(subjects)
        if len(subjects) != len(trials):
            raise ValueError(
                f"got {len(subjects)} subject labels for {len(trials)} trials"
            )
    return trials, subjects


def _match_components(reference: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Reorder ``other``'s rows to best match ``reference``'s by cosine
    (greedy assignment; NMF row order is arbitrary per fit)."""
    eps = 1e-12
    ref = reference / (np.linalg.norm(reference, axis=1, keepdims=True) + eps)
    oth = other / (np.linalg.norm(other, axis=1, keepdims=True) + eps)
    sim = ref @ oth.T
    order = np.empty(sim.shape[0], dtype=int)
    for _ in range(sim.shape[0]):
        i, j = np.unravel_index(np.argmax(sim), sim.shape)
        order[i] = j
        sim[i, :] = -np.inf
        sim[:, j] = -np.inf
    return other[order]


def _subject_means(values: np.ndarray, subjects) -> dict:
    """Per distinct subject (first-appearance order): the mean of
    ``values`` over the subject's trials (the last axis)."""
    labels = np.asarray(subjects, dtype=object)
    return {s: np.mean(values[..., labels == s], axis=-1)
            for s in dict.fromkeys(subjects)}


def _as_array(trial):
    """One trial as an array or tensor (DataFrames through ``to_numpy``,
    a :class:`~.data.DeviceData` through its ``.array``)."""
    if isinstance(trial, torch.Tensor):
        return trial
    if hasattr(trial, "to_numpy"):
        return trial.to_numpy(dtype=float)
    if hasattr(trial, "array"):  # DeviceData
        return np.asarray(trial.array)
    return np.asarray(trial)


def _stage_trials(trials, device, dtype):
    """Trials as one batch on ``device``: ``(xs, mask)``, the mask
    ``None`` unless the trials are ragged (then zero-padded on the host,
    :func:`_pad_trials`)."""
    if getattr(trials, "ndim", None) == 3:  # already one equal-length batch
        return as_tensor(trials, device, dtype), None
    data, mask = _pad_trials([to_numpy(_as_array(t)) for t in trials], dtype)
    return data.to(device), None if mask is None else mask.to(device)


def _pad_trials(arrays, dtype: Optional[torch.dtype], pin: bool = False):
    """``(N_i, L)`` arrays as ``(data, mask)`` CPU tensors of ``dtype``
    (``None``: as :func:`~._common.as_tensor` would pick), padded
    straight into (pinned, when ``pin``) buffers: equal lengths stack
    with no mask, ragged ones are zero-padded with their ``(B, N)``
    mask."""
    if len({a.shape[1] for a in arrays}) != 1:
        raise ValueError("all trials must share the channel count")
    if dtype is None:
        dtype = torch.float32 if arrays[0].dtype == np.float32 else torch.float64
    lengths = [a.shape[0] for a in arrays]
    shape = (len(arrays), max(lengths), arrays[0].shape[1])
    data = torch.zeros(shape, dtype=dtype, pin_memory=pin)
    for b, a in enumerate(arrays):
        data[b, : a.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(a)))
    if len(set(lengths)) == 1:
        return data, None
    mask = torch.zeros(shape[:2], dtype=dtype, pin_memory=pin)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.0
    return data, mask


def _fold_channels(xs: torch.Tensor) -> torch.Tensor:
    """``(B, N, L) -> (N, B*L)``: trials become extra channels, so a whole
    batch is one sharded ``(N, C)`` filtering problem."""
    b, n, l = xs.shape
    return xs.transpose(0, 1).reshape(n, b * l)


def _unfold_channels(y: torch.Tensor, b: int, l: int) -> torch.Tensor:
    from .parallel._spmd import full

    y = full(y)
    return y.reshape(y.shape[0], b, l).transpose(0, 1)


def _sharded_rms_batch(xs, window, mask, mesh):
    """``moving_rms_batch`` with the sample axis sharded over the mesh's
    time axis: the padded trials are exact (``'same'`` mode zero-pads past
    each trial's end, which the batch's zero padding is), and the mask
    zeroes the padding's outputs again."""
    from .parallel.filters import sharded_moving_rms

    b, n, l = xs.shape
    if mask is not None:
        shortest = int(mask.sum(dim=1).min())
        if shortest < window:
            raise ValueError(
                f"window ({window} samples) is longer than the shortest "
                f"trial ({shortest} valid samples)"
            )
    out = _unfold_channels(sharded_moving_rms(_fold_channels(xs), window, mesh), b, l)
    return out if mask is None else out * mask[..., None]


def _sharded_envelope_batch(xs, spec, sampling_frequency, mesh):
    """``linear_envelope_batch`` of equal-length, zero-centered trials
    with the lowpass sharded over the mesh's time axis
    (:func:`~.parallel.filters.sharded_sosfiltfilt`, ``padtype='odd'``, or
    ``sharded_sosfilt`` for the causal envelope)."""
    from .parallel.filters import sharded_sosfilt, sharded_sosfiltfilt

    b, n, l = xs.shape
    folded = _fold_channels(xs.abs())
    sos = spec.design(sampling_frequency)
    if spec.zero_lag:
        y = sharded_sosfiltfilt(sos, folded, mesh)
    else:
        y = sharded_sosfilt(sos, folded, mesh)
    return _unfold_channels(y, b, l)


def _time_shards(mesh) -> int:
    """The size of the mesh's time axis (1 without one, or without a mesh)."""
    if mesh is None or "time" not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index("time"))


def _preprocess_batch(xs: torch.Tensor, mask: Optional[torch.Tensor],
                      sampling_frequency: float, config: PipelineConfig,
                      mesh=None) -> torch.Tensor:
    """The configured preprocessing of one ``(B, N, L)`` batch where it
    lies, ragged trials zero-padded with their ``(B, N)`` mask.  With a
    ``mesh`` whose time axis has more than one process, the moving RMS
    and the equal-length envelope's lowpass run sharded over it."""
    spec = config.envelope
    time_shards = _time_shards(mesh)
    # zero-center over each trial's valid samples, then the envelope
    if config.zero_center:
        xs = _b.zero_center_batch(xs, mask)
    if config.use_rms:
        window = rms_window(config.rms_window_s, sampling_frequency)
        if time_shards > 1:
            xs = _sharded_rms_batch(xs, window, mask, mesh)
        else:
            xs = _b.moving_rms_batch(xs, window, mask)
    elif time_shards > 1 and mask is None:
        xs = _sharded_envelope_batch(xs, spec, sampling_frequency, mesh)
    elif mask is not None and spec.zero_lag:
        # each trial filtered over its own length: one K3 launch
        xs = _b._ragged_zero_phase_envelope(
            xs, mask, critical_freqs=spec.cutoff(),
            sampling_frequency=sampling_frequency, order=spec.order,
            filter_type=spec.filter_type, cheby_param=spec.cheby_param,
        )
    else:
        xs = _b.linear_envelope_batch(
            xs, critical_freqs=spec.cutoff(),
            sampling_frequency=sampling_frequency, order=spec.order,
            mask=mask, filter_type=spec.filter_type, zero_lag=spec.zero_lag,
            cheby_param=spec.cheby_param, zero_center_=False,
        )
    # after resampling onto reduce_to points every row is valid
    xs = _b.time_normalize_batch(xs, config.reduce_to, mask)
    if config.amplitude_normalize:
        xs = _b.normalize_batch(xs.abs())
    return xs


def _check_reduce_to(config: PipelineConfig) -> None:
    if config.reduce_to is None:
        raise ValueError(
            "preprocess_trials needs config.reduce_to so trials share a "
            "common length"
        )


def preprocess_trials(
    trials,
    sampling_frequency: float,
    config: PipelineConfig = PipelineConfig(),
    dtype: Optional[torch.dtype] = None,
    mesh=None,
    device="cuda",
) -> torch.Tensor:
    """Run the configured preprocessing on every trial and stack them.

    Args:
        trials: a sequence of ``(N_i, L)`` arrays, tensors or DataFrames,
            or one ``(B, N, L)`` array or tensor of equal-length trials.
        config: its ``reduce_to`` must be set (it is what makes ragged
            trials stack into one ``(B, reduce_to, L)`` batch).
        dtype, device: where and in what type to compute: the card by
            default, in float32 unless ``dtype`` says otherwise; pass
            ``device="cpu"`` for the plain versions (``dtype=None`` then
            keeps the input's).  The whole chain runs there, the
            zero-phase and causal filters through their CUDA kernels
            (K3, K6) on the card, one launch for all trials, ragged or
            not.
        mesh: optional mesh; when its ``time`` axis has more than one
            process, the moving RMS, or the lowpass of equal-length
            trials, runs through the sequence-parallel filters
            (:mod:`~.parallel.filters`, K6 on the card) with the batch
            folded onto the channel axis.  The same result as the local
            path up to rounding.
    """
    device, dtype = entry_placement(device, dtype)
    _check_reduce_to(config)
    xs, mask = _stage_trials(trials, device, dtype)
    return _preprocess_batch(xs, mask, sampling_frequency, config, mesh)


@dataclass
class DatasetResult:
    """Synergies for every ``(rank, trial)`` pair of a dataset.

    Attributes (NumPy arrays, as in the JAX package):
        ranks: the swept ranks.
        w: ``(R, B, N, k_max)`` transformed signals (rank-padded).
        h: ``(R, B, k_max, L)`` components (rank-padded).
        vaf_overall: ``(R, B)`` total VAF.
        vaf_per_channel: ``(R, B, L)``.
        n_iter: ``(R, B)`` solver iterations.
        converged: ``(R, B)`` convergence flags.
        channel_names: channel labels when the inputs carried them.
        subjects: per-trial subject labels, or ``None``.
        sampling_frequency: EMG rate of the analyzed captures, if known.
    """

    ranks: tuple
    w: np.ndarray
    h: np.ndarray
    vaf_overall: np.ndarray
    vaf_per_channel: np.ndarray
    n_iter: np.ndarray
    converged: np.ndarray
    channel_names: Optional[List[str]] = None
    subjects: Optional[List] = None
    sampling_frequency: Optional[float] = None

    def components(self, rank: int, trial: int):
        """``(rank, L)`` components of one fit, as a labeled DataFrame."""
        import pandas

        r = self.ranks.index(rank)
        h = self.h[r, trial][:rank]
        cols = self.channel_names or range(h.shape[1])
        return pandas.DataFrame(h, columns=list(cols))

    def vaf_table(self):
        """Trials x ranks DataFrame of overall VAF (subject-indexed when
        subject labels are present)."""
        import pandas

        b = self.vaf_overall.shape[1]
        if self.subjects is not None:
            index = pandas.MultiIndex.from_arrays(
                [self.subjects, range(b)], names=["subject", "trial"]
            )
        else:
            index = pandas.RangeIndex(b, name="trial")
        return pandas.DataFrame(
            self.vaf_overall.T, columns=list(self.ranks), index=index
        )

    def _require_subjects(self):
        if self.subjects is None:
            raise ValueError(
                "no subject labels: pass subjects= (or a {subject: trials} "
                "mapping) to analyze_dataset"
            )

    def trials_of(self, subject) -> List[int]:
        """Trial indices belonging to one subject."""
        self._require_subjects()
        return [i for i, s in enumerate(self.subjects) if s == subject]

    def _subject_vaf_means(self) -> dict:
        """``subject_table("mean")``'s array core (no pandas): ``{subject:
        (R,) mean overall VAF}`` in the subjects' first-appearance order."""
        self._require_subjects()
        return _subject_means(self.vaf_overall, self.subjects)

    def subject_table(self, statistic: str = "mean"):
        """Subjects x ranks DataFrame of overall VAF, aggregated over trials."""
        import pandas

        self._require_subjects()
        if statistic == "mean":
            means = self._subject_vaf_means()
            return pandas.DataFrame(np.stack(list(means.values())),
                                    columns=list(self.ranks),
                                    index=pandas.Index(list(means), name="subject"))
        return self.vaf_table().groupby(level="subject", sort=False).agg(statistic)

    def subject_min_rank(self, vaf_threshold: float = 0.9):
        """Per subject: smallest swept rank whose mean VAF reaches the
        threshold (-1 if none does), as a pandas Series."""
        import pandas

        self._require_subjects()
        out = {}
        for subject, row in self.subject_table("mean").iterrows():
            reaching = [k for k in sorted(self.ranks) if row[k] >= vaf_threshold]
            out[subject] = reaching[0] if reaching else -1
        return pandas.Series(out, name="min_rank")

    def _subject_mean(self, rank: int, subject) -> np.ndarray:
        """:meth:`subject_components`' array: the ``(rank, L)`` mean of
        the subject's trials, each trial's rows aligned to the first
        trial's by cosine."""
        self._require_subjects()
        trials = self.trials_of(subject)
        if not trials:
            raise KeyError(f"unknown subject: {subject!r}")
        r = self.ranks.index(rank)
        reference = self.h[r, trials[0]][:rank]
        stacked = [reference] + [
            _match_components(reference, self.h[r, t][:rank]) for t in trials[1:]
        ]
        return np.mean(stacked, axis=0)

    def subject_components(self, rank: int, subject):
        """Mean synergy components of one subject at one rank, each
        trial's rows aligned to the subject's first trial by cosine."""
        import pandas

        mean = self._subject_mean(rank, subject)
        cols = self.channel_names or range(mean.shape[1])
        return pandas.DataFrame(mean, columns=list(cols))

    def cluster_subjects(self, rank: int, n_clusters: Optional[int] = None):
        """Group-level synergy clusters across subjects at one rank.

        Feeds each subject's trial-averaged components (the arrays of
        :meth:`subject_components`; no pandas) to
        :func:`~muscle_synergies_tpu_torch.models.stability.cluster_synergies`:
        ``.shared`` lists the clusters every subject expresses,
        ``.coverage`` how widely each is shared, ``.consensus`` the
        group-level synergy of each cluster.  Sets follow the subjects'
        order of first appearance, so ``result.labels[j]`` belongs to
        the ``j``-th distinct subject.  Needs at least two subjects.
        """
        from .models.stability import cluster_synergies

        self._require_subjects()
        sets = [self._subject_mean(rank, s) for s in dict.fromkeys(self.subjects)]
        return cluster_synergies(sets, n_clusters=n_clusters)

    def min_rank_reaching(self, vaf_threshold: float = 0.9) -> np.ndarray:
        """Per trial: smallest swept rank whose VAF >= threshold (-1 if none)."""
        reached = self.vaf_overall >= vaf_threshold  # (R, B)
        out = np.full(reached.shape[1], -1, dtype=int)
        for i in sorted(range(len(self.ranks)), key=lambda j: self.ranks[j]):
            newly = reached[i] & (out == -1)
            out[newly] = self.ranks[i]
        return out


def analyze_dataset(
    trials: Union[Sequence, Mapping],
    sampling_frequency: float,
    ranks: Union[int, Sequence[int]] = (1, 2, 3, 4),
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    init: Optional[str] = None,
    solver: Optional[str] = None,
    beta_loss=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    subjects: Optional[Sequence] = None,
    impl: Optional[str] = None,
    inner_iter: Optional[int] = None,
    alpha_W: float = 0.0,
    alpha_H="same",
    l1_ratio: float = 0.0,
    device="cuda",
) -> DatasetResult:
    """Preprocess and factorize a whole multi-trial dataset at once.

    The JAX package's ``analyze_dataset`` with the envelope pipeline.

    Args:
        trials: sequence of ``(N_i, L)`` arrays, tensors or DataFrames,
            a ``(B, N, L)`` array or tensor, or a
            ``{subject: [trials...]}`` mapping.
        ranks: rank or ranks to sweep.
        config: preprocessing + solver preset.
        solver: ``"cd"`` or ``"mu"``; defaults to ``config.solver``.
        beta_loss: ``"frobenius"`` (the default, via
            ``config.beta_loss``), ``"kullback-leibler"``,
            ``"itakura-saito"`` or a float beta; other losses than
            Frobenius need ``solver="mu"`` and ``inner_iter=1``.
        impl: batched-solver implementation, ``"auto"``, ``"torch"`` or
            ``"cuda"`` (the JAX names ``"xla"``/``"pallas"`` map onto
            the last two); defaults to ``config.solver_impl``.
        alpha_W / alpha_H / l1_ratio: sklearn's dimension-scaled
            penalties (the kernels take them too).
        dtype, device: where and in what type to run the whole pipeline:
            the card by default, in float32 unless ``dtype`` says
            otherwise; ``device="cpu"`` runs the plain versions.
        mesh: optional ``(data, time)`` mesh: the preprocessing as on
            :func:`preprocess_trials`, and the grid solved by
            ``sharded_fit_mu`` / ``sharded_fit_cd`` / ``sharded_fit_beta``
            (fits over ``data``, samples over ``time``; ``impl`` is
            ignored there).  A fit count that does not divide the data
            axis gains copies that are dropped; a sample count that
            does not divide the time axis warns and falls back to the
            local solver, as does a mesh without those axes.

    Returns:
        :class:`DatasetResult` over the full ``(rank, trial)`` grid.
    """
    trials, subjects = _normalize_trials_subjects(trials, subjects)
    sweep = _sweep_options(config, ranks, mesh=mesh, init=init, solver=solver,
                           beta_loss=beta_loss, max_iter=max_iter, tol=tol,
                           seed=seed, impl=impl, inner_iter=inner_iter,
                           alpha_W=alpha_W, alpha_H=alpha_H, l1_ratio=l1_ratio)
    channel_names = _channel_names(trials[0]) if len(trials) else None
    device, dtype = entry_placement(device, dtype)
    _check_reduce_to(config)
    xs, mask = _stage_trials(trials, device, dtype)
    res = _analyze_batch(xs, mask, sampling_frequency, config, sweep)
    res.channel_names, res.subjects = channel_names, subjects
    return res


@dataclass(frozen=True)
class _Sweep:
    """:func:`analyze_dataset`'s validated solver options."""

    ranks: tuple
    init: Optional[str]
    solver: str
    beta: float
    max_iter: int
    tol: float
    seed: int
    impl: str
    inner_iter: int
    alpha_W: float
    alpha_H: object
    l1_ratio: float
    mesh: object = None


def _sweep_options(
    config: PipelineConfig,
    ranks,
    mesh=None,
    init: Optional[str] = None,
    solver: Optional[str] = None,
    beta_loss=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    seed: int = 0,
    impl: Optional[str] = None,
    inner_iter: Optional[int] = None,
    alpha_W: float = 0.0,
    alpha_H="same",
    l1_ratio: float = 0.0,
) -> _Sweep:
    """Resolve and check :func:`analyze_dataset`'s solver keywords
    against ``config`` before any trial is touched."""
    mesh = usable_mesh(mesh, "analyze_dataset", then="local single-device path")
    ranks = (ranks,) if isinstance(ranks, int) else tuple(ranks)
    solver = solver if solver is not None else config.solver
    if solver not in {"mu", "cd"}:
        raise ValueError(f"unknown solver: {solver!r}")
    beta_loss = beta_loss if beta_loss is not None else config.beta_loss
    beta = beta_loss_to_float(beta_loss)
    if beta != 2.0 and solver != "mu":
        raise ValueError(
            f"beta_loss={beta_loss!r} requires solver='mu', got {solver!r}"
        )
    inner_iter = inner_iter if inner_iter is not None else config.inner_iter
    if beta != 2.0 and inner_iter != 1:
        raise ValueError(
            "inner_iter > 1 is only available for the Frobenius objective"
        )
    if inner_iter != 1 and solver != "mu":
        raise ValueError("inner_iter > 1 is only meaningful for solver='mu'")
    return _Sweep(
        ranks=ranks, init=init, solver=solver, beta=beta,
        max_iter=max_iter if max_iter is not None else config.max_iter,
        tol=tol if tol is not None else config.tol, seed=seed,
        impl=torch_impl(impl if impl is not None else config.solver_impl),
        inner_iter=inner_iter, alpha_W=alpha_W, alpha_H=alpha_H, l1_ratio=l1_ratio,
        mesh=mesh,
    )


def _analyze_batch(xs: torch.Tensor, mask: Optional[torch.Tensor],
                   sampling_frequency: float, config: PipelineConfig,
                   sweep: _Sweep) -> DatasetResult:
    """Preprocess one staged batch where it lies and solve its whole
    ``(rank, trial)`` grid in one batched fit; only the results come
    back to the host."""
    xs = _preprocess_batch(xs, mask, sampling_frequency, config, sweep.mesh)
    ranks, beta = sweep.ranks, sweep.beta
    if beta <= 0 and bool((xs == 0).any()):
        raise ValueError(
            "When beta_loss <= 0 and X contains zeros, the solver may "
            "diverge. Please add small values to X, or use a positive "
            "beta_loss."
        )
    b, n, l = xs.shape
    k_max = max(ranks)
    l1_w, l2_w, l1_h, l2_h = compute_regularization(
        sweep.alpha_W, sweep.alpha_H, sweep.l1_ratio, n, l
    )

    # the (R * B) problem grid with rank-padded factors, one batched
    # initialization per rank
    w_blocks, h_blocks = [], []
    for k in ranks:
        w0, h0 = init_batch(xs, k, init=sweep.init, seed=sweep.seed)
        w_blocks.append(torch.nn.functional.pad(w0, (0, k_max - k)))
        h_blocks.append(torch.nn.functional.pad(h0, (0, 0, 0, k_max - k)))
    grid_x = xs.repeat(len(ranks), 1, 1)
    grid_w = torch.cat(w_blocks)
    grid_h = torch.cat(h_blocks)
    regs = dict(l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h, l2_reg_h=l2_h,
                max_iter=sweep.max_iter, tol=sweep.tol, impl=sweep.impl)
    mesh = usable_mesh(sweep.mesh, "analyze_dataset", n, hint=(
        " Adjust reduce_to or the mesh shape to keep the fit sharded."))
    if mesh is not None:
        from .parallel import sharded_fit_beta, sharded_fit_cd, sharded_fit_mu

        n_fits = grid_x.shape[0]
        regs.pop("impl")
        grids = pad_fits(axis_size(mesh, DATA_AXIS), grid_x, grid_w, grid_h)
        if beta != 2.0:
            state = sharded_fit_beta(*grids, mesh, beta=beta, **regs)
        elif sweep.solver == "mu":
            state = sharded_fit_mu(*grids, mesh, inner_iter=sweep.inner_iter, **regs)
        else:
            state = sharded_fit_cd(*grids, mesh, **regs)
        state = gathered(state, n_fits)
        h_final = state.ht.transpose(-1, -2) if sweep.solver == "cd" else state.h
    elif sweep.solver == "mu":
        if beta != 2.0:
            state = fit_mu_beta_batch(grid_x, grid_w, grid_h, beta=beta, **regs)
        else:
            state = fit_mu_batch(grid_x, grid_w, grid_h,
                                 inner_iter=sweep.inner_iter, **regs)
        h_final = state.h
    else:
        state = fit_cd_batch(grid_x, grid_w, grid_h, **regs)
        h_final = state.ht.transpose(-1, -2)
    overall, per_channel = vaf_batch(grid_x, state.w, h_final)
    r = len(ranks)
    return DatasetResult(
        ranks=ranks,
        w=to_numpy(state.w).reshape(r, b, n, k_max),
        h=to_numpy(h_final).reshape(r, b, k_max, l),
        vaf_overall=to_numpy(overall).reshape(r, b),
        vaf_per_channel=to_numpy(per_channel).reshape(r, b, l),
        n_iter=to_numpy(state.n_iter).reshape(r, b),
        converged=to_numpy(state.converged).reshape(r, b),
    )


def _default_capture_loader(path):
    """Parse one Vicon capture and return its EMG ``DeviceData``."""
    from .io.vicon import load_vicon_file

    return load_vicon_file(path).emg


def _concat_dataset_results(
    partials: Sequence[DatasetResult],
    channel_names=None,
    subjects=None,
    sampling_frequency=None,
) -> DatasetResult:
    """Stitch per-chunk grid results back into one dataset result."""
    def cat(name):
        return np.concatenate([getattr(p, name) for p in partials], axis=1)

    return DatasetResult(
        ranks=partials[0].ranks,
        w=cat("w"),
        h=cat("h"),
        vaf_overall=cat("vaf_overall"),
        vaf_per_channel=cat("vaf_per_channel"),
        n_iter=cat("n_iter"),
        converged=cat("converged"),
        channel_names=channel_names,
        subjects=list(subjects) if subjects is not None else None,
        sampling_frequency=sampling_frequency,
    )


def analyze_dataset_pipelined(
    paths: Sequence,
    sampling_frequency: Optional[float] = None,
    ranks: Union[int, Sequence[int]] = (1, 2, 3, 4),
    config: PipelineConfig = PipelineConfig(),
    chunk_files: int = 2,
    prefetch: int = 2,
    loader=None,
    subjects: Optional[Sequence] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    **fit_kwargs,
) -> DatasetResult:
    """:func:`analyze_dataset` over capture *files*, parse and compute
    overlapped.

    A producer thread parses ``chunk_files`` captures at a time, pads
    each chunk on the host straight into pinned buffers of the compute
    dtype (float32 on the card) and stages it on the device on a side
    CUDA stream (:func:`~muscle_synergies_tpu_torch.io.batch.device_prefetch`,
    up to ``prefetch`` chunks ahead), while the consumer preprocesses
    the chunk already resident (one K3 launch on the card, each trial
    of a ragged chunk filtered over its own length) and solves its
    ``(rank, trial)`` grid.  The trials cross host->device once and
    never come back; only each chunk's results do.

    Chunked solves match the one-shot :func:`analyze_dataset` to
    float-reordering tolerance (a chunk's batch size changes how the
    batched products block); inits are per-trial deterministic, so the
    grids are otherwise identical.  One chunk over all the files gives
    the one-shot result exactly.

    Args:
        paths: capture CSV paths (or any values ``loader`` accepts).
        sampling_frequency: EMG rate; when ``None`` it is taken from
            the first capture and every file is checked against it.
        chunk_files: captures per pipeline stage: one batched
            preprocess and grid solve each.
        prefetch: chunks the producer may stage ahead (the pipeline
            depth); ``device_prefetch``'s buffer size.
        loader: ``path -> DataFrame | DeviceData | array`` parse hook;
            defaults to loading the capture's EMG device.
        dtype, device: as on :func:`analyze_dataset`: the card by
            default, in float32 there.
        fit_kwargs: :func:`analyze_dataset`'s solver keywords
            (``solver``, ``beta_loss``, ``impl``, ``max_iter``, ``tol``,
            ...), checked before any capture is parsed.

    Returns:
        :class:`DatasetResult` over the full grid, with
        ``sampling_frequency`` filled in from the captures.
    """
    from .io.batch import device_prefetch

    paths = list(paths)
    if not paths:
        raise ValueError("analyze_dataset_pipelined needs at least one path")
    if chunk_files < 1:
        raise ValueError(f"chunk_files must be >= 1, got {chunk_files}")
    if subjects is not None:
        subjects = list(subjects)
        if len(subjects) != len(paths):
            raise ValueError(
                f"got {len(subjects)} subject labels for {len(paths)} paths"
            )
    loader = loader if loader is not None else _default_capture_loader
    sweep = _sweep_options(config, ranks, **fit_kwargs)
    device, dtype = entry_placement(device, dtype)
    _check_reduce_to(config)
    pin = device.type == "cuda"

    # filled by the producer before its first yield; the prefetch
    # queue's put/get ordering makes them visible to the consumer
    first_meta: dict = {}

    def parsed_chunks():
        fs = sampling_frequency
        for lo in range(0, len(paths), chunk_files):
            group = paths[lo : lo + chunk_files]
            arrays = []
            for path in group:
                cap = loader(path)
                cap_fs = getattr(cap, "sampling_frequency", None)
                if fs is None:
                    fs = cap_fs
                elif cap_fs is not None and cap_fs != fs:
                    raise ValueError(
                        f"{path}: EMG sampling rate {cap_fs} != {fs} "
                        f"of the first capture"
                    )
                if not first_meta:
                    if fs is None:
                        raise ValueError(
                            "pass sampling_frequency=: the loader's "
                            "output does not carry one"
                        )
                    first_meta.update(names=_channel_names(cap), fs=float(fs))
                arrays.append(to_numpy(_as_array(cap)))
            yield _pad_trials(arrays, dtype, pin)

    partials = [
        _analyze_batch(xs, mask, first_meta["fs"], config, sweep)
        for xs, mask in device_prefetch(parsed_chunks(), buffer_size=prefetch,
                                        device=device)
    ]
    return _concat_dataset_results(
        partials,
        channel_names=first_meta["names"],
        subjects=subjects,
        sampling_frequency=first_meta["fs"],
    )


@dataclass
class TimeVaryingDatasetResult:
    """Best-restart time-varying synergies for every trial of a dataset.

    Attributes (NumPy arrays, as in the JAX package):
        n_lags: temporal extent ``D`` of each synergy, in samples.
        c: ``(B, T, K)`` winning activation trains (rescaled by
            :func:`~muscle_synergies_tpu_torch.models.cnmf.normalize_synergies`).
        s: ``(B, K, D, L)`` winning synergies, unit Frobenius norm.
        vaf_overall: ``(B,)`` total VAF of each reconstruction.
        vaf_per_channel: ``(B, L)``.
        n_iter: ``(B,)`` iterations used by each winning restart.
        converged: ``(B,)`` convergence flags of the winners.
        restart_errors: ``(B, n_inits)`` final Frobenius errors of all
            restarts (the winner is each row's argmin).
        channel_names / subjects: as on :class:`DatasetResult`.
    """

    n_lags: int
    c: np.ndarray
    s: np.ndarray
    vaf_overall: np.ndarray
    vaf_per_channel: np.ndarray
    n_iter: np.ndarray
    converged: np.ndarray
    restart_errors: np.ndarray
    channel_names: Optional[List[str]] = None
    subjects: Optional[List] = None

    def synergies(self, trial: int):
        """``{k: (n_lags, L) DataFrame}`` patterns of one trial."""
        import pandas

        cols = self.channel_names or range(self.s.shape[-1])
        return {
            k: pandas.DataFrame(self.s[trial, k], columns=list(cols))
            for k in range(self.s.shape[1])
        }

    def activations(self, trial: int):
        """``(T, K)`` recruitment trains of one trial, as a DataFrame."""
        import pandas

        k = self.c.shape[-1]
        return pandas.DataFrame(
            self.c[trial], columns=[f"synergy {i}" for i in range(k)]
        )

    def vaf_table(self):
        """Per-trial overall VAF Series (subject/trial MultiIndex when
        labeled)."""
        import pandas

        b = self.vaf_overall.shape[0]
        if self.subjects is not None:
            index = pandas.MultiIndex.from_arrays(
                [self.subjects, range(b)], names=["subject", "trial"]
            )
        else:
            index = pandas.RangeIndex(b, name="trial")
        return pandas.Series(self.vaf_overall, index=index, name="vaf")

    def _require_subjects(self):
        if self.subjects is None:
            raise ValueError(
                "no subject labels: pass subjects= (or a {subject: trials} "
                "mapping) to analyze_dataset_time_varying"
            )

    def _subject_vaf_means(self) -> dict:
        """``subject_table("mean")``'s array core (no pandas): ``{subject:
        mean overall VAF}`` in the subjects' first-appearance order."""
        self._require_subjects()
        return _subject_means(self.vaf_overall, self.subjects)

    def subject_table(self, statistic: str = "mean"):
        """Per-subject VAF aggregated over trials."""
        import pandas

        self._require_subjects()
        if statistic == "mean":
            means = self._subject_vaf_means()
            return pandas.Series(np.stack(list(means.values())), name="vaf",
                                 index=pandas.Index(list(means), name="subject"))
        return self.vaf_table().groupby(level="subject", sort=False).agg(
            statistic
        )

    def to_trial_result(self, trial: int) -> TimeVaryingSynergyResult:
        """One trial repackaged as a
        :class:`~muscle_synergies_tpu_torch.models.cnmf.TimeVaryingSynergyResult`."""
        import pandas

        cols = list(self.channel_names or range(self.s.shape[-1]))
        return TimeVaryingSynergyResult(
            synergies=self.synergies(trial),
            activations=self.activations(trial),
            vaf=float(self.vaf_overall[trial]),
            vaf_per_muscle=pandas.Series(
                self.vaf_per_channel[trial], index=cols
            ),
            n_iter=int(self.n_iter[trial]),
            restart_errors=self.restart_errors[trial],
        )


def analyze_dataset_time_varying(
    trials: Union[Sequence, Mapping],
    sampling_frequency: float,
    n_synergies: int,
    n_lags: int,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    n_inits: int = 4,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    subjects: Optional[Sequence] = None,
    impl: Optional[str] = None,
    precision=None,
    device="cuda",
) -> TimeVaryingDatasetResult:
    """Preprocess a dataset and extract time-varying synergies per trial.

    The JAX package's ``analyze_dataset_time_varying``: all ``B``
    trials' ``n_inits`` random restarts join one ``(B * n_inits)``
    batched convolutive fit (trial-major, restarts contiguous, restart
    ``i`` of the grid seeded ``seed + i`` by :func:`init_cnmf`), and
    each trial's lowest-error restart is returned with unit-norm
    synergies.

    Args:
        trials / sampling_frequency / config / subjects: as on
            :func:`analyze_dataset`.
        n_synergies: number of time-varying synergies ``K`` per trial.
        n_lags: temporal extent ``D`` of each synergy, in samples of the
            time-normalized trials.
        max_iter / tol: sklearn-style stopping; default to the config's.
        n_inits: random restarts per trial, solved in the same batch.
        impl: ``"auto"``, ``"torch"`` or ``"cuda"`` for the batched fit
            (the JAX names ``"xla"``/``"pallas"`` map onto the last
            two); defaults to ``config.solver_impl``.
        precision: matmul precision of the plain fit's contractions, as
            the JAX package takes it (``None`` or ``"highest"``: full
            float32; ``"high"``: TF32 allowed); the kernel K5 computes in
            float32 whatever it says.
        dtype, device: as on :func:`analyze_dataset`: the card by
            default, in float32; ``device="cpu"`` runs the plain
            versions.
        mesh: optional ``(data, time)`` mesh: the preprocessing as on
            :func:`preprocess_trials`, and the restart grid through
            ``sharded_fit_cnmf`` (fits over ``data``, samples over
            ``time``, lag halos between neighbours; ``impl`` is ignored
            there).  A trial length that does not divide the time axis,
            or whose shards are shorter than the lag halo, warns and
            falls back to the local solver.

    Returns:
        :class:`TimeVaryingDatasetResult` over all trials.
    """
    trials, subjects = _normalize_trials_subjects(trials, subjects)
    mesh = usable_mesh(mesh, "analyze_dataset_time_varying",
                       then="local single-device path")
    if n_synergies < 1:
        raise ValueError(f"n_synergies must be >= 1, got {n_synergies}")
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")
    max_iter = max_iter if max_iter is not None else config.max_iter
    tol = tol if tol is not None else config.tol
    impl = torch_impl(impl if impl is not None else config.solver_impl)

    channel_names = _channel_names(trials[0]) if len(trials) else None
    xs = preprocess_trials(trials, sampling_frequency, config, dtype=dtype,
                           mesh=mesh, device=device)
    b, t, l = xs.shape
    if not 1 <= n_lags <= t:
        raise ValueError(
            f"n_lags must be in [1, n_samples={t}], got {n_lags}"
        )

    # the restart grid: trial-major, restarts contiguous, factors drawn
    # on the host exactly as the JAX package draws them
    c0, s0 = init_cnmf(np.repeat(to_numpy(xs), n_inits, axis=0), n_synergies,
                       n_lags, seed=seed)
    grid = (xs.repeat_interleave(n_inits, dim=0), as_tensor(c0, xs.device),
            as_tensor(s0, xs.device))
    mesh = usable_mesh(mesh, "analyze_dataset_time_varying", t, n_lags - 1)
    if mesh is not None:
        from .parallel import sharded_fit_cnmf

        state = sharded_fit_cnmf(*pad_fits(axis_size(mesh, DATA_AXIS), *grid), mesh,
                                 max_iter=max_iter, tol=tol, precision=precision)
        state = gathered(state, b * n_inits)
    else:
        state = fit_cnmf_batch(*grid, max_iter=max_iter, tol=tol, impl=impl,
                               precision=precision)

    errors = to_numpy(state.previous_error).reshape(b, n_inits)
    best = np.arange(b) * n_inits + np.argmin(errors, axis=1)
    best_dev = torch.as_tensor(best, device=xs.device)
    c_best, s_best = normalize_synergies(state.c[best_dev], state.s[best_dev])
    err2 = ((xs - cnmf_reconstruct(c_best, s_best)) ** 2).sum(dim=1)  # (B, L)
    tot2 = (xs * xs).sum(dim=1)
    per_channel = 1.0 - err2 / torch.where(tot2 == 0, 1.0, tot2)
    overall = 1.0 - err2.sum(dim=-1) / tot2.sum(dim=-1).clamp(min=EPSILON)

    return TimeVaryingDatasetResult(
        n_lags=n_lags,
        c=to_numpy(c_best),
        s=to_numpy(s_best),
        vaf_overall=to_numpy(overall),
        vaf_per_channel=to_numpy(per_channel),
        n_iter=to_numpy(state.n_iter)[best],
        converged=to_numpy(state.converged)[best],
        restart_errors=errors,
        channel_names=channel_names,
        subjects=subjects,
    )


class SpaceByTimeDatasetResult:
    """Shared space-by-time modules for a whole dataset (NM3F).

    The modules are the dataset-level quantity: every trial is one small
    coefficient matrix against the shared temporal and spatial modules
    (Delis et al. 2014; :mod:`~muscle_synergies_tpu_torch.models.nm3f`).
    The constructor takes the JAX package's fields in its order; the
    modules are kept as arrays (``w``, ``s``), and
    :attr:`temporal_modules` / :attr:`spatial_modules` build their
    DataFrames when read (pandas), so the result needs no pandas until
    then.

    Attributes:
        n_temporal / n_spatial: module counts ``P`` / ``Q``.
        w / s: the temporal ``(T, P)`` and spatial ``(Q, L)`` modules
            as NumPy arrays.
        temporal_modules: ``(T, P)`` DataFrame, unit-norm columns.
        spatial_modules: ``(Q, L)`` DataFrame, unit-norm rows, columns
            named after the channels when the trials carry labels.
        coefficients: ``(B, P, Q)`` per-trial mixing coefficients.
        vaf_overall: overall VAF across the dataset (scalar float).
        vaf_per_trial: ``(B,)``.
        vaf_per_channel: ``(B, L)``.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
        channel_names / subjects: as on :class:`DatasetResult`.
    """

    def __init__(self, n_temporal: int, n_spatial: int, temporal_modules,
                 spatial_modules, coefficients: np.ndarray, vaf_overall: float,
                 vaf_per_trial: np.ndarray, vaf_per_channel: np.ndarray, n_iter: int,
                 restart_errors: np.ndarray, channel_names: Optional[List[str]] = None,
                 subjects: Optional[List] = None):
        self.n_temporal = n_temporal
        self.n_spatial = n_spatial
        self.w = np.asarray(temporal_modules)
        self.s = np.asarray(spatial_modules)
        self.coefficients = coefficients
        self.vaf_overall = vaf_overall
        self.vaf_per_trial = vaf_per_trial
        self.vaf_per_channel = vaf_per_channel
        self.n_iter = n_iter
        self.restart_errors = restart_errors
        self.channel_names = channel_names
        self.subjects = subjects

    @property
    def temporal_modules(self):
        """``(T, P)`` DataFrame, columns ``"temporal i"``."""
        return _temporal_frame(self.w)

    @property
    def spatial_modules(self):
        """``(Q, L)`` DataFrame, columns named after the channels."""
        import pandas

        cols = self.channel_names or range(self.s.shape[1])
        return pandas.DataFrame(self.s, columns=list(cols))

    def vaf_table(self):
        """Per-trial VAF Series (subject/trial MultiIndex when labeled)."""
        import pandas

        b = self.vaf_per_trial.shape[0]
        if self.subjects is not None:
            index = pandas.MultiIndex.from_arrays(
                [self.subjects, range(b)], names=["subject", "trial"]
            )
        else:
            index = pandas.RangeIndex(b, name="trial")
        return pandas.Series(self.vaf_per_trial, index=index, name="vaf")

    def subject_table(self, statistic: str = "mean"):
        """Per-subject VAF aggregated over trials."""
        if self.subjects is None:
            raise ValueError(
                "no subject labels: pass subjects= (or a {subject: "
                "trials} mapping) to analyze_dataset_space_by_time"
            )
        return self.vaf_table().groupby(level="subject", sort=False).agg(
            statistic
        )

    def to_result(self):
        """Repackage as a
        :class:`~muscle_synergies_tpu_torch.models.nm3f.SpaceByTimeResult`."""
        return SpaceByTimeResult(
            temporal_modules=self.temporal_modules,
            spatial_modules=self.spatial_modules,
            coefficients=self.coefficients,
            vaf=self.vaf_overall,
            vaf_per_trial=self.vaf_per_trial,
            n_iter=self.n_iter,
            restart_errors=self.restart_errors,
        )


def analyze_dataset_space_by_time(
    trials: Union[Sequence, Mapping],
    sampling_frequency: float,
    n_temporal: int,
    n_spatial: int,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    n_inits: int = 4,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    subjects: Optional[Sequence] = None,
    precision=None,
    device="cuda",
) -> SpaceByTimeDatasetResult:
    """Preprocess a dataset and extract its space-by-time synergies.

    The JAX package's ``analyze_dataset_space_by_time``: the trials go
    through :func:`preprocess_trials` (one K3 launch on the card), then
    one NM3F fit over the whole stack, its ``n_inits`` restarts at once
    on the device, gives shared temporal and spatial modules and one
    small coefficient matrix per trial.  Needs no pandas.

    Args:
        trials / sampling_frequency / config / subjects: as on
            :func:`analyze_dataset`.
        n_temporal / n_spatial: module counts ``P`` / ``Q``.
        max_iter / tol: sklearn-style stopping; default to the config's.
        n_inits: random restarts, each a whole-dataset fit (restart
            ``r`` seeded ``seed + r``).
        precision: matmul precision of every NM3F product (``None``:
            full float32; ``"high"``: TF32 allowed).
        dtype, device: as on :func:`analyze_dataset`: the card by
            default, in float32; ``device="cpu"`` runs on the CPU.
        mesh: optional ``(data, time)`` mesh: the preprocessing as on
            :func:`preprocess_trials`, and each restart through
            ``sharded_fit_nm3f`` (trials over ``data``, the shared time
            base over ``time``; see
            :func:`~.models.nm3f.find_space_by_time_synergies`).

    Returns:
        :class:`SpaceByTimeDatasetResult` for the whole dataset.
    """
    trials, subjects = _normalize_trials_subjects(trials, subjects)
    mesh = usable_mesh(mesh, "analyze_dataset_space_by_time",
                       then="local single-device path")
    max_iter = max_iter if max_iter is not None else config.max_iter
    tol = tol if tol is not None else config.tol
    channel_names = _channel_names(trials[0]) if len(trials) else None

    xs = preprocess_trials(trials, sampling_frequency, config, dtype=dtype,
                           mesh=mesh, device=device)
    xs, _ = _validate_trial_stack(xs, xs.device, xs.dtype,
                                  empty="empty trial stack passed to NM3F")
    fit = _fit_space_by_time(xs, n_temporal, n_spatial, max_iter, tol, n_inits,
                             seed, precision, mesh=mesh)
    w, a, s = (as_tensor(f, xs.device) for f in (fit.w, fit.a, fit.s))
    err2 = ((xs - w @ a @ s) ** 2).sum(dim=1)  # (B, L)
    tot2 = (xs * xs).sum(dim=1)
    return SpaceByTimeDatasetResult(
        n_temporal=n_temporal,
        n_spatial=n_spatial,
        temporal_modules=fit.w,
        spatial_modules=fit.s,
        coefficients=fit.a,
        vaf_overall=fit.vaf,
        vaf_per_trial=fit.vaf_per_trial,
        vaf_per_channel=to_numpy(1.0 - err2 / torch.where(tot2 == 0, 1.0, tot2)),
        n_iter=fit.n_iter,
        restart_errors=fit.restart_errors,
        channel_names=channel_names,
        subjects=subjects,
    )
