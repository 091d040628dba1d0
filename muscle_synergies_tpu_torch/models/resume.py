"""Checkpoint/resume forms of the long-running sweeps.

Port of :mod:`muscle_synergies_tpu.models.resume`: bootstrap stability
and Wold cross-validation for every model family, each unit of work
published to a :class:`~..utils.checkpoint.GridCheckpoint` before the
next starts, so a job cut short (a pre-empted node) restarts from
what it finished:

- the ``bootstrap_*_checkpointed`` functions split the resamples into
  chunks of ``chunk_size``; each chunk is one call of the one-shot
  function, whose batch puts the reference fit as row 0 before the
  chunk's resamples (one K1 or K5 launch a chunk on the card for the
  MU and convolutive bootstraps), and its similarities are saved under
  ``chunk_<lo>_<hi>``.  A fully restored job refits only the reference
  (in one call, with the first chunk's resamples beside it);
- the ``cv_*_checkpointed`` functions run the candidates one at a time
  and save each candidate's held-out error column.

The resample draw is made once, up front, with the one-shot call's
``np.random.default_rng(seed)``, and each chunk's rows are handed to
the one-shot function (its ``_resample_plan``), so the chunks fit
exactly the resamples the one-shot call fits.  Each fit in a batch
stops on its own, so a chunk's fits are the one-shot call's fits: on
the card, where K5 gives every fit its own block and K1 its own warp or
the one-shot batch's blocks (a chunk's K1 launch is planned for the
one-shot call's batch: its grid entry splits a fit's rows over as many
blocks as the batch leaves it, which sets the order of the fit's sums),
and in float64 on the CPU, to rounding.  The CV masks depend only on
``(seed, n_repeats, holdout_fraction)``, so they are the same in every
per-candidate call; but a candidate's masked fits share their batched
products with fewer fits than in the one-shot grid, and in float32 on
the card the unconverged ones amplify the changed rounding (measured
5.9e-5 relative on held-out errors over ranks 1-8 at 2,400 x 8; in
float64 the columns agree to 1e-12).

The files are the JAX package's (same keys and arrays), so a directory
started by either package resumes in the other.  Each checkpoint
directory belongs to one job: stored chunks are keyed by position, so
changing the data or parameters between runs without clearing the
directory composes stale results.  ``kwargs`` go to the one-shot
functions, ``device`` / ``dtype`` / ``impl`` included (the card by
default).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.checkpoint import GridCheckpoint
from .stability import (
    BootstrapResult,
    CVResult,
    SpaceByTimeCVResult,
    TimeVaryingBootstrapResult,
    _block_bootstrap_indices,
    bootstrap_shared_spatial_synergies,
    bootstrap_space_by_time,
    bootstrap_synergies,
    bootstrap_temporal_synergies,
    bootstrap_time_varying_synergies,
    cv_rank_selection,
    cv_space_by_time_selection,
    cv_time_varying_rank_selection,
)

__all__ = [
    "bootstrap_synergies_checkpointed",
    "bootstrap_time_varying_synergies_checkpointed",
    "bootstrap_space_by_time_checkpointed",
    "bootstrap_temporal_synergies_checkpointed",
    "bootstrap_shared_spatial_synergies_checkpointed",
    "cv_rank_selection_checkpointed",
    "cv_time_varying_rank_selection_checkpointed",
    "cv_space_by_time_selection_checkpointed",
]

_PathLike = Union[str, os.PathLike]


def _host(x) -> np.ndarray:
    """The input as the JAX package reads it, ``np.asarray(x, dtype=float)``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def _chunks(n_total: int, chunk_size: int):
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    return [(lo, min(lo + chunk_size, n_total)) for lo in range(0, n_total, chunk_size)]


def _run_boot_chunks(ckpt: GridCheckpoint, idx: np.ndarray, chunk_size: int,
                     run_chunk, sim_names: Sequence[str]):
    """Drive the chunks of a resample plan through ``run_chunk``.

    ``run_chunk(rows, lo)`` returns a result (or a tuple of results, one
    per name of ``sim_names``) whose ``similarities`` are per-resample
    arrays; stored chunks are loaded, missing ones computed and saved.
    Returns the concatenated arrays by name and the last result
    computed (``None`` when every chunk was restored).
    """
    parts = {name: [] for name in sim_names}
    live = None
    for lo, hi in _chunks(idx.shape[0], chunk_size):
        key = f"chunk_{lo:05d}_{hi:05d}"
        if ckpt.has(key):
            stored = ckpt.load(key)["arrays"]
            for name in sim_names:
                parts[name].append(stored[name])
            continue
        live = run_chunk(idx[lo:hi], lo)
        results = live if isinstance(live, tuple) else (live,)
        arrays = {name: np.asarray(r.similarities) for name, r in zip(sim_names, results)}
        for name, value in arrays.items():
            parts[name].append(value)
        ckpt.save(key, arrays, meta={"range": [int(lo), int(hi)]})
    return {n: np.concatenate(p, axis=0) for n, p in parts.items()}, live


def _resumed(ckpt, idx, chunk_size, run, sim_names):
    """:func:`_run_boot_chunks`, then the reference fit again when every
    chunk was restored.

    The refit runs the first chunk's batch again (its similarities are
    not used): one call and one launch, as the JAX package's refit of
    one resample, but the reference then shares a batch of the size it
    had in the chunked run.  The NNDSVD init's SVD on the card rounds
    differently for a batch of two (measured: the reference 1.05e-5
    from the one-shot call's, where the chunks' gave it bit for bit).
    """
    sims, live = _run_boot_chunks(ckpt, idx, chunk_size, run, sim_names)
    if live is None:
        live = run(idx[:chunk_size], 0)
    return sims, live


def bootstrap_synergies_checkpointed(
    x,
    n_components: int,
    checkpoint_dir: _PathLike,
    n_boot: int = 50,
    chunk_size: int = 10,
    seed: int = 0,
    backend: str = "npz",
    **kwargs,
) -> BootstrapResult:
    """:func:`~.stability.bootstrap_synergies` with resume.

    Resamples run in chunks of ``chunk_size`` (each one batch of MU
    fits, one K1 launch on the card); completed chunks restore from
    ``checkpoint_dir``.  ``kwargs`` go to the one-shot function
    (``init``, ``max_iter``, ``tol``, ``device``, ``dtype``, ``impl``).
    """
    x_np = _host(x)
    n = x_np.shape[0]
    idx = np.random.default_rng(seed).integers(0, n, size=(n_boot, n))
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return bootstrap_synergies(x_np, n_components, seed=seed,
                                   _resample_plan=(rows, lo), _plan_batch=n_boot + 1,
                                   **kwargs)

    sims, live = _resumed(ckpt, idx, chunk_size, run, ["sims"])
    return BootstrapResult(reference_components=live.reference_components,
                           similarities=sims["sims"])


def bootstrap_time_varying_synergies_checkpointed(
    x,
    n_synergies: int,
    n_lags: int,
    checkpoint_dir: _PathLike,
    n_boot: int = 50,
    chunk_size: int = 10,
    block_len: Optional[int] = None,
    seed: int = 0,
    backend: str = "npz",
    **kwargs,
) -> TimeVaryingBootstrapResult:
    """:func:`~.stability.bootstrap_time_varying_synergies` with
    chunked resume (each chunk one K5 launch on the card)."""
    x_np = _host(x)
    n = x_np.shape[0]
    if block_len is None:
        block_len = min(max(4 * n_lags, 16), n)  # the one-shot default
    idx = _block_bootstrap_indices(n, block_len, n_boot, np.random.default_rng(seed))
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return bootstrap_time_varying_synergies(
            x_np, n_synergies, n_lags, block_len=block_len, seed=seed,
            _resample_plan=(rows, lo), **kwargs)

    sims, live = _resumed(ckpt, idx, chunk_size, run, ["sims"])
    return TimeVaryingBootstrapResult(reference_synergies=live.reference_synergies,
                                      similarities=sims["sims"])


def _trial_resamples(xs, n_boot: int, seed: int):
    """The trial stack on the host and the one-shot draw of trial rows."""
    xs_np = _host(xs)
    b = xs_np.shape[0]
    return xs_np, np.random.default_rng(seed).integers(0, b, size=(n_boot, b))


def bootstrap_space_by_time_checkpointed(
    xs,
    n_temporal: int,
    n_spatial: int,
    checkpoint_dir: _PathLike,
    n_boot: int = 50,
    chunk_size: int = 10,
    seed: int = 0,
    backend: str = "npz",
    **kwargs,
) -> Tuple[BootstrapResult, BootstrapResult]:
    """:func:`~.stability.bootstrap_space_by_time` with chunked resume;
    returns the (temporal, spatial) pair."""
    xs_np, idx = _trial_resamples(xs, n_boot, seed)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return bootstrap_space_by_time(xs_np, n_temporal, n_spatial, seed=seed,
                                       _resample_plan=(rows, lo), **kwargs)

    sims, (ref_w, ref_s) = _resumed(ckpt, idx, chunk_size, run, ["sims_w", "sims_s"])
    return (BootstrapResult(ref_w.reference_components, sims["sims_w"]),
            BootstrapResult(ref_s.reference_components, sims["sims_s"]))


def _shared_factor_checkpointed(fn, xs, k, checkpoint_dir, n_boot, chunk_size,
                                seed, backend, kwargs) -> BootstrapResult:
    xs_np, idx = _trial_resamples(xs, n_boot, seed)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return fn(xs_np, k, seed=seed, _resample_plan=(rows, lo), **kwargs)

    sims, live = _resumed(ckpt, idx, chunk_size, run, ["sims"])
    return BootstrapResult(live.reference_components, sims["sims"])


def bootstrap_temporal_synergies_checkpointed(
    xs, n_temporal: int, checkpoint_dir: _PathLike, n_boot: int = 50,
    chunk_size: int = 10, seed: int = 0, backend: str = "npz", **kwargs,
) -> BootstrapResult:
    """tMod bootstrap with chunked resume."""
    return _shared_factor_checkpointed(
        bootstrap_temporal_synergies, xs, n_temporal, checkpoint_dir, n_boot,
        chunk_size, seed, backend, kwargs)


def bootstrap_shared_spatial_synergies_checkpointed(
    xs, n_spatial: int, checkpoint_dir: _PathLike, n_boot: int = 50,
    chunk_size: int = 10, seed: int = 0, backend: str = "npz", **kwargs,
) -> BootstrapResult:
    """sMod bootstrap with chunked resume."""
    return _shared_factor_checkpointed(
        bootstrap_shared_spatial_synergies, xs, n_spatial, checkpoint_dir, n_boot,
        chunk_size, seed, backend, kwargs)


# ---------------------------------------------------------------------------
# Wold CV / module-count selections with per-candidate resume
# ---------------------------------------------------------------------------

def _run_cv_candidates(ckpt: GridCheckpoint, keys, run_one) -> np.ndarray:
    """Per-candidate held-out columns ``(n_repeats, 1)``, restored where
    stored, joined into ``(n_repeats, n_candidates)``."""
    cols = []
    for key, cand in keys:
        if ckpt.has(key):
            cols.append(ckpt.load(key)["arrays"]["test_error"])
            continue
        col = run_one(cand)
        ckpt.save(key, {"test_error": col}, meta={"candidate": cand})
        cols.append(col)
    return np.concatenate(cols, axis=1)


def cv_rank_selection_checkpointed(
    x,
    ranks: Sequence[int],
    checkpoint_dir: _PathLike,
    backend: str = "npz",
    **kwargs,
) -> CVResult:
    """:func:`~.stability.cv_rank_selection` with per-candidate resume.

    Each rank runs as its own batched loop over the repeats, and its
    held-out error column is saved before the next rank starts.
    ``kwargs`` go to the one-shot function.
    """
    ranks = tuple(int(k) for k in ranks)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)
    test_error = _run_cv_candidates(
        ckpt, [(f"rank_{k}", k) for k in ranks],
        lambda k: cv_rank_selection(x, [k], **kwargs).test_error)
    best = int(ranks[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(ranks, test_error, best)


def cv_time_varying_rank_selection_checkpointed(
    x,
    ranks: Sequence[int],
    n_lags: int,
    checkpoint_dir: _PathLike,
    backend: str = "npz",
    **kwargs,
) -> CVResult:
    """Convolutive synergy-count selection with per-candidate resume."""
    ranks = tuple(int(k) for k in ranks)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)
    test_error = _run_cv_candidates(
        ckpt, [(f"rank_{k}", k) for k in ranks],
        lambda k: cv_time_varying_rank_selection(x, [k], n_lags, **kwargs).test_error)
    best = int(ranks[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(ranks, test_error, best)


def cv_space_by_time_selection_checkpointed(
    xs,
    pairs: Sequence,
    checkpoint_dir: _PathLike,
    backend: str = "npz",
    **kwargs,
) -> SpaceByTimeCVResult:
    """NM3F ``(n_temporal, n_spatial)`` selection with per-candidate resume."""
    pairs = tuple((int(p), int(q)) for p, q in pairs)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)
    test_error = _run_cv_candidates(
        ckpt, [(f"pair_{p}x{q}", (p, q)) for p, q in pairs],
        lambda pq: cv_space_by_time_selection(xs, [pq], **kwargs).test_error)
    best = pairs[int(np.argmin(test_error.mean(axis=0)))]
    return SpaceByTimeCVResult(pairs, test_error, best)
