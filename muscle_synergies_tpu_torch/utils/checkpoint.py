"""Factor checkpointing and rank-sweep resume.

Port of :mod:`muscle_synergies_tpu.utils.checkpoint`.  Every completed
rank of a sweep (:class:`SweepCheckpoint`) or unit of a long job
(:class:`GridCheckpoint`, the store of :mod:`..models.resume`) is saved
as one compressed ``.npz``, written to ``<name>.tmp.npz`` and published
with ``os.replace``, so a restarted job never reads a half-written
file.  The files have the JAX package's layout and keys, so a directory
started by one package resumes in the other.

``backend="orbax"`` keeps the JAX package's layout of that backend, one
directory per sweep rank or key (``<dir>/rank_<k>/``, ``<dir>/<key>/``),
each holding the same arrays and metadata as the npz store's file, as
``data.npz``: written into ``<name>.tmp/`` and published by renaming
the directory, as orbax publishes.  In a job of several processes every
process calls ``save``, the first one writes and all wait for it.  The
values loaded equal the JAX package's orbax store's, but the
directories do not load in each other's package (orbax is a JAX
library): the ``.npz`` files are the format both packages read.
pandas is imported only where a VAF table is built
(:meth:`SweepCheckpoint.load`, :func:`find_synergies_checkpointed`).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

__all__ = [
    "SweepCheckpoint",
    "GridCheckpoint",
    "find_synergies_checkpointed",
]

_KEY_RE = re.compile(r"^[\w\-]+$")


def _directory(directory, backend: str) -> Path:
    if backend not in ("npz", "orbax"):
        raise ValueError(f"backend must be 'npz' or 'orbax', got {backend!r}")
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    return path


def _entries(directory: Path, backend: str, pattern: str):
    """The published entries' stems: ``.npz`` files, or the checkpoint
    directories of the ``orbax`` backend (neither temporary)."""
    if backend == "npz":
        return [p.stem for p in directory.glob(pattern + ".npz")
                if not p.name.endswith(".tmp.npz")]
    return [p.name for p in directory.glob(pattern)
            if p.is_dir() and not p.name.endswith(".tmp")]


def _publish(path: Path, backend: str, **arrays) -> None:
    """Write ``arrays`` at ``path`` atomically: an ``.npz`` through a
    temporary file, or (``orbax``) a directory holding ``data.npz``
    through a temporary directory that is renamed into place."""
    if backend == "npz":
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
        return
    import shutil

    import torch.distributed as dist

    multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if not multi or dist.get_rank() == 0:
        tmp = path.with_name(path.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        np.savez_compressed(tmp / "data.npz", **arrays)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    if multi:
        dist.barrier()


def _open(path: Path, backend: str):
    """``np.load`` of what :func:`_publish` wrote at ``path``."""
    return np.load(path if backend == "npz" else path / "data.npz", allow_pickle=True)


def _meta(meta: Optional[Mapping]) -> np.ndarray:
    return np.array(json.dumps(dict(meta or {})), dtype=object)


class SweepCheckpoint:
    """Directory-backed store of per-rank factorization results.

    Layout: ``<dir>/rank_<k>.npz`` (or the directory ``<dir>/rank_<k>/``
    of the ``orbax`` backend) holding arrays ``w``, ``h``, ``vaf``, the
    VAF table's columns and JSON metadata (iterations, loss).
    """

    def __init__(self, directory: Union[str, os.PathLike], backend: str = "npz"):
        self.directory = _directory(directory, backend)
        self.backend = backend

    def _path(self, rank: int) -> Path:
        suffix = ".npz" if self.backend == "npz" else ""
        return self.directory / f"rank_{rank}{suffix}"

    def completed_ranks(self):
        ranks = []
        for stem in _entries(self.directory, self.backend, "rank_*"):
            try:
                ranks.append(int(stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(ranks)

    def has(self, rank: int) -> bool:
        return self._path(rank).exists()

    def save(self, rank: int, w, h, vaf_values, meta: Optional[Mapping] = None):
        """Publish rank ``rank``: factors (arrays), the VAF table (a
        DataFrame) and JSON-able ``meta``."""
        _publish(
            self._path(rank),
            self.backend,
            w=np.asarray(w),
            h=np.asarray(h),
            vaf=vaf_values.to_numpy(),
            vaf_columns=np.array(list(vaf_values.columns), dtype=object),
            meta=_meta(meta),
        )

    def load(self, rank: int) -> Dict:
        """``{"w", "h", "vaf_values" (a DataFrame), "meta"}`` of one rank."""
        import pandas

        with _open(self._path(rank), self.backend) as data:
            return {
                "w": data["w"],
                "h": data["h"],
                "vaf_values": pandas.DataFrame(data["vaf"],
                                               columns=list(data["vaf_columns"])),
                "meta": json.loads(str(data["meta"])),
            }


class GridCheckpoint:
    """String-keyed directory store of intermediate sweep results.

    Each unit of work (a bootstrap chunk, a CV candidate) saves named
    arrays plus JSON metadata under a caller-chosen key, as
    ``<dir>/<key>.npz`` (or the directory ``<dir>/<key>/`` of the
    ``orbax`` backend).  Keys may contain only word characters and
    dashes, so they stay valid file names everywhere.
    """

    def __init__(self, directory: Union[str, os.PathLike], backend: str = "npz"):
        self.directory = _directory(directory, backend)
        self.backend = backend

    @staticmethod
    def _check_key(key: str) -> str:
        if not _KEY_RE.match(key):
            raise ValueError(f"checkpoint key must match [\\w-]+, got {key!r}")
        return key

    def _path(self, key: str) -> Path:
        suffix = ".npz" if self.backend == "npz" else ""
        return self.directory / f"{self._check_key(key)}{suffix}"

    def completed_keys(self):
        return sorted(_entries(self.directory, self.backend, "*"))

    def has(self, key: str) -> bool:
        return self._path(key).exists()

    def save(self, key: str, arrays: Mapping[str, np.ndarray],
             meta: Optional[Mapping] = None):
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        if "meta" in payload:
            raise ValueError("'meta' is a reserved array name")
        _publish(self._path(key), self.backend, meta=_meta(meta), **payload)

    def load(self, key: str) -> Dict:
        """``{"arrays": {name: array}, "meta": dict}`` of one key."""
        with _open(self._path(key), self.backend) as data:
            return {
                "arrays": {k: data[k] for k in data.files if k != "meta"},
                "meta": json.loads(str(data["meta"])),
            }


def find_synergies_checkpointed(
    processed_emg_df,
    n_components: int,
    max_components: int,
    checkpoint_dir: Union[str, os.PathLike],
    *,
    max_iter: int = 100_000,
    tol: float = 1e-6,
    backend: str = "npz",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    **nmf_kwargs,
):
    """Rank sweep that resumes from previously completed ranks.

    Ranks already in ``checkpoint_dir`` are loaded instead of refit;
    each newly fitted rank is saved before the next starts.  Returns
    :func:`~..models.select.find_synergies`'s
    :class:`~..models.select.SynergyRunResult` (with ``model`` holding
    the stored metadata dict for a restored rank).  ``device`` /
    ``dtype`` / ``nmf_kwargs`` are :class:`~..models.select.NMFModel`'s.
    Needs pandas.
    """
    import pandas

    from ..analysis import vaf as _vaf
    from ..models.select import NMFModel, SynergyRunResult

    if processed_emg_df.empty:
        raise ValueError("empty EMG DataFrame")
    num_features = len(processed_emg_df.columns)
    if (n_components < 1 or n_components > num_features
            or max_components < n_components or max_components > num_features):
        raise ValueError("invalid number of components")

    ckpt = SweepCheckpoint(checkpoint_dir, backend=backend)
    runs = {}
    for k in range(n_components, max_components + 1):
        if ckpt.has(k):
            stored = ckpt.load(k)
            comps = pandas.DataFrame(stored["h"], columns=processed_emg_df.columns)
            runs[k] = SynergyRunResult(stored["vaf_values"], comps, stored["meta"])
            continue
        model = NMFModel(n_components=k, max_iter=max_iter, tol=tol, device=device,
                         dtype=dtype, **nmf_kwargs)
        w = model.fit_transform(processed_emg_df)
        vaf_values = _vaf(processed_emg_df, components=model.components_,
                          transformed_signal=w, device=device)
        comps = pandas.DataFrame(model.components_, columns=processed_emg_df.columns)
        ckpt.save(k, w, model.components_, vaf_values, meta={
            "n_iter": model.n_iter_,
            "reconstruction_err": model.reconstruction_err_,
            "solver": model.solver,
        })
        runs[k] = SynergyRunResult(vaf_values, comps, model)

    vaf_values = pandas.concat([r.vaf_values for r in runs.values()])
    vaf_values.set_index(np.array(tuple(runs)), inplace=True)
    return SynergyRunResult(
        vaf_values,
        {k: r.components for k, r in runs.items()},
        {k: r.model for k, r in runs.items()},
    )
