"""Carry state from the JAX package into this one.

The JAX package cannot be imported next to this one on a machine
without jax, so what crosses over is data: NumPy arrays (from
``numpy.asarray`` on JAX arrays) and JSON.  Feeding both packages the
same inputs this way is how the tests hold the port to the reference.

- :func:`initial_factors`: initial W ``(..., N, k)`` and H
  ``(..., k, L)``, e.g. an init drawn with ``jax.random``;
- :func:`ht_from_h` / :func:`h_from_ht`: CD's ``ht`` layout
  ``(..., L, k)``;
- :func:`mu_state` / :func:`cd_state` / :func:`beta_state` /
  :func:`cnmf_state`: a JAX ``MUState`` / ``CDState`` / ``BetaState`` /
  ``CNMFState`` (any object with those fields);
- :func:`dataset_result`: a JAX ``DatasetResult``;
- :func:`nmf_model`: a fitted JAX ``NMFModel`` (its settings and fitted
  attributes), so that ``transform`` runs on either side;
- :func:`pipeline_config`: a ``PipelineConfig`` JSON string.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ._common import as_tensor
from .dataset import DatasetResult
from .models.beta import BetaState
from .models.cnmf import CNMFState
from .models.hals import CDState
from .models.mu import MUState
from .models.select import NMFModel
from .utils.config import PipelineConfig

__all__ = [
    "initial_factors",
    "ht_from_h",
    "h_from_ht",
    "mu_state",
    "cd_state",
    "beta_state",
    "cnmf_state",
    "dataset_result",
    "nmf_model",
    "pipeline_config",
]


def initial_factors(
    w, h, device=None, dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """W and H arrays as tensors on ``device`` in ``dtype``."""
    w, h = as_tensor(w, device, dtype), as_tensor(h, device, dtype)
    if w.shape[-1] != h.shape[-2]:
        raise ValueError(f"W {tuple(w.shape)} and H {tuple(h.shape)} ranks differ")
    return w, h


def ht_from_h(h: torch.Tensor) -> torch.Tensor:
    """H ``(..., k, L)`` in CD's ``ht`` layout ``(..., L, k)``."""
    return h.transpose(-1, -2)


def h_from_ht(ht: torch.Tensor) -> torch.Tensor:
    """CD's ``ht`` ``(..., L, k)`` back to H ``(..., k, L)``."""
    return ht.transpose(-1, -2)


def _field(state, name, device, dtype=None):
    # a copy: NumPy views of JAX arrays are read-only
    return as_tensor(np.array(getattr(state, name)), device, dtype)


def mu_state(state, device=None, dtype: Optional[torch.dtype] = None) -> MUState:
    """A JAX ``MUState`` (arrays or NumPy) as this package's :class:`MUState`."""
    return MUState(
        w=_field(state, "w", device, dtype),
        h=_field(state, "h", device, dtype),
        n_iter=_field(state, "n_iter", device, torch.int32),
        previous_error=_field(state, "previous_error", device, dtype),
        converged=_field(state, "converged", device, torch.bool),
    )


def cd_state(state, device=None, dtype: Optional[torch.dtype] = None) -> CDState:
    """A JAX ``CDState`` as this package's :class:`CDState` (``ht`` kept)."""
    return CDState(
        w=_field(state, "w", device, dtype),
        ht=_field(state, "ht", device, dtype),
        n_iter=_field(state, "n_iter", device, torch.int32),
        violation_init=_field(state, "violation_init", device, dtype),
        converged=_field(state, "converged", device, torch.bool),
    )


def beta_state(state, device=None, dtype: Optional[torch.dtype] = None) -> BetaState:
    """A JAX ``BetaState`` as this package's :class:`BetaState`."""
    return BetaState(*mu_state(state, device, dtype))


def cnmf_state(state, device=None, dtype: Optional[torch.dtype] = None) -> CNMFState:
    """A JAX ``CNMFState`` as this package's :class:`CNMFState`."""
    return CNMFState(
        c=_field(state, "c", device, dtype),
        s=_field(state, "s", device, dtype),
        n_iter=_field(state, "n_iter", device, torch.int32),
        previous_error=_field(state, "previous_error", device, dtype),
        converged=_field(state, "converged", device, torch.bool),
    )


def dataset_result(result) -> DatasetResult:
    """A JAX ``DatasetResult`` as this package's :class:`DatasetResult`."""
    subjects = getattr(result, "subjects", None)
    names = getattr(result, "channel_names", None)
    return DatasetResult(
        ranks=tuple(result.ranks),
        w=np.asarray(result.w),
        h=np.asarray(result.h),
        vaf_overall=np.asarray(result.vaf_overall),
        vaf_per_channel=np.asarray(result.vaf_per_channel),
        n_iter=np.asarray(result.n_iter),
        converged=np.asarray(result.converged),
        channel_names=list(names) if names is not None else None,
        subjects=list(subjects) if subjects is not None else None,
        sampling_frequency=getattr(result, "sampling_frequency", None),
    )


_NMF_SETTINGS = ("n_components", "solver", "beta_loss", "init", "tol", "max_iter",
                 "random_state", "alpha_W", "alpha_H", "l1_ratio", "svd_method",
                 "inner_iter", "verbose")


def nmf_model(model, device="cuda", dtype: Optional[torch.dtype] = None) -> NMFModel:
    """A fitted JAX ``NMFModel`` as this package's :class:`NMFModel`.

    Carries the constructor settings (the legacy ``alpha=`` /
    ``regularization=`` too) and the fitted ``components_``,
    ``n_components_``, ``n_iter_`` and ``reconstruction_err_`` as NumPy
    arrays and numbers; ``device`` / ``dtype`` are where the port's
    model then runs.
    """
    kwargs = {name: getattr(model, name) for name in _NMF_SETTINGS}
    legacy = getattr(model, "_legacy_alpha", None)
    if legacy is not None:
        kwargs["alpha"], kwargs["regularization"] = legacy
    out = NMFModel(**kwargs, device=device, dtype=dtype)
    if hasattr(model, "components_"):
        out.components_ = np.array(model.components_)
        out.n_components_ = int(model.n_components_)
        out.n_iter_ = int(model.n_iter_)
        out.reconstruction_err_ = float(model.reconstruction_err_)
    return out


def pipeline_config(text: str) -> PipelineConfig:
    """A ``PipelineConfig`` JSON written by either package."""
    return PipelineConfig.from_json(text)
