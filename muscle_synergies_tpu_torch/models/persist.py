"""Pickle-free persistence for fitted synergy models.

Port of :mod:`muscle_synergies_tpu.models.persist`, in its file format:
a model is one compressed ``.npz`` of numeric arrays plus one JSON
string (``__meta__``), read back with ``allow_pickle=False``, so opening
an untrusted file runs no code.  The format tags, payload keys, JSON
fields and precision tokens are the JAX package's, so a file written by
either package loads in the other.

Formats:

- ``muscle_synergies_tpu.model/1`` (:data:`MODEL_FORMAT`): one fitted
  :class:`~.select.NMFModel`, :class:`~.cnmf.CNMFModel` or
  :class:`~.nm3f.NM3FModel`: the class name, its constructor
  parameters (the JAX package's: this package's ``impl``, ``device``
  and ``dtype`` of an ``NMFModel`` are where it runs, not what it is),
  its scalar fitted attributes, and one array per fitted factor;
- ``muscle_synergies_tpu.synergy_run/1`` (:data:`RUN_FORMAT`): a whole
  :class:`~.select.SynergyRunResult` (one run or a rank sweep): the VAF
  table, each rank's component DataFrame and one model payload per
  rank.

A loaded model's ``transform`` / ``inverse_transform`` reproduce the
original bit for bit on the same device: the factors are stored at
full precision and the hyperparameters exactly, the legacy sklearn <=
0.24 ``alpha`` / ``regularization`` pair included.  ``load_model``
takes the port's ``device`` / ``dtype`` (the card by default; the file
itself is device-free, so a model saved on the card loads with
``device="cpu"``).  :func:`save_model` and :func:`load_model` need no
pandas; the synergy-run pair imports it when it runs.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "MODEL_FORMAT",
    "RUN_FORMAT",
    "load_model",
    "load_synergy_run",
    "save_model",
    "save_synergy_run",
]

MODEL_FORMAT = "muscle_synergies_tpu.model/1"
RUN_FORMAT = "muscle_synergies_tpu.synergy_run/1"

_Payload = Tuple[Dict[str, np.ndarray], Dict[str, Any]]
# a CNMFModel's impl, stored by the JAX package's names for the same routes
_JAX_IMPL = {"torch": "xla", "cuda": "pallas"}


def _precision_token(precision) -> Union[str, None]:
    """JSON spelling of a matmul ``precision``: ``None``, a string, or
    the lowercase ``.name`` of a precision enum member."""
    if precision is None or isinstance(precision, str):
        return precision
    name = getattr(precision, "name", None)
    if isinstance(name, str):
        return name.lower()
    raise TypeError(
        "precision must be None, a string, or a jax.lax.Precision member to be "
        f"persisted; got {precision!r}"
    )


def _require_fitted(model, attr: str, cls: str) -> None:
    if not hasattr(model, attr):
        raise ValueError(f"this {cls} instance is not fitted yet; fit before saving")


# ---------------------------------------------------------------------------
# Per-class payloads: (arrays, meta) <-> estimator


def _nmf_payload(model) -> _Payload:
    _require_fitted(model, "components_", "NMFModel")
    params = {
        "n_components": model.n_components,
        "solver": model.solver,
        "beta_loss": model.beta_loss,
        "init": model.init,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "random_state": model.random_state,
        "alpha_W": model.alpha_W,
        "alpha_H": model.alpha_H,
        "l1_ratio": model.l1_ratio,
        "svd_method": model.svd_method,
        "inner_iter": model.inner_iter,
        # the sklearn <= 0.24 spelling, resolved at __init__ into this
        # pair, stored as such so a loaded model has the same penalties
        "legacy_alpha": list(model._legacy_alpha) if model._legacy_alpha else None,
    }
    fitted = {
        "n_components_": int(model.n_components_),
        "n_iter_": int(model.n_iter_),
        "reconstruction_err_": float(model.reconstruction_err_),
    }
    arrays = {"components_": np.asarray(model.components_)}
    return arrays, {"class": "NMFModel", "params": params, "fitted": fitted}


def _nmf_restore(arrays, meta, placement):
    from .select import NMFModel

    params = dict(meta["params"])
    legacy = params.pop("legacy_alpha", None)
    model = NMFModel(**params, **placement)
    if legacy is not None:
        model._legacy_alpha = (float(legacy[0]), legacy[1])
    model.components_ = np.asarray(arrays["components_"])
    for key, value in meta["fitted"].items():
        setattr(model, key, value)
    return model


def _cnmf_payload(model) -> _Payload:
    _require_fitted(model, "synergies_", "CNMFModel")
    params = {
        "n_components": model.n_components,
        "n_lags": model.n_lags,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "n_inits": model.n_inits,
        "random_state": model.random_state,
        "impl": _JAX_IMPL.get(model.impl, model.impl),
        "precision": _precision_token(model.precision),
    }
    fitted = {
        "n_components_": int(model.n_components_),
        "n_lags_": int(model.n_lags_),
        "n_iter_": int(model.n_iter_),
        "reconstruction_err_": float(model.reconstruction_err_),
    }
    arrays = {
        "synergies_": np.asarray(model.synergies_),
        "restart_errors_": np.asarray(model.restart_errors_),
    }
    return arrays, {"class": "CNMFModel", "params": params, "fitted": fitted}


def _cnmf_restore(arrays, meta, placement):
    from .cnmf import CNMFModel

    params = dict(meta["params"])
    model = CNMFModel(params.pop("n_components"), params.pop("n_lags"), **params,
                      **placement)
    model.synergies_ = np.asarray(arrays["synergies_"])
    model.restart_errors_ = np.asarray(arrays["restart_errors_"])
    for key, value in meta["fitted"].items():
        setattr(model, key, value)
    return model


def _nm3f_payload(model) -> _Payload:
    _require_fitted(model, "temporal_modules_", "NM3FModel")
    params = {
        "n_temporal": model.n_temporal,
        "n_spatial": model.n_spatial,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "n_inits": model.n_inits,
        "random_state": model.random_state,
        "precision": _precision_token(model.precision),
    }
    fitted = {
        "n_temporal_": int(model.n_temporal_),
        "n_spatial_": int(model.n_spatial_),
        "n_iter_": int(model.n_iter_),
        "reconstruction_err_": float(model.reconstruction_err_),
        "vaf_": float(model.vaf_),
    }
    arrays = {
        "temporal_modules_": np.asarray(model.temporal_modules_),
        "spatial_modules_": np.asarray(model.spatial_modules_),
        "restart_errors_": np.asarray(model.restart_errors_),
    }
    return arrays, {"class": "NM3FModel", "params": params, "fitted": fitted}


def _nm3f_restore(arrays, meta, placement):
    from .nm3f import NM3FModel

    params = dict(meta["params"])
    model = NM3FModel(params.pop("n_temporal"), params.pop("n_spatial"), **params,
                      **placement)
    model.temporal_modules_ = np.asarray(arrays["temporal_modules_"])
    model.spatial_modules_ = np.asarray(arrays["spatial_modules_"])
    model.restart_errors_ = np.asarray(arrays["restart_errors_"])
    for key, value in meta["fitted"].items():
        setattr(model, key, value)
    return model


_REGISTRY = {
    "NMFModel": (_nmf_payload, _nmf_restore),
    "CNMFModel": (_cnmf_payload, _cnmf_restore),
    "NM3FModel": (_nm3f_payload, _nm3f_restore),
}


def _model_payload(model) -> _Payload:
    name = type(model).__name__
    if name not in _REGISTRY:
        raise TypeError(f"cannot persist {name}; expected one of {sorted(_REGISTRY)}")
    return _REGISTRY[name][0](model)


def _model_restore(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any],
                   placement: Mapping[str, Any]):
    name = meta.get("class")
    if name not in _REGISTRY:
        raise ValueError(f"unknown model class in payload: {name!r}")
    return _REGISTRY[name][1](arrays, meta, placement)


# ---------------------------------------------------------------------------
# npz plumbing


def _normalize_path(path) -> Path:
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    return path


def _atomic_savez(path: Path, arrays: Dict[str, np.ndarray],
                  meta: Dict[str, Any]) -> Path:
    payload = dict(arrays)
    payload["__meta__"] = np.array(json.dumps(meta))
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)  # atomic publish
    return path


def _load_npz(path, expected_format: str):
    path = Path(path)
    with np.load(path, allow_pickle=False) as data:
        if "__meta__" not in data.files:
            raise ValueError(f"{path} is not a muscle_synergies_tpu payload")
        meta = json.loads(str(data["__meta__"]))
        if meta.get("format") != expected_format:
            raise ValueError(
                f"{path}: format {meta.get('format')!r}, expected {expected_format!r}"
            )
        arrays = {key: np.asarray(data[key]) for key in data.files if key != "__meta__"}
    return arrays, meta


def _prefixed(arrays: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {key[len(prefix):]: value for key, value in arrays.items()
            if key.startswith(prefix)}


# ---------------------------------------------------------------------------
# Public surface


def save_model(model, path) -> Path:
    """Persist a fitted estimator to ``path`` (``.npz`` appended if
    missing), atomically.  Returns the path written."""
    arrays, meta = _model_payload(model)
    return _atomic_savez(_normalize_path(path), arrays, dict(meta, format=MODEL_FORMAT))


def load_model(path, device="cuda", dtype: Optional[torch.dtype] = None):
    """Load an estimator saved by :func:`save_model` (by either package).

    The file is read with ``allow_pickle=False``: no code runs at load
    time.  ``device`` / ``dtype`` are the loaded model's, where its
    ``transform`` runs (the card by default).
    """
    arrays, meta = _load_npz(path, MODEL_FORMAT)
    return _model_restore(arrays, meta, dict(device=device, dtype=dtype))


def save_synergy_run(result, path) -> Path:
    """Persist a :class:`~.select.SynergyRunResult` (one run or a rank
    sweep): the VAF table, every rank's component DataFrame (with its
    muscle-name columns) and every fitted model."""
    vaf = result.vaf_values
    if isinstance(result.model, Mapping):
        components = {k: c.to_numpy() for k, c in result.components.items()}
        columns = {k: list(c.columns) for k, c in result.components.items()}
    else:
        components = result.components.to_numpy()
        columns = list(result.components.columns)
    return _save_run(vaf.to_numpy(), list(vaf.columns), list(vaf.index), components,
                     columns, result.model, path)


def _save_run(vaf_values: np.ndarray, vaf_columns, vaf_index, components, columns,
              model, path) -> Path:
    """:func:`save_synergy_run` from arrays (no pandas): the VAF table's
    values, columns and index; ``components``, ``columns`` and ``model``
    are each a ``{rank: ...}`` mapping for a sweep, else one run's
    ``(k, L)`` array, its muscle labels and its model."""
    sweep = isinstance(model, Mapping)
    arrays: Dict[str, np.ndarray] = {"vaf_values": np.asarray(vaf_values)}
    meta: Dict[str, Any] = {
        "format": RUN_FORMAT,
        "sweep": sweep,
        "vaf_columns": [str(c) for c in vaf_columns],
        "vaf_index": [int(i) for i in vaf_index],
    }
    if sweep:
        ranks = sorted(int(k) for k in model)
        meta.update(ranks=ranks, models={}, components_columns={})
        for rank in ranks:
            arrays[f"components__{rank}"] = np.asarray(components[rank])
            meta["components_columns"][str(rank)] = [str(c) for c in columns[rank]]
            model_arrays, model_meta = _model_payload(model[rank])
            for key, value in model_arrays.items():
                arrays[f"model__{rank}__{key}"] = value
            meta["models"][str(rank)] = model_meta
    else:
        arrays["components__"] = np.asarray(components)
        meta["components_columns"] = [str(c) for c in columns]
        model_arrays, model_meta = _model_payload(model)
        for key, value in model_arrays.items():
            arrays[f"model____{key}"] = value
        meta["model"] = model_meta
    return _atomic_savez(_normalize_path(path), arrays, meta)


def _load_run_models(path, device="cuda", dtype: Optional[torch.dtype] = None):
    """The fitted models of a run saved by :func:`save_synergy_run`, with
    no pandas: ``{rank: model}`` for a sweep, else the one model."""
    return _load_run(path, dict(device=device, dtype=dtype))[2]


def _load_run(path, placement):
    """A saved run's arrays, its metadata and its models."""
    arrays, meta = _load_npz(path, RUN_FORMAT)
    if meta["sweep"]:
        models = {rank: _model_restore(_prefixed(arrays, f"model__{rank}__"),
                                       meta["models"][str(rank)], placement)
                  for rank in meta["ranks"]}
    else:
        models = _model_restore(_prefixed(arrays, "model____"), meta["model"], placement)
    return arrays, meta, models


def load_synergy_run(path, device="cuda", dtype: Optional[torch.dtype] = None):
    """Load a :class:`~.select.SynergyRunResult` saved by
    :func:`save_synergy_run` (``allow_pickle=False``); ``device`` /
    ``dtype`` are the models'.  Needs pandas."""
    import pandas

    from .select import SynergyRunResult

    arrays, meta, models = _load_run(path, dict(device=device, dtype=dtype))
    vaf_values = pandas.DataFrame(arrays["vaf_values"], columns=meta["vaf_columns"],
                                  index=meta["vaf_index"])
    if meta["sweep"]:
        components = {rank: pandas.DataFrame(
            arrays[f"components__{rank}"],
            columns=meta["components_columns"][str(rank)]) for rank in meta["ranks"]}
    else:
        components = pandas.DataFrame(arrays["components__"],
                                      columns=meta["components_columns"])
    return SynergyRunResult(vaf_values, components, models)
