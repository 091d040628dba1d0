"""User-facing NMF model, VAF-based rank selection and synergy runs.

Port of :mod:`muscle_synergies_tpu.models.select`:

- :class:`NMFModel` plays the role of ``sklearn.decomposition.NMF``
  (attributes ``components_``, ``n_iter_``, ``reconstruction_err_``),
  with the JAX package's solvers, penalties, legacy ``alpha=`` and
  ``inner_iter``;
- :func:`find_synergies` mirrors the reference API: one rank or a
  ``n_components..max_components`` sweep, VAF per rank, and a
  :class:`SynergyRunResult`; ``sweep="batched"`` solves every rank in
  one batched fit (:func:`~.batch.rank_sweep_batch`);
- :func:`compute_regularization`, sklearn's penalty scaling.

Like every entry point of the package, :class:`NMFModel` and
:func:`find_synergies` run on the card unless given ``device="cpu"``;
their results are NumPy arrays, as in the JAX package.  ``impl`` picks
the fit, as on the batched solvers: ``"auto"`` (the default) runs a
CUDA frame as a batch of one, or of all swept ranks, through
``fit_*_batch``, one launch of K2 (CD), K1 (MU) or K4 (beta-MU), and a
CPU frame through the plain PyTorch fit; ``"torch"`` runs the plain fit
wherever the frame is.  A time-normalised 200 x 8 frame fits one warp
or one thread block; a larger one, a subject's concatenated cycles or a
whole capture's envelope (20,000 or 124,460 x 8), runs on K1's or K2's
cluster entry, one fit spread over many blocks of the card, in the
same single launch; a beta-divergence fit (KL, IS or any other beta) over one
block's shared memory likewise runs on K4's cluster entry.
:meth:`NMFModel.transform` (H frozen) is plain PyTorch on the device
asked for: no kernel has a frozen-factor entry yet.  It runs a loop of
10-iteration chunks that ``torch.export`` can capture
(:func:`_transform_core`), which :mod:`.export` serves.

pandas is imported only when :func:`find_synergies` runs (the machine
with the card may have none); :class:`NMFModel` needs no pandas.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from .._common import (
    IMPLS,
    as_tensor,
    eager_loop,
    entry_placement,
    repeat,
    resolve_impl,
    to_numpy,
)
from .batch import (
    fit_cd_batch,
    fit_mu_batch,
    fit_mu_beta_batch,
    rank_sweep_batch,
)
from .beta import beta_divergence, beta_loss_to_float, fit_mu_beta, mu_update_beta
from .hals import cd_pass, fit_cd
from .init import initialize_nmf
from .mu import fit_mu, frobenius_error, mu_update
from ..ops.emg import vaf as _vaf

__all__ = ["NMFModel", "SynergyRunResult", "find_synergies", "compute_regularization"]


def _warn_if_unconverged(n_iter: int, max_iter: int, tol: float) -> None:
    """sklearn's ConvergenceWarning when a fit exhausts ``max_iter``."""
    if n_iter == max_iter and tol > 0:
        try:
            from sklearn.exceptions import ConvergenceWarning as _Warn
        except ImportError:  # sklearn is optional at run time
            _Warn = UserWarning
        warnings.warn(
            f"Maximum number of iterations {max_iter} reached. Increase "
            "it to improve convergence.",
            _Warn,
            stacklevel=3,
        )


# Sentinel distinguishing "regularization not passed" (sklearn 0.24's
# default was 'both') from an explicit regularization=None (which that
# version treated as no regularization at all).
_UNSET = object()
_REGULARIZATIONS = (None, "both", "components", "transformation")


def _check_regularization(regularization) -> None:
    if regularization is not _UNSET and regularization not in _REGULARIZATIONS:
        raise ValueError(
            f"invalid regularization: {regularization!r} (expected "
            "'both', 'components', 'transformation' or None)"
        )


def _legacy_regularization(alpha: float, regularization, l1_ratio: float):
    """sklearn <= 0.24's unscaled penalties (the reference's pinned API),
    gated per factor by the ``regularization`` selector (``None`` = no
    penalties)."""
    on_w = regularization in ("both", "transformation")
    on_h = regularization in ("both", "components")
    l1 = alpha * l1_ratio
    l2 = alpha * (1.0 - l1_ratio)
    return (
        l1 if on_w else 0.0,
        l2 if on_w else 0.0,
        l1 if on_h else 0.0,
        l2 if on_h else 0.0,
    )


def compute_regularization(
    alpha_w: float, alpha_h: Union[float, str], l1_ratio: float, n: int, l: int
):
    """sklearn's scaling of L1/L2 penalties by the opposite dimension.

    Example:
        >>> compute_regularization(0.1, "same", 0.5, 200, 8)
        (0.4, 0.4, 10.0, 10.0)
    """
    if alpha_h == "same":
        alpha_h = alpha_w
    l1_reg_w = l * alpha_w * l1_ratio
    l1_reg_h = n * alpha_h * l1_ratio
    l2_reg_w = l * alpha_w * (1.0 - l1_ratio)
    l2_reg_h = n * alpha_h * (1.0 - l1_ratio)
    return l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h


def _matrix(x, device, dtype) -> torch.Tensor:
    """``x`` (array, DataFrame or tensor) as a tensor where the model runs."""
    device, dtype = entry_placement(device, dtype)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=float)
    return as_tensor(x, device, dtype)


def _check_beta_solver(beta: float, beta_loss, solver: str) -> None:
    if beta != 2.0 and solver != "mu":
        # sklearn: only the MU solver handles general beta
        raise ValueError(
            f"Invalid beta_loss parameter: solver {solver!r} does "
            f"not handle beta_loss = {beta_loss!r}"
        )


def _check_data(x: torch.Tensor, beta: float) -> None:
    """sklearn's ``check_array`` and non-negativity refusals."""
    if not bool(torch.isfinite(x).all()):
        raise ValueError("Input X contains NaN or infinity.")
    if bool((x < 0).any()):
        raise ValueError("Negative values in data passed to NMF")
    if beta <= 0 and bool((x == 0).any()):
        # zero entries make WH -> 0 poles of the beta <= 0 divergence
        raise ValueError(
            "When beta_loss <= 0 and X contains zeros, the solver may "
            "diverge. Please add small values to X, or use a positive "
            "beta_loss."
        )


# iterations a body call of the transform loops runs: the MU stopping
# check's cadence (sklearn's), and one host readback of the loop's
# condition per chunk
_CHUNK = 10


def _transform_core(x, h, solver: str, beta: float, max_iter: int, tol: float,
                    l1_w: float, l2_w: float, loop=eager_loop):
    """sklearn's transform of a stack ``x (B, n, L)``: W solved with
    ``h (k, L)`` frozen, each trial stopping on its own.

    Written for ``loop`` (:func:`~.._common.eager_loop`, or
    ``torch._higher_order_ops.while_loop`` when traced): each body call
    runs :data:`_CHUNK` iterations (:func:`~.._common.repeat`), every
    one applied to a trial only while it is still going
    (``torch.where``), so a trial stops where
    :func:`~.mu.fit_mu` / :func:`~.beta.fit_mu_beta` /
    :func:`~.hals.fit_cd` with ``update_h=False`` stop it: MU checks
    every 10 iterations and the count is capped at ``max_iter``; CD
    checks its violation every iteration.  Returns ``(W, n_iter)``.
    """
    b, n, _ = x.shape
    k = h.shape[0]
    n0 = torch.zeros(b, dtype=torch.int32, device=x.device)
    conv0 = torch.zeros(b, dtype=torch.bool, device=x.device)

    def cond(w, n_iter, stat, conv):
        return (~conv & (n_iter < max_iter)).any()

    if beta == 2.0 and solver == "cd":
        ht = h.transpose(-1, -2)

        def one(w, n_iter, viol_init, conv):
            act = ~conv & (n_iter < max_iter)
            w_new, viol = cd_pass(x, w, ht, l1_w, l2_w)
            n_iter = n_iter + act.to(n_iter.dtype)
            viol_init = torch.where(act & (n_iter == 1), viol, viol_init)
            return (torch.where(act[:, None, None], w_new, w), n_iter, viol_init,
                    torch.where(act, (viol_init == 0) | (viol / viol_init <= tol), conv))

        def body(*state):
            return repeat(_CHUNK, one, state, loop)

        w0 = x.new_zeros((b, n, k))  # sklearn's CD transform starts at zero
        w, n_iter, _, _ = loop(cond, body, (w0, n0, x.new_zeros(b), conv0))
        return w, n_iter

    if beta != 2.0:
        def step(w):
            return mu_update_beta(x, w, h, beta, l1_w, l2_w, update_h=False)[0]

        def error(w):
            return beta_divergence(x, w, h, beta)
    else:
        def step(w):
            return mu_update(x, w, h, l1_w, l2_w, update_h=False)[0]

        def error(w):
            return frobenius_error(x, w, h)

    # sklearn seeds the multiplicative solver with the average fill
    # (zeros would be absorbing states for MU)
    avg = (x.mean(dim=(1, 2)).clamp(min=0.0) / k).sqrt()
    w0 = x.new_ones((b, n, k)) * avg[:, None, None]
    err0 = error(w0)

    def body(w, n_iter, prev, conv):
        going = ~conv & (n_iter < max_iter)

        def one(w, n_iter):
            act = ~conv & (n_iter < max_iter)
            return torch.where(act[:, None, None], step(w), w), n_iter + act.to(n_iter.dtype)

        w, n_iter = repeat(_CHUNK, one, (w, n_iter), loop)
        if tol <= 0:  # no check: every trial runs max_iter
            return w, n_iter, prev.clone(), conv.clone()
        err = error(w)
        newly = ((prev - err) / err0 < tol) & (n_iter % _CHUNK == 0)
        return w, n_iter, torch.where(going, err, prev), torch.where(going, newly, conv)

    w, n_iter, _, _ = loop(cond, body, (w0, n0, err0.clone(), conv0))
    return w, n_iter


class NMFModel:
    """Non-negative matrix factorization ``X ~ W @ H``.

    The JAX package's ``NMFModel``: ``solver`` is ``"cd"`` (sklearn's
    default) or ``"mu"``; ``beta_loss`` is ``"frobenius"`` (default),
    ``"kullback-leibler"``, ``"itakura-saito"`` or a float beta, any
    other loss than Frobenius needing ``solver="mu"``.  Sparsity comes
    from ``alpha_W`` / ``alpha_H`` / ``l1_ratio`` with sklearn's
    dimension-scaled penalties, or the legacy sklearn <= 0.24 spelling
    ``alpha=`` + ``regularization=``.  ``inner_iter > 1`` (Frobenius MU
    only) is the accelerated MU of Gillis & Glineur 2012.
    ``svd_method="randomized"`` makes the NNDSVD-family inits equal to
    sklearn's (host-side randomized SVD seeded by ``random_state``).
    ``verbose`` is accepted and ignored.

    ``device`` / ``dtype``: where the fit runs, the card by default (in
    float32 there unless ``dtype`` says otherwise); ``device="cpu"``
    runs the plain PyTorch fits.  ``impl``: ``"auto"``, ``"torch"`` or
    ``"cuda"``, the kernel or the plain fit (module docstring).

    After :meth:`fit_transform`:

    Attributes:
        components_: ``(k, L)`` factor H (NumPy).
        n_components_: the rank used.
        n_iter_: iterations run by the solver.
        reconstruction_err_: the square-rooted beta divergence of the
            fitted loss (``||X - WH||_F`` for Frobenius).
    """

    def __init__(
        self,
        n_components: Optional[int] = None,
        *,
        solver: str = "cd",
        beta_loss: Union[str, float] = "frobenius",
        init: Optional[str] = None,
        tol: float = 1e-4,
        max_iter: int = 200,
        random_state: Optional[int] = None,
        alpha_W: float = 0.0,
        alpha_H: Union[float, str] = "same",
        l1_ratio: float = 0.0,
        svd_method: str = "exact",
        alpha: Optional[float] = None,
        regularization=_UNSET,
        inner_iter: int = 1,
        verbose: int = 0,
        impl: str = "auto",
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        _check_regularization(regularization)
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        # sklearn <= 0.24 applied a single `alpha` unscaled, per
        # `regularization` ('both' by default; an explicit None meant no
        # penalties); resolved in fit_transform
        self._legacy_alpha = None
        if alpha is not None:
            reg = "both" if regularization is _UNSET else regularization
            self._legacy_alpha = (float(alpha), reg)
        if inner_iter < 1:
            raise ValueError(f"inner_iter must be >= 1, got {inner_iter}")
        self.n_components = n_components
        self.solver = solver
        self.beta_loss = beta_loss
        self.init = init
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.alpha_W = alpha_W
        self.alpha_H = alpha_H
        self.l1_ratio = l1_ratio
        self.svd_method = svd_method
        self.inner_iter = inner_iter
        self.verbose = verbose
        self.impl = impl
        self.device = device
        self.dtype = dtype

    def _penalties(self, n: int, l: int):
        if self._legacy_alpha is not None:
            return _legacy_regularization(*self._legacy_alpha, self.l1_ratio)
        return compute_regularization(self.alpha_W, self.alpha_H, self.l1_ratio,
                                      n, l)

    def fit_transform(self, x, w=None, h=None) -> np.ndarray:
        """Factorize ``x`` and return ``W``.

        Passing both ``w`` and ``h`` uses them as the starting point
        (sklearn's ``init='custom'``).
        """
        beta = beta_loss_to_float(self.beta_loss)
        x = _matrix(x, self.device, self.dtype)
        if x.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {tuple(x.shape)}")
        if x.numel() == 0:
            raise ValueError("empty matrix passed to NMF")
        _check_data(x, beta)
        n, l = x.shape
        k = self.n_components if self.n_components is not None else l

        if w is not None and h is not None:
            w0, h0 = as_tensor(w, x.device, x.dtype), as_tensor(h, x.device, x.dtype)
        elif w is not None or h is not None:
            raise ValueError("provide both w and h for a custom init, or neither")
        elif self.init == "custom":
            raise ValueError(
                "init='custom' requires passing both w and h to fit_transform"
            )
        else:
            w0, h0 = initialize_nmf(x, k, init=self.init,
                                    seed=self.random_state or 0,
                                    svd_method=self.svd_method)
        w0, h0 = w0.to(x.dtype), h0.to(x.dtype)
        l1_w, l2_w, l1_h, l2_h = self._penalties(n, l)
        _check_beta_solver(beta, self.beta_loss, self.solver)
        if self.inner_iter != 1 and (self.solver != "mu" or beta != 2.0):
            raise ValueError(
                "inner_iter > 1 is only available for the Frobenius MU solver"
            )
        if self.solver not in ("mu", "cd"):
            raise ValueError(f"unknown solver: {self.solver!r}")
        regs = dict(l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h, l2_reg_h=l2_h)
        fit = dict(max_iter=self.max_iter, tol=float(self.tol), **regs)
        if beta != 2.0:
            plain, batched = fit_mu_beta, fit_mu_beta_batch
            fit["beta"] = beta
        elif self.solver == "mu":
            plain, batched = fit_mu, fit_mu_batch
            fit["inner_iter"] = self.inner_iter
        else:
            plain, batched = fit_cd, fit_cd_batch
        if resolve_impl(self.impl, x) == "cuda":
            # a batch of one: one launch of K4, K1 or K2
            state = batched(x[None], w0[None], h0[None], impl="cuda", **fit)
            state = type(state)(*(t[0] for t in state))
        else:
            state = plain(x, w0, h0, **fit)
        w_final = state.w
        h_final = state.ht.T if self.solver == "cd" and beta == 2.0 else state.h

        self.n_components_ = k
        self.n_iter_ = int(state.n_iter)
        self.components_ = to_numpy(h_final)
        # sklearn: the square-rooted beta divergence of the fitted loss
        self.reconstruction_err_ = float(
            beta_divergence(x, w_final, h_final, beta, square_root=True)
        )
        _warn_if_unconverged(self.n_iter_, self.max_iter, self.tol)
        return to_numpy(w_final)

    def fit(self, x, **kwargs) -> "NMFModel":
        self.fit_transform(x, **kwargs)
        return self

    def _transform_factors(self):
        """The fitted factors the transform holds fixed: ``(H,)``."""
        if not hasattr(self, "components_"):
            raise ValueError("this NMFModel instance is not fitted yet")
        return (self.components_,)

    def _transform_torch(self, x: torch.Tensor, h: torch.Tensor, loop=eager_loop):
        """The transform on tensors: ``(W, n_iter)`` with ``h`` frozen,
        for one ``(n, L)`` frame or a ``(B, n, L)`` stack (each trial
        stopping on its own).  Traceable with ``loop=while_loop``, the
        counterpart of the JAX package's ``_transform_jax`` (what
        :mod:`.export` captures); :meth:`transform` wraps it."""
        beta = beta_loss_to_float(self.beta_loss)
        # a hand-built model with an incompatible (solver, beta_loss)
        # pair must not transform with the MU solver
        _check_beta_solver(beta, self.beta_loss, self.solver)
        l1_w, l2_w, _, _ = self._penalties(x.shape[-2], h.shape[-1])
        single = x.ndim == 2
        w, n_iter = _transform_core(x[None] if single else x, h, self.solver, beta,
                                    self.max_iter, float(self.tol), l1_w, l2_w, loop)
        return (w[0], n_iter[0]) if single else (w, n_iter)

    def transform(self, x) -> np.ndarray:
        """Project ``x`` onto the learned components (W with H fixed).

        Uses the fitted solver with frozen H, like sklearn's
        ``transform`` (``_fit_transform(X, H=components_,
        update_H=False)``): MU starts W at the average fill, CD at zero,
        and the W-side penalties apply.  A ``(B, n, L)`` stack transforms
        every trial, each stopping on its own.  Plain PyTorch on the
        model's device (:func:`_transform_core`).
        """
        (h,) = self._transform_factors()
        x = _matrix(x, self.device, self.dtype)
        w, n_iter = self._transform_torch(x, as_tensor(h, x.device, x.dtype))
        _warn_if_unconverged(int(n_iter.max()), self.max_iter, self.tol)
        return to_numpy(w)

    def inverse_transform(self, w) -> np.ndarray:
        return np.asarray(w) @ self.components_

    def save(self, path):
        """Persist the fitted model as a pickle-free ``.npz``
        (:func:`~.persist.save_model`)."""
        from .persist import save_model

        return save_model(self, path)

    @classmethod
    def load(cls, path, device="cuda", dtype: Optional[torch.dtype] = None) -> "NMFModel":
        """Load a model saved by :meth:`save` (``allow_pickle=False``),
        to run on ``device`` (the card by default)."""
        from .persist import load_model

        model = load_model(path, device=device, dtype=dtype)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}, not {cls.__name__}")
        return model


@dataclass
class SynergyRunResult:
    """Result of one or several synergy factorization runs.

    Attributes:
        vaf_values: a pandas DataFrame with one row per rank: first
            column ``"All signals"``, then per-muscle VAF; the index is
            the rank when a sweep was run.
        components: ``(k, num_muscles)`` DataFrame (single run) or a
            dict mapping rank to DataFrame.
        model: the fitted :class:`NMFModel` (or dict of them).
    """

    vaf_values: Any
    components: Union[Any, Mapping[int, Any]]
    model: Union[NMFModel, Mapping[int, NMFModel]]

    def save(self, path):
        """Persist the whole run (VAF table, components, models) as a
        pickle-free ``.npz`` (:func:`~.persist.save_synergy_run`)."""
        from .persist import save_synergy_run

        return save_synergy_run(self, path)

    @classmethod
    def load(cls, path, device="cuda",
             dtype: Optional[torch.dtype] = None) -> "SynergyRunResult":
        """Load a run saved by :meth:`save` (``allow_pickle=False``);
        ``device`` / ``dtype`` are its models'.  Needs pandas."""
        from .persist import load_synergy_run

        return load_synergy_run(path, device=device, dtype=dtype)


class _Run(NamedTuple):
    """:func:`_find_synergies_arrays`' result: the ranks fitted, one VAF
    row per rank (overall, then one per muscle), and each rank's
    ``(k, L)`` components and fitted model."""

    ranks: list
    vaf_rows: np.ndarray
    components: dict
    models: dict


def _vaf_row(x_host: np.ndarray, w, h, device) -> np.ndarray:
    """:func:`~..analysis.vaf`'s row as an array: the overall VAF of
    ``w @ h`` against ``x_host``, then each column's, computed where
    ``device`` says."""
    device, dtype = entry_placement(device, None)
    x = as_tensor(np.asarray(x_host, dtype=float), device, dtype)
    recon = as_tensor(w, x.device, x.dtype) @ as_tensor(h, x.device, x.dtype)
    overall, per_col = _vaf(x, recon)
    return np.array([float(overall)] + [float(v) for v in to_numpy(per_col).ravel()])


def _find_synergies_arrays(
    x_host: np.ndarray,
    n_components: int,
    max_components: Optional[int] = None,
    *,
    max_iter: int = 100_000,
    tol: float = 1e-6,
    sweep: str = "loop",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    **nmf_kwargs,
) -> _Run:
    """:func:`find_synergies` on a ``(N, L)`` NumPy array, no pandas."""
    if x_host.size == 0:
        raise ValueError("empty EMG DataFrame")
    num_features = x_host.shape[1]
    if n_components < 1 or n_components > num_features:
        raise ValueError("invalid number of components")
    if max_components is not None:
        if max_components < n_components or max_components > num_features:
            raise ValueError("invalid number of components")
    if sweep not in ("loop", "batched"):
        raise ValueError(f"unknown sweep mode: {sweep!r}")
    if sweep == "batched" and max_components is not None:
        return _sweep_batched(
            x_host, range(n_components, max_components + 1),
            max_iter=max_iter, tol=tol, device=device, dtype=dtype, **nmf_kwargs,
        )
    ranks = [n_components] if max_components is None else list(
        range(n_components, max_components + 1))
    rows, comps, models = [], {}, {}
    for k in ranks:
        model = NMFModel(n_components=k, max_iter=max_iter, tol=tol,
                         device=device, dtype=dtype, **nmf_kwargs)
        transformed = model.fit_transform(x_host)
        rows.append(_vaf_row(x_host, transformed, model.components_, device))
        comps[k], models[k] = model.components_, model
    return _Run(ranks, np.stack(rows), comps, models)


def find_synergies(
    processed_emg_df,
    n_components: int,
    max_components: Optional[int] = None,
    *,
    max_iter: int = 100_000,
    tol: float = 1e-6,
    sweep: str = "loop",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    **nmf_kwargs,
) -> SynergyRunResult:
    """Extract spatial muscle synergies by non-negative factorization.

    Mirrors the reference API: the processed EMG DataFrame
    (``(num_measurements, num_muscles)``, non-negative) is factorized at
    rank ``n_components``, or at every rank from ``n_components`` to
    ``max_components``, and each run's VAF is reported.

    ``sweep="loop"`` fits one rank at a time (the reference's loop);
    ``"batched"`` solves every rank in one zero-rank-padded batch
    (:func:`~.batch.rank_sweep_batch`, one kernel launch on the card),
    with the same penalties and ``inner_iter``; custom inits need
    ``sweep="loop"``.  ``device`` / ``dtype`` / ``impl`` are
    :class:`NMFModel`'s.  Needs pandas.

    Raises:
        ValueError: when the EMG frame is empty, or the rank range does
            not satisfy ``1 <= n_components <= max_components <=
            num_muscles``.
    """
    import pandas

    if processed_emg_df.empty:
        raise ValueError("empty EMG DataFrame")
    run = _find_synergies_arrays(
        processed_emg_df.to_numpy(dtype=float), n_components, max_components,
        max_iter=max_iter, tol=tol, sweep=sweep, device=device, dtype=dtype,
        **nmf_kwargs,
    )
    columns = processed_emg_df.columns
    vaf_values = pandas.DataFrame(run.vaf_rows,
                                  columns=["All signals"] + columns.tolist())
    comps = {k: pandas.DataFrame(h, columns=columns) for k, h in run.components.items()}
    if max_components is None:
        return SynergyRunResult(vaf_values, comps[n_components],
                                run.models[n_components])
    vaf_values.set_index(np.array(run.ranks), inplace=True)
    return SynergyRunResult(vaf_values, comps, run.models)


def _sweep_batched(
    x_host: np.ndarray,
    ranks,
    *,
    max_iter: int,
    tol: float,
    device,
    dtype,
    solver: str = "cd",
    beta_loss: Union[str, float] = "frobenius",
    init: Optional[str] = None,
    random_state: Optional[int] = None,
    svd_method: str = "exact",
    alpha_W: float = 0.0,
    alpha_H: Union[float, str] = "same",
    l1_ratio: float = 0.0,
    alpha: Optional[float] = None,
    regularization=_UNSET,
    inner_iter: int = 1,
    verbose: int = 0,
    impl: str = "auto",
    **unsupported,
) -> _Run:
    """A rank sweep as one zero-rank-padded batched solve.

    Every rank's problem is one entry of an ``(R, N, L)`` batch with
    factors zero-padded to ``max(ranks)``; padded components stay
    exactly zero, so entry ``i`` equals the independent rank-``ranks[i]``
    fit: on the card with ``impl="auto"``, one kernel launch.
    """
    if unsupported:
        raise ValueError(
            "sweep='batched' does not support "
            f"{sorted(unsupported)}; use the default sweep='loop'"
        )
    _check_regularization(regularization)
    beta = beta_loss_to_float(beta_loss)
    x = _matrix(x_host, device, dtype)
    _check_data(x, beta)
    ranks = list(ranks)
    if alpha is not None:
        reg = "both" if regularization is _UNSET else regularization
        l1_w, l2_w, l1_h, l2_h = _legacy_regularization(alpha, reg, l1_ratio)
    else:
        l1_w, l2_w, l1_h, l2_h = compute_regularization(
            alpha_W, alpha_H, l1_ratio, *x.shape
        )
    states, _ = rank_sweep_batch(
        x, ranks, init=init, solver=solver, max_iter=max_iter, tol=float(tol),
        seed=random_state or 0, svd_method=svd_method, beta_loss=beta_loss,
        inner_iter=inner_iter, l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h,
        l2_reg_h=l2_h, impl=impl, device=x.device, dtype=x.dtype,
    )
    w_all = states.w
    h_all = states.h if solver == "mu" else states.ht.transpose(-1, -2)

    n_iters = to_numpy(states.n_iter)
    rows, comps, models = [], {}, {}
    for i, k in enumerate(ranks):
        w, h = w_all[i][:, :k], h_all[i][:k, :]
        h_np = to_numpy(h)
        rows.append(_vaf_row(x_host, to_numpy(w), h_np, device))
        comps[k] = h_np
        model = NMFModel(
            n_components=k, solver=solver, beta_loss=beta_loss, init=init,
            tol=tol, max_iter=max_iter, random_state=random_state,
            svd_method=svd_method, alpha_W=alpha_W, alpha_H=alpha_H,
            l1_ratio=l1_ratio, alpha=alpha, regularization=regularization,
            inner_iter=inner_iter, impl=impl, device=device, dtype=dtype,
        )
        model.n_components_ = k
        model.n_iter_ = int(n_iters[i])
        model.components_ = h_np
        model.reconstruction_err_ = float(
            beta_divergence(x, w, h, beta, square_root=True)
        )
        _warn_if_unconverged(model.n_iter_, max_iter, tol)
        models[k] = model
    return _Run(ranks, np.stack(rows), comps, models)
