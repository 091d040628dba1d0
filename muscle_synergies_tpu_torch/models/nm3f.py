"""Space-by-time decomposition: sample-based trilinear NMF (NM3F).

Port of :mod:`muscle_synergies_tpu.models.nm3f`.  Delis, Panzeri, Pozzo
& Berret (2014)'s space-by-time model writes every trial as a
non-negative mixture of shared temporal modules and shared spatial
modules with per-trial mixing coefficients,

    X_b[t, l] ~ sum_i sum_j W[t, i] * A_b[i, j] * S[j, l],

``X_b ~ W @ A_b @ S`` with ``W (T, P)``, ``S (Q, L)`` and
``A_b (P, Q)``.  The multiplicative updates, ``EPSILON``-guarded like
every solver of the package, run A, then W, then S, each with the
freshest other factors:

    A_b *= (W^T X_b S^T) / (W^T W A_b S S^T)
    W   *= (sum_b X_b S^T A_b^T) / (W sum_b A_b (S S^T) A_b^T)
    S   *= (sum_b A_b^T W^T X_b) / ((sum_b A_b^T (W^T W) A_b) S)

NM3F has no kernel in the JAX package (XLA runs it) and none here: every
update is a handful of batched PyTorch products on the device where the
trials lie.  The restarts of :func:`find_space_by_time_synergies` and of
the frozen-side fits ride on a leading axis of the factors, the trials
shared, and each restart stops on its own, as under the JAX package's
``vmap`` of a ``while_loop``: a converged restart is frozen while the
others iterate.

``precision=`` is the JAX package's matmul precision for every product,
the stopping checks' included (see
:func:`~muscle_synergies_tpu_torch._common.allows_tf32`): full float32
by default, TF32 allowed for ``"high"``.  The default coefficients of
:func:`nm3f_transform` are the JAX package's ``jax.random.uniform``
draws (:mod:`.._prng`).

pandas is imported only by the finders, which return DataFrames;
:class:`NM3FModel` needs none.  ``mesh=`` is not ported (ROADMAP item
8, parallel) and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _prng
from .._common import (
    as_tensor,
    eager_loop,
    entry_placement,
    matmul_precision,
    repeat,
    to_numpy,
)
from .mu import EPSILON, _guard
from .select import _CHUNK, _matrix

__all__ = [
    "NM3FModel",
    "NM3FState",
    "SharedSpatialResult",
    "SharedTemporalResult",
    "SpaceByTimeResult",
    "find_shared_spatial_synergies",
    "find_space_by_time_synergies",
    "find_temporal_synergies",
    "fit_nm3f",
    "init_nm3f",
    "nm3f_reconstruct",
    "nm3f_transform",
    "nm3f_update",
    "normalize_modules",
    "sbt_vaf",
]

def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _reconstruct(w, a, s):
    """``W @ A_b @ S`` with any leading restart axes on the factors."""
    return w.unsqueeze(-3) @ a @ s.unsqueeze(-3)


def nm3f_reconstruct(w: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                     precision=None) -> torch.Tensor:
    """``X^_b = W @ A_b @ S``; ``a`` may be ``(P, Q)`` or ``(B, P, Q)``."""
    with matmul_precision(precision):
        if a.ndim == 2:
            return (w @ a) @ s
        return _reconstruct(w, a, s)


def _update(xs, w, a, s, update_w, update_s):
    """:func:`nm3f_update` on factors with any leading restart axes
    (``w (..., T, P)``, ``a (..., B, P, Q)``, ``s (..., Q, L)``) and
    shared trials ``xs (B, T, L)``."""
    wtw = _t(w) @ w
    sst = s @ _t(s)
    num_a = _t(w).unsqueeze(-3) @ xs @ _t(s).unsqueeze(-3)
    den_a = wtw.unsqueeze(-3) @ a @ sst.unsqueeze(-3)
    a = a * (num_a / _guard(den_a))
    if update_w:
        num_w = torch.einsum("...btq,...bpq->...tp", xs @ _t(s).unsqueeze(-3), a)
        gram_w = torch.einsum("...bpm,...brm->...pr", a @ sst.unsqueeze(-3), a)
        w = w * (num_w / _guard(w @ gram_w))
    if update_s:
        wtw = _t(w) @ w  # with the fresh W
        num_s = torch.einsum("...bpq,...bpl->...ql", a, _t(w).unsqueeze(-3) @ xs)
        gram_s = torch.einsum("...bpq,...bpm->...qm", a, wtw.unsqueeze(-3) @ a)
        s = s * (num_s / _guard(gram_s @ s))
    return w, a, s


def nm3f_update(
    xs: torch.Tensor,
    w: torch.Tensor,
    a: torch.Tensor,
    s: torch.Tensor,
    update_w: bool = True,
    update_s: bool = True,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One A-then-W-then-S multiplicative update.

    Args:
        xs: ``(B, T, L)`` non-negative trials (shared time base).
        w: ``(T, P)`` temporal modules.
        a: ``(B, P, Q)`` per-trial coefficients.
        s: ``(Q, L)`` spatial modules.
        update_w / update_s: freeze a module set (the transform fixes
            both and solves only the coefficients).
        precision: matmul precision of every product.
    """
    with matmul_precision(precision):
        return _update(xs, w, a, s, update_w, update_s)


class NM3FState(NamedTuple):
    w: torch.Tensor  # (T, P) temporal modules
    a: torch.Tensor  # (B, P, Q) per-trial coefficients
    s: torch.Tensor  # (Q, L) spatial modules
    n_iter: torch.Tensor
    previous_error: torch.Tensor
    converged: torch.Tensor


def _nm3f_error(xs, w, a, s):
    diff = xs - _reconstruct(w, a, s)
    return (diff * diff).sum(dim=(-3, -2, -1)).sqrt()


def _masked_update(xs, w, a, s, update_w, update_s, mask):
    """:func:`_update` with every projection of X and of its
    reconstruction seeing ``mask`` (the EM treatment of missing
    entries); the full reconstruction is rebuilt before each factor's
    update, since no Gram shortcut exists under a mask."""
    mx = mask * xs
    mrec = mask * _reconstruct(w, a, s)
    wt, st = _t(w).unsqueeze(-3), _t(s).unsqueeze(-3)
    a = a * ((wt @ mx @ st) / _guard(wt @ mrec @ st))
    if update_w:
        mrec = mask * _reconstruct(w, a, s)
        num_w = torch.einsum("...btq,...bpq->...tp", mx @ st, a)
        den_w = torch.einsum("...btq,...bpq->...tp", mrec @ st, a)
        w = w * (num_w / _guard(den_w))
        wt = _t(w).unsqueeze(-3)
    if update_s:
        mrec = mask * _reconstruct(w, a, s)
        num_s = torch.einsum("...bpq,...bpl->...ql", a, wt @ mx)
        den_s = torch.einsum("...bpq,...bpl->...ql", a, wt @ mrec)
        s = s * (num_s / _guard(den_s))
    return w, a, s


def _masked_error(xs, w, a, s, mask):
    diff = mask * (xs - _reconstruct(w, a, s))
    return (diff * diff).sum(dim=(-3, -2, -1)).sqrt()


def _fit_restarts(xs, w0, a0, s0, max_iter, tol, check_every, update_w, update_s,
                  precision, mask=None) -> NM3FState:
    """:func:`fit_nm3f` of every fit on the leading axis of the factors.
    The trials ``(B, T, L)`` are shared, or ``(R, B, T, L)`` give each
    fit its own; a ``mask`` ``(R, B, T, L)`` fits each on its observed
    entries (:func:`_masked_update`).  Every fit still iterating has run
    the same count, so each chunk runs ``min(check_every, max_iter -
    count)`` updates of those fits, and a fit converges only at a
    multiple of ``check_every`` (the JAX package's tail-chunk rule)."""
    w, a, s = (f.to(xs.dtype).clone() for f in (w0, a0, s0))
    r = w.shape[0]
    per_fit = xs.ndim == 4
    masks = () if mask is None else (mask,)
    step = _update if mask is None else _masked_update
    error = _nm3f_error if mask is None else _masked_error
    with matmul_precision(precision):
        err0 = error(xs, w, a, s, *masks)
        scale = err0.clamp(min=EPSILON)
        prev = err0.clone()
        n_iter = torch.zeros(r, dtype=torch.int32, device=xs.device)
        converged = torch.zeros(r, dtype=torch.bool, device=xs.device)
        done = 0
        while done < max_iter:
            active = (~converged).nonzero().flatten()
            if active.numel() == 0:
                break
            wa, aa, sa = w[active], a[active], s[active]
            xa = xs[active] if per_fit else xs
            ma = tuple(m[active] for m in masks)
            steps = min(check_every, max_iter - done)
            for _ in range(steps):
                wa, aa, sa = step(xa, wa, aa, sa, update_w, update_s, *ma)
            err = error(xa, wa, aa, sa, *ma)
            done += steps
            w[active], a[active], s[active] = wa, aa, sa
            n_iter[active] = done
            improvement = (prev[active] - err) / scale[active]
            converged[active] = (improvement < tol) & (done % check_every == 0)
            prev[active] = err
    return NM3FState(w, a, s, n_iter, prev, converged)


def fit_nm3f(
    xs: torch.Tensor,
    w0: torch.Tensor,
    a0: torch.Tensor,
    s0: torch.Tensor,
    max_iter: int = 500,
    tol: float = 1e-5,
    check_every: int = 10,
    update_w: bool = True,
    update_s: bool = True,
    precision=None,
) -> NM3FState:
    """The space-by-time factorization to convergence, where ``xs`` lies.

    The package-wide sklearn rule: every ``check_every`` iterations the
    total Frobenius error is evaluated, and the fit stops when
    ``(previous - current) / max(initial, EPSILON) < tol``.
    ``max_iter`` is a hard cap: the last chunk runs ``max_iter %
    check_every`` updates and cannot stop the fit by convergence.
    ``precision`` applies to the updates and the checks.
    """
    xs = as_tensor(xs)
    w0, a0, s0 = (as_tensor(f, xs.device) for f in (w0, a0, s0))
    state = _fit_restarts(xs, w0[None], a0[None], s0[None], max_iter, tol,
                          check_every, update_w, update_s, precision)
    return NM3FState(*(f[0] for f in state))


def init_nm3f(
    xs,
    n_temporal: int,
    n_spatial: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scaled-random non-negative ``(W, A, S)``, drawn on the host.

    Each entry is uniform with mean ``c``, chosen so the expected
    reconstruction matches the data: ``P * Q * c**3 = mean(X)``.  The
    draws are the JAX package's (``np.random.default_rng(seed)``), bit
    for bit; a tensor is read on the host.
    """
    xs = to_numpy(xs)
    b, t, l = xs.shape
    rng = np.random.default_rng(seed)
    c = (
        float(max(xs.mean(), 0.0)) / (n_temporal * n_spatial)
    ) ** (1.0 / 3.0) if xs.size else 1.0
    w = rng.uniform(0, 2 * c, size=(t, n_temporal))
    a = rng.uniform(0, 2 * c, size=(b, n_temporal, n_spatial))
    s = rng.uniform(0, 2 * c, size=(n_spatial, l))
    dt = xs.dtype if np.issubdtype(xs.dtype, np.floating) else np.float64
    return w.astype(dt, copy=False), a.astype(dt, copy=False), s.astype(dt, copy=False)


def normalize_modules(
    w: torch.Tensor, a: torch.Tensor, s: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit-norm modules, per-trial coefficients rescaled inversely.

    Temporal module columns and spatial module rows get unit Euclidean
    norm; the scale moves into ``A`` (``A'_b = diag(||w_i||) A_b
    diag(||s_j||)``).  Zero modules are left untouched.
    """
    wn = (w * w).sum(dim=0).sqrt()
    sn = (s * s).sum(dim=1).sqrt()
    w_out = w / torch.where(wn == 0, 1.0, wn)[None, :]
    s_out = s / torch.where(sn == 0, 1.0, sn)[:, None]
    return w_out, a * wn[:, None] * sn[None, :], s_out


def sbt_vaf(xs: torch.Tensor, w: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
            precision=None) -> torch.Tensor:
    """Per-trial VAF of the space-by-time reconstruction, ``(B,)``."""
    rec = nm3f_reconstruct(w, a, s, precision)
    err = ((xs - rec) ** 2).sum(dim=(1, 2))
    tot = (xs * xs).sum(dim=(1, 2))
    return 1.0 - err / torch.where(tot == 0, 1.0, tot)


def _transform_loop(xs, w, s, a0, max_iter: int, tol: float, precision,
                    loop=eager_loop):
    """:func:`fit_nm3f` of the stack ``xs (B, T, L)`` with both module sets
    frozen, written for ``loop`` (:func:`~.._common.eager_loop`, or
    ``while_loop`` when traced): a body call is one 10-iteration chunk,
    each iteration applied only while the fit is going and the count
    below ``max_iter`` (the tail-chunk rule), then the stopping check.
    The stack is one fit: its error sums over every trial.  Returns
    ``(a, n_iter, previous_error, converged)``."""
    def error(a):
        with matmul_precision(precision):
            return _nm3f_error(xs, w, a, s)

    err0 = error(a0)
    scale = err0.clamp(min=EPSILON)

    def cond(a, n_iter, prev, conv):
        return ~conv & (n_iter < max_iter)

    def body(a, n_iter, prev, conv):
        going = ~conv & (n_iter < max_iter)

        def one(a, n_iter):
            act = ~conv & (n_iter < max_iter)
            with matmul_precision(precision):
                a = torch.where(act, _update(xs, w, a, s, False, False)[1], a)
            return a, n_iter + act.to(n_iter.dtype)

        a, n_iter = repeat(_CHUNK, one, (a, n_iter), loop)
        err = error(a)
        newly = ((prev - err) / scale < tol) & (n_iter % _CHUNK == 0)
        return a, n_iter, torch.where(going, err, prev), torch.where(going, newly, conv)

    return loop(cond, body, (a0.clone(), torch.zeros((), dtype=torch.int32, device=xs.device),
                             err0.clone(), torch.zeros((), dtype=torch.bool, device=xs.device)))


def _transform(x, w, s, a0, max_iter, tol, seed, precision, generator=None,
               loop=eager_loop) -> NM3FState:
    """:func:`nm3f_transform` on tensors, its loop ``loop``."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    b, t, l = x.shape
    p, q = w.shape[1], s.shape[0]
    if a0 is None:
        denom = w.sum() * s.sum()
        c = torch.where(denom > 0, x.mean() * t * l / denom.clamp(min=EPSILON), 1.0)
        c = c.clamp(min=EPSILON)
        if generator is not None:
            u = torch.rand((b, p, q), generator=generator, dtype=x.dtype,
                           device=generator.device).to(x.device)
        else:
            key = _prng.prng_key(seed)
            u = _prng.uniform_torch(int(key[0]), int(key[1]), b * p * q, x.dtype,
                                    x.device).reshape(b, p, q)
        a0 = u * (2.0 * c).to(x.dtype)
    elif a0.ndim == 2:
        a0 = a0.expand((b,) + tuple(a0.shape))
    elif a0.shape[0] != b:
        raise ValueError(f"a0 has batch {a0.shape[0]} but x has {b} trials")
    a, n_iter, prev, conv = _transform_loop(x, w, s, a0.to(x.dtype), max_iter, tol,
                                            precision, loop)
    return NM3FState(w, a[0] if squeeze else a, s, n_iter, prev, conv)


def nm3f_transform(
    x: torch.Tensor,
    w: torch.Tensor,
    s: torch.Tensor,
    a0: Optional[torch.Tensor] = None,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    precision=None,
    generator: Optional[torch.Generator] = None,
) -> NM3FState:
    """Project trials onto fixed modules: solve A, freeze W and S.

    The single-trial-decoding step of Delis et al. (2014): the mixing
    coefficients of new trials on the fitted modules' time base (``W``
    pins ``T``).  Plain PyTorch on ``x``'s device, as a loop of
    10-iteration chunks that ``torch.export`` can capture
    (:mod:`.export`).

    Args:
        x: ``(T, L)`` or batched ``(B, T, L)`` non-negative trials.
        w: ``(T, P)`` fixed temporal modules.
        s: ``(Q, L)`` fixed spatial modules.
        a0: initial coefficients, ``(B, P, Q)`` or one ``(P, Q)`` for
            every trial; by default ``2 c`` times the JAX package's
            uniform draws from ``PRNGKey(seed)`` (bit for bit, computed
            on ``x``'s device), or ``generator``'s when one is given,
            with ``c = mean(X) T L / (sum(W) sum(S))`` matching the
            data's magnitude.
        max_iter / tol: sklearn-style stopping on the Frobenius error.

    Returns:
        :class:`NM3FState` whose ``w`` and ``s`` equal the inputs bit
        for bit; ``a`` holds the solved coefficients.
    """
    x = as_tensor(x)
    w, s = as_tensor(w, x.device), as_tensor(s, x.device)
    if a0 is not None:
        a0 = as_tensor(a0, x.device)
    return _transform(x, w, s, a0, max_iter, tol, seed, precision, generator)


class SpaceByTimeResult(NamedTuple):
    """Best-restart result of :func:`find_space_by_time_synergies`.

    Attributes:
        temporal_modules: ``(T, P)`` DataFrame, unit-norm columns.
        spatial_modules: ``(Q, L)`` DataFrame, unit-norm rows, columns
            named after the muscles.
        coefficients: ``(B, P, Q)`` per-trial mixing coefficients.
        vaf: overall VAF across the dataset (scalar float).
        vaf_per_trial: ``(B,)`` array.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
    """

    temporal_modules: object
    spatial_modules: object
    coefficients: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


def _validate_trial_stack(trials, device="cuda", dtype: Optional[torch.dtype] = None,
                          empty: str = "empty trial stack"):
    """The JAX package's ``(B, T, L)`` stack checks, on the stack as a
    tensor where the fit runs; returns ``(xs, columns)``, the columns of
    a sequence of DataFrames or ``None``.  A float32 stack stays float32
    off the card and integers become float64."""
    columns = None
    if not hasattr(trials, "ndim"):
        columns = getattr(trials[0], "columns", None)
        columns = list(columns) if columns is not None else None
        trials = np.stack([to_numpy(t) for t in trials])
    device, dtype = entry_placement(device, dtype)
    xs = as_tensor(trials, device, dtype)
    if not xs.is_floating_point():
        xs = xs.double()
    if xs.ndim != 3:
        raise ValueError(f"expected a (B, T, L) trial stack, got shape {tuple(xs.shape)}")
    if xs.numel() == 0:
        raise ValueError(empty)
    if not bool(torch.isfinite(xs).all()):
        raise ValueError("Input X contains NaN or infinity.")
    if bool((xs < 0).any()):
        raise ValueError("Negative values in data passed to NMF")
    return xs, columns


def _check_inits(n_inits: int) -> None:
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")


def _stacked(xs, inits):
    """``[(W, A, S), ...]`` host arrays as three restart-stacked tensors."""
    return [as_tensor(np.stack(f), xs.device, xs.dtype) for f in zip(*inits)]


class _SpaceByTimeFit(NamedTuple):
    """:func:`_fit_space_by_time`'s arrays: the winning restart's
    unit-norm modules and coefficients, its VAF, iterations and every
    restart's final error."""

    w: np.ndarray
    a: np.ndarray
    s: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


def _fit_restarts_meshed(xs, inits, mesh, max_iter, tol, precision=None):
    """The restarts through :func:`~..parallel.sharded_fit_nm3f`, one call
    each (the shared modules make each restart one global problem, so
    restarts cannot share the data axis as the per-trial grids do), their
    states stacked on a leading restart axis as the local path's are.

    A trial count that does not divide the data axis is padded with zero
    trials of zero coefficients, which add nothing to any numerator, Gram
    or error (their coefficients stay zero).  Returns ``None``, after a
    warning, when the mesh lacks the ``(data, time)`` axes or the time
    axis does not divide; the caller then fits locally.
    """
    from ..parallel._spmd import axis_size, full, usable_mesh
    from ..parallel.mesh import DATA_AXIS
    from ..parallel.nm3f import sharded_fit_nm3f

    b, t, _ = xs.shape
    mesh = usable_mesh(mesh, "find_space_by_time_synergies", t, 0)
    if mesh is None:
        return None
    pad = (-b) % axis_size(mesh, DATA_AXIS)
    if pad:
        xs = torch.cat([xs, xs.new_zeros((pad,) + tuple(xs.shape[1:]))])
    states = []
    for w0, a0, s0 in inits:
        a0 = as_tensor(a0, xs.device, xs.dtype)
        if pad:
            a0 = torch.cat([a0, a0.new_zeros((pad,) + tuple(a0.shape[1:]))])
        st = sharded_fit_nm3f(xs, as_tensor(w0, xs.device, xs.dtype), a0,
                              as_tensor(s0, xs.device, xs.dtype), mesh,
                              max_iter=max_iter, tol=tol, precision=precision)
        st = NM3FState(*(full(f) for f in st))
        states.append(st._replace(a=st.a[:b]))
    return NM3FState(*(torch.stack(f) for f in zip(*states)))


def _fit_space_by_time(xs: torch.Tensor, n_temporal: int, n_spatial: int,
                       max_iter: int, tol: float, n_inits: int, seed: int,
                       precision, mesh=None) -> _SpaceByTimeFit:
    """The array core of :func:`find_space_by_time_synergies`,
    :class:`NM3FModel` and ``analyze_dataset_space_by_time``: the rank
    refusals, the host inits (restart ``r`` seeded ``seed + r``), every
    restart fitted at once where ``xs`` lies (or each on the ``mesh``),
    and the lowest-error one normalised, with its VAF."""
    b, t, l = xs.shape
    if not 1 <= n_temporal <= t:
        raise ValueError(f"n_temporal must be in [1, n_samples={t}], got {n_temporal}")
    if not 1 <= n_spatial <= l:
        raise ValueError(f"n_spatial must be in [1, n_muscles={l}], got {n_spatial}")
    _check_inits(n_inits)
    xs_host = to_numpy(xs)
    inits = [init_nm3f(xs_host, n_temporal, n_spatial, seed=seed + r)
             for r in range(n_inits)]
    states = None
    if mesh is not None:
        states = _fit_restarts_meshed(xs, inits, mesh, max_iter, tol, precision)
    if states is None:
        w0, a0, s0 = _stacked(xs, inits)
        states = _fit_restarts(xs, w0, a0, s0, max_iter, tol, 10, True, True,
                               precision)
    errors = to_numpy(states.previous_error)
    best = int(np.argmin(errors))
    w, a, s = normalize_modules(states.w[best], states.a[best], states.s[best])
    rec = nm3f_reconstruct(w, a, s, precision)
    err2 = ((xs - rec) ** 2).sum(dim=(1, 2))
    tot2 = (xs * xs).sum(dim=(1, 2))
    return _SpaceByTimeFit(
        w=to_numpy(w), a=to_numpy(a), s=to_numpy(s),
        vaf=1.0 - float(err2.sum()) / max(float(tot2.sum()), float(EPSILON)),
        vaf_per_trial=to_numpy(1.0 - err2 / torch.where(tot2 == 0, 1.0, tot2)),
        n_iter=int(states.n_iter[best]), restart_errors=errors,
    )


def _temporal_frame(w: np.ndarray):
    import pandas

    return pandas.DataFrame(w, columns=[f"temporal {i}" for i in range(w.shape[1])])


def find_space_by_time_synergies(
    trials,
    n_temporal: int,
    n_spatial: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    mesh=None,
    precision=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> SpaceByTimeResult:
    """Extract Delis-style space-by-time synergies from a trial stack.

    Shared temporal and spatial modules with a small per-trial
    coefficient matrix each.  The ``n_inits`` random restarts
    (:func:`init_nm3f`, restart ``r`` seeded ``seed + r``) run at once
    on a leading axis, each stopping on its own; the lowest-error
    restart is returned with unit-norm modules.  Needs pandas.

    Args:
        trials: ``(B, T, L)`` non-negative stack (e.g. the output of
            ``preprocess_trials``), or a sequence of equal-shape
            ``(T, L)`` DataFrames, arrays or tensors.
        n_temporal / n_spatial: module counts ``P`` / ``Q``.
        max_iter / tol: sklearn-style stopping (see :func:`fit_nm3f`).
        mesh: optional ``(data, time)`` mesh: each restart runs through
            :func:`~..parallel.sharded_fit_nm3f` (trials and coefficients
            over ``data``, the shared time base over ``time``); a trial
            count that does not divide the data axis is padded with
            zero trials (exact), and a time axis that does not divide
            warns and falls back to the local solver.
        precision: matmul precision of every product.
        device, dtype: where the fit runs: the card by default, in
            float32 there; off the card a float32 stack solves in
            float32 and other stacks in float64.
    """
    import pandas

    xs, columns = _validate_trial_stack(trials, device, dtype,
                                        empty="empty trial stack passed to NM3F")
    fit = _fit_space_by_time(xs, n_temporal, n_spatial, max_iter, tol, n_inits, seed,
                             precision, mesh=mesh)
    cols = columns if columns is not None else list(range(xs.shape[2]))
    return SpaceByTimeResult(
        temporal_modules=_temporal_frame(fit.w),
        spatial_modules=pandas.DataFrame(fit.s, columns=cols),
        coefficients=fit.a,
        vaf=fit.vaf,
        vaf_per_trial=fit.vaf_per_trial,
        n_iter=fit.n_iter,
        restart_errors=fit.restart_errors,
    )


class NM3FModel:
    """sklearn-style estimator for the space-by-time synergy model.

    The JAX package's ``NM3FModel``: ``fit`` / ``fit_transform``
    estimate shared temporal and spatial modules from a whole trial
    stack with batched restarts (the array core of
    :func:`find_space_by_time_synergies`); ``transform`` solves the
    per-trial coefficients of new trials with both module sets frozen
    (:func:`nm3f_transform`).  Needs no pandas.  ``device`` / ``dtype``:
    where it runs, the card by default (float32 there).

    Attributes after fitting:
        temporal_modules_: ``(T, P)`` unit-norm columns.
        spatial_modules_: ``(Q, L)`` unit-norm rows.
        n_temporal_ / n_spatial_: module counts actually used.
        n_iter_: iterations of the winning restart.
        reconstruction_err_: its final Frobenius error.
        restart_errors_: ``(n_inits,)`` final errors of all restarts.
        vaf_: overall VAF of the training reconstruction.
    """

    def __init__(
        self,
        n_temporal: int,
        n_spatial: int,
        *,
        tol: float = 1e-5,
        max_iter: int = 500,
        n_inits: int = 4,
        random_state: int = 0,
        precision=None,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        self.n_temporal = n_temporal
        self.n_spatial = n_spatial
        self.tol = tol
        self.max_iter = max_iter
        self.n_inits = n_inits
        self.random_state = random_state
        self.precision = precision
        self.device = device
        self.dtype = dtype

    def _set_fitted(self, w, s, n_iter, restart_errors, vaf,
                    n_temporal=None, n_spatial=None) -> None:
        self.temporal_modules_ = np.asarray(w)
        self.spatial_modules_ = np.asarray(s)
        self.n_temporal_ = self.n_temporal if n_temporal is None else n_temporal
        self.n_spatial_ = self.n_spatial if n_spatial is None else n_spatial
        self.n_iter_ = int(n_iter)
        self.restart_errors_ = restart_errors
        self.reconstruction_err_ = float(restart_errors.min())
        self.vaf_ = float(vaf)

    def fit_transform(self, X) -> np.ndarray:
        """Fit the modules and return the ``(B, P, Q)`` coefficients."""
        xs, _ = _validate_trial_stack(X, self.device, self.dtype,
                                      empty="empty trial stack passed to NM3F")
        fit = _fit_space_by_time(xs, self.n_temporal, self.n_spatial, self.max_iter,
                                 self.tol, self.n_inits, self.random_state,
                                 self.precision)
        self._set_fitted(fit.w, fit.s, fit.n_iter, fit.restart_errors, fit.vaf)
        return fit.a

    def fit(self, X) -> "NM3FModel":
        self.fit_transform(X)
        return self

    @classmethod
    def from_result(cls, res, **kwargs) -> "NM3FModel":
        """Wrap a :func:`find_space_by_time_synergies` result (or the
        dataset-level ``SpaceByTimeDatasetResult``, whose modules are read
        from its arrays, without pandas) as a fitted estimator;
        ``kwargs`` are the constructor's hyperparameters."""
        if hasattr(res, "vaf_overall"):  # SpaceByTimeDatasetResult
            w, s, vaf = res.w, res.s, res.vaf_overall
        else:
            w, s = np.asarray(res.temporal_modules), np.asarray(res.spatial_modules)
            vaf = res.vaf
        model = cls(w.shape[1], s.shape[0], **kwargs)
        model._set_fitted(w, s, res.n_iter, res.restart_errors, vaf)
        return model

    @classmethod
    def from_temporal_result(cls, res: "SharedTemporalResult", **kwargs) -> "NM3FModel":
        """Wrap a :func:`find_temporal_synergies` (tMod) result: the
        spatial side is the identity, so ``transform`` solves each new
        trial's ``(P, L)`` muscle weighting."""
        w = np.asarray(res.temporal_modules)
        n_muscles = res.weights.shape[-1]
        model = cls(w.shape[1], n_muscles, **kwargs)
        model._set_fitted(w, np.eye(n_muscles, dtype=w.dtype), res.n_iter,
                          res.restart_errors, res.vaf, n_spatial=n_muscles)
        return model

    @classmethod
    def from_shared_spatial_result(cls, res: "SharedSpatialResult",
                                   **kwargs) -> "NM3FModel":
        """Wrap a :func:`find_shared_spatial_synergies` (sMod) result:
        the temporal side is the identity, so ``transform`` solves each
        new trial's ``(T, Q)`` activations."""
        s = np.asarray(res.spatial_modules)
        n_samples = res.activations.shape[1]
        model = cls(n_samples, s.shape[0], **kwargs)
        model._set_fitted(np.eye(n_samples, dtype=s.dtype), s, res.n_iter,
                          res.restart_errors, res.vaf, n_temporal=n_samples)
        return model

    def _check_fitted(self):
        if not hasattr(self, "temporal_modules_"):
            raise ValueError(
                "this NM3FModel instance is not fitted yet; call fit "
                "or fit_transform first"
            )

    def transform(self, X) -> np.ndarray:
        """Coefficients of new trials (``(T, L)`` or ``(B, T, L)``, on
        the training time base) against the fitted modules."""
        self._check_fitted()
        x = _matrix(X, self.device, self.dtype)
        if x.ndim not in (2, 3):
            raise ValueError(f"expected (T, L) or (B, T, L) trials, got shape "
                             f"{tuple(x.shape)}")
        if x.shape[-2] != self.temporal_modules_.shape[0]:
            raise ValueError(
                f"trials have {x.shape[-2]} samples but the fitted temporal "
                f"modules expect {self.temporal_modules_.shape[0]}"
            )
        w, s = (as_tensor(f, x.device, x.dtype) for f in self._transform_factors())
        return to_numpy(self._transform_torch(x, w, s)[0])

    def _transform_factors(self):
        """The fitted factors the transform holds fixed: ``(W, S)``."""
        self._check_fitted()
        return self.temporal_modules_, self.spatial_modules_

    def _transform_torch(self, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                         loop=eager_loop):
        """The transform on tensors: ``(coefficients, n_iter)`` against
        the modules ``w`` and ``s``.  Traceable with ``loop=while_loop``,
        the counterpart of the JAX package's ``_transform_jax`` (what
        :mod:`.export` captures); :meth:`transform` wraps it."""
        state = _transform(x, w, s, None, self.max_iter, self.tol, self.random_state,
                           self.precision, loop=loop)
        return state.a, state.n_iter

    def inverse_transform(self, A) -> np.ndarray:
        """Reconstruction ``X^`` from coefficients and the fitted modules."""
        self._check_fitted()
        a = _matrix(A, self.device, self.dtype)
        return to_numpy(nm3f_reconstruct(
            as_tensor(self.temporal_modules_, a.device, a.dtype), a,
            as_tensor(self.spatial_modules_, a.device, a.dtype), self.precision))

    def save(self, path):
        """Persist the fitted model as a pickle-free ``.npz``
        (:func:`~.persist.save_model`)."""
        from .persist import save_model

        return save_model(self, path)

    @classmethod
    def load(cls, path, device="cuda", dtype: Optional[torch.dtype] = None) -> "NM3FModel":
        """Load a model saved by :meth:`save` (``allow_pickle=False``),
        to run on ``device`` (the card by default)."""
        from .persist import load_model

        model = load_model(path, device=device, dtype=dtype)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}, not {cls.__name__}")
        return model


class SharedTemporalResult(NamedTuple):
    """Best-restart result of :func:`find_temporal_synergies`.

    Attributes:
        temporal_modules: ``(T, P)`` DataFrame, unit-norm columns.
        weights: ``(B, P, L)`` per-trial muscle weightings of each module.
        vaf: overall VAF across the dataset.
        vaf_per_trial: ``(B,)``.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
    """

    temporal_modules: object
    weights: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


class SharedSpatialResult(NamedTuple):
    """Best-restart result of :func:`find_shared_spatial_synergies`.

    Attributes:
        spatial_modules: ``(Q, L)`` DataFrame, unit-norm rows, columns
            named after the muscles when the input carries labels.
        activations: ``(B, T, Q)`` per-trial recruitment of each module.
        vaf: overall VAF across the dataset.
        vaf_per_trial: ``(B,)``.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
    """

    spatial_modules: object
    activations: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


def _fit_frozen_restarts(xs, inits_w, inits_a, inits_s, max_iter, tol, update_w,
                         update_s, precision=None) -> NM3FState:
    """:func:`fit_nm3f` of every restart at once with one side frozen."""
    w0, a0, s0 = _stacked(xs, zip(inits_w, inits_a, inits_s))
    return _fit_restarts(xs, w0, a0, s0, max_iter, tol, 10, update_w, update_s,
                         precision)


def _frozen_vaf(xs, w, a, s, precision):
    """Overall VAF and per-trial VAF of one reconstruction."""
    err2 = float(((xs - nm3f_reconstruct(w, a, s, precision)) ** 2).sum())
    tot2 = float((xs * xs).sum())
    return (1.0 - err2 / max(tot2, float(EPSILON)),
            to_numpy(sbt_vaf(xs, w, a, s, precision)))


def find_temporal_synergies(
    trials,
    n_temporal: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    precision=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> SharedTemporalResult:
    """Extract shared temporal modules with per-trial muscle weights.

    Delis et al. (2014)'s temporal decomposition ("tMod"):
    ``X_b[t, l] ~ sum_i W[t, i] A_b[i, l]``, the space-by-time model
    with the spatial side frozen at the identity (``Q = L``), fitted as
    one batch of restarts with ``update_s=False``; the identity passes
    through bit for bit.  Needs pandas.
    """
    res = _fit_temporal(trials, n_temporal, max_iter, tol, n_inits, seed, precision,
                        device, dtype)
    return res._replace(temporal_modules=_temporal_frame(res.temporal_modules))


def _fit_temporal(trials, n_temporal, max_iter, tol, n_inits, seed, precision,
                  device, dtype) -> SharedTemporalResult:
    """:func:`find_temporal_synergies` with its modules as an array (no
    pandas)."""
    xs, _ = _validate_trial_stack(trials, device, dtype)
    b, t, l = xs.shape
    if not 1 <= n_temporal <= t:
        raise ValueError(f"n_temporal must be in [1, n_samples={t}], got {n_temporal}")
    _check_inits(n_inits)
    xs_host = to_numpy(xs)
    eye = np.eye(l, dtype=xs_host.dtype)
    # random (W, A) scaled for S = I: E[X^] ~ P c^2 = mean(X)
    c = (float(max(xs_host.mean(), 0.0)) / n_temporal) ** 0.5
    rng = np.random.default_rng(seed)
    inits_w = [rng.uniform(0, 2 * c, (t, n_temporal)).astype(xs_host.dtype)
               for _ in range(n_inits)]
    inits_a = [rng.uniform(0, 2 * c, (b, n_temporal, l)).astype(xs_host.dtype)
               for _ in range(n_inits)]
    states = _fit_frozen_restarts(xs, inits_w, inits_a, [eye] * n_inits, max_iter, tol,
                                  update_w=True, update_s=False, precision=precision)
    errors = to_numpy(states.previous_error)
    best = int(np.argmin(errors))
    w, a, s = normalize_modules(states.w[best], states.a[best], states.s[best])
    vaf, per_trial = _frozen_vaf(xs, w, a, s, precision)
    return SharedTemporalResult(
        temporal_modules=to_numpy(w),
        weights=to_numpy(a),
        vaf=vaf,
        vaf_per_trial=per_trial,
        n_iter=int(states.n_iter[best]),
        restart_errors=errors,
    )


def find_shared_spatial_synergies(
    trials,
    n_spatial: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    precision=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> SharedSpatialResult:
    """Extract shared spatial modules with per-trial activations.

    Delis et al. (2014)'s spatial decomposition ("sMod"):
    ``X_b[t, l] ~ sum_j C_b[t, j] S[j, l]``, the space-by-time model
    with the temporal side frozen at the identity (``P = T``), fitted
    as one batch of restarts with ``update_w=False``.  Needs pandas.
    """
    import pandas

    res, columns = _fit_shared_spatial(trials, n_spatial, max_iter, tol, n_inits, seed,
                                       precision, device, dtype)
    cols = columns if columns is not None else list(range(res.spatial_modules.shape[1]))
    return res._replace(spatial_modules=pandas.DataFrame(res.spatial_modules,
                                                         columns=cols))


def _fit_shared_spatial(trials, n_spatial, max_iter, tol, n_inits, seed, precision,
                        device, dtype):
    """:func:`find_shared_spatial_synergies` with its modules as an
    array (no pandas), and the input's column labels (or ``None``)."""
    xs, columns = _validate_trial_stack(trials, device, dtype)
    b, t, l = xs.shape
    if not 1 <= n_spatial <= l:
        raise ValueError(f"n_spatial must be in [1, n_muscles={l}], got {n_spatial}")
    _check_inits(n_inits)
    xs_host = to_numpy(xs)
    eye = np.eye(t, dtype=xs_host.dtype)
    c = (float(max(xs_host.mean(), 0.0)) / n_spatial) ** 0.5
    rng = np.random.default_rng(seed)
    inits_a = [rng.uniform(0, 2 * c, (b, t, n_spatial)).astype(xs_host.dtype)
               for _ in range(n_inits)]
    inits_s = [rng.uniform(0, 2 * c, (n_spatial, l)).astype(xs_host.dtype)
               for _ in range(n_inits)]
    states = _fit_frozen_restarts(xs, [eye] * n_inits, inits_a, inits_s, max_iter, tol,
                                  update_w=False, update_s=True, precision=precision)
    errors = to_numpy(states.previous_error)
    best = int(np.argmin(errors))
    w, a, s = states.w[best], states.a[best], states.s[best]
    # unit-norm the spatial rows only (W is the frozen identity)
    sn = (s * s).sum(dim=1).sqrt()
    s_out = s / torch.where(sn == 0, 1.0, sn)[:, None]
    a_out = a * sn[None, None, :]
    vaf, per_trial = _frozen_vaf(xs, w, a_out, s_out, precision)
    return SharedSpatialResult(
        spatial_modules=to_numpy(s_out),
        activations=to_numpy(a_out),
        vaf=vaf,
        vaf_per_trial=per_trial,
        n_iter=int(states.n_iter[best]),
        restart_errors=errors,
    ), columns
