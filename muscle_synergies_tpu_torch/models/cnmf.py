"""Convolutive NMF: time-varying muscle synergies.

Port of :mod:`muscle_synergies_tpu.models.cnmf`.  Each synergy is a
short spatiotemporal pattern ``S_k`` (D lags x L muscles) recruited by
a non-negative activation train ``c_k(t)`` (d'Avella, Saltiel & Bizzi
2003), so that

    X[t, l] ~ sum_k sum_d C[t - d, k] * S[k, d, l],

fitted by Smaragdis's convolutive multiplicative updates in the
package's ``(time, muscles)`` orientation: S lag slice by lag slice,
then C by the ratio of sums over lags, with sklearn's EPSILON
denominator guard and its relative-improvement stop every
``check_every`` iterations.

Every solver takes one problem (X ``(T, L)``, C ``(T, K)``, S
``(K, D, L)``) or a batch with a leading ``B``.  :func:`fit_cnmf_batch`
and :func:`cnmf_iterations_batch` pick the implementation (``impl``):
the hand-written kernel K5 for a CUDA float32 batch
(:mod:`.kernels.cnmf_cuda`), the plain PyTorch functions here
otherwise.  A frozen factor (``update_c=False`` / ``update_s=False``)
runs only on the plain route, as in the JAX package, whose Pallas
route refuses it too.  Scale indeterminacy is fixed by
:func:`normalize_synergies`.

On top of the solvers, the per-capture API:

- :func:`cnmf_transform` projects trials onto a fixed library (C solved
  with S frozen): plain PyTorch on the caller's device, as the JAX
  package runs it on XLA, in a loop that ``torch.export`` can capture;
- :func:`find_time_varying_synergies` fits one capture with its
  ``n_inits`` restarts stacked on the batch axis of one
  :func:`fit_cnmf_batch`, one K5 launch on the card, and returns
  DataFrames (it needs pandas);
- :class:`CNMFModel`, the sklearn-style estimator over the same array
  core, needs no pandas.  On the card its fit is one K5 launch: on the
  block entry within one block's shared memory
  (``cnmf_cuda.smem_bytes``: a 200 x 8 frame fits, up to T = 2,822 at
  L = 8, K = 4, D = 10), on the cluster entry (one thread-block cluster
  a fit) for a longer frame, a subject's cycles or a continuous
  recording up to a whole capture.

``precision=`` is the JAX package's matmul precision for the plain
contractions (see :func:`~muscle_synergies_tpu_torch._common.allows_tf32`;
full float32 by default); the kernel computes in float32 on the CUDA
cores whatever it says.  ``block_b=`` is accepted and ignored: it is the
Pallas kernel's tile of trials per Mosaic block.  ``cnmf_block_b`` and
``resolve_cnmf_impl``, the JAX package's Mosaic tile rules, have no
counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _prng
from .._common import (
    allows_tf32,
    as_tensor,
    eager_loop,
    matmul_precision,
    repeat,
    resolve_impl,
    to_numpy,
)
from ..utils.config import torch_impl
from .kernels import cnmf_cuda
from .mu import EPSILON, _guard
from .select import _CHUNK, _matrix

__all__ = [
    "CNMFModel",
    "CNMFState",
    "TimeVaryingSynergyResult",
    "cnmf_iterations_batch",
    "cnmf_reconstruct",
    "cnmf_transform",
    "cnmf_update",
    "find_time_varying_synergies",
    "fit_cnmf",
    "fit_cnmf_batch",
    "init_cnmf",
    "normalize_synergies",
    "tvaf",
]


def _shift_down(c: torch.Tensor, d: int) -> torch.Tensor:
    """``out[t] = c[t - d]`` along time (dim -2), zeros for ``t < d``."""
    if d == 0:
        return c
    t = c.shape[-2]
    return torch.nn.functional.pad(c[..., : t - d, :], (0, 0, d, 0))


def _shift_up(c: torch.Tensor, d: int) -> torch.Tensor:
    """``out[t] = c[t + d]`` along time (dim -2), zeros for ``t >= T - d``."""
    if d == 0:
        return c
    return torch.nn.functional.pad(c[..., d:, :], (0, 0, 0, d))


def _lag_stack(c: torch.Tensor, n_lags: int) -> torch.Tensor:
    """``(..., T, K) -> (..., D, T, K)`` with ``out[d, t] = c[t - d]``."""
    return torch.stack([_shift_down(c, d) for d in range(n_lags)], dim=-3)


def cnmf_reconstruct(c: torch.Tensor, s: torch.Tensor, precision=None) -> torch.Tensor:
    """Reconstruction ``X^[t, l] = sum_k sum_d C[t-d, k] S[k, d, l]``."""
    cs = _lag_stack(c, s.shape[-2])
    with matmul_precision(precision):
        return torch.einsum("...dtk,...kdl->...tl", cs, s)


def cnmf_update(
    x: torch.Tensor,
    c: torch.Tensor,
    s: torch.Tensor,
    update_c: bool = True,
    update_s: bool = True,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One multiplicative update of S then C.

    S update (each lag slice on its own, exact MU):
        ``S[k, d] *= (shift_d(C)^T X) / (shift_d(C)^T X^)``
    C update (ratio of sums over lags, with the fresh S):
        ``C *= (sum_d shift_{-d}(X S_d^T)) / (sum_d shift_{-d}(X^ S_d^T))``

    ``update_c=False`` freezes the activations and ``update_s=False``
    the synergies (the transform, :func:`cnmf_transform`); a frozen
    factor is returned as given.
    """
    n_lags = s.shape[-2]
    if update_s:
        cs = _lag_stack(c, n_lags)
        with matmul_precision(precision):
            xhat = torch.einsum("...dtk,...kdl->...tl", cs, s)
            num_s = torch.einsum("...dtk,...tl->...kdl", cs, x)
            den_s = torch.einsum("...dtk,...tl->...kdl", cs, xhat)
        s = s * (num_s / _guard(den_s))
    if not update_c:
        return c, s
    xhat = cnmf_reconstruct(c, s, precision)
    # G[d, t, k] = sum_l X[t, l] S[k, d, l]; numerator is sum_d G[d, t+d, k]
    with matmul_precision(precision):
        g_num = torch.einsum("...tl,...kdl->...dtk", x, s)
        g_den = torch.einsum("...tl,...kdl->...dtk", xhat, s)
    num_c = sum(_shift_up(g_num[..., d, :, :], d) for d in range(n_lags))
    den_c = sum(_shift_up(g_den[..., d, :, :], d) for d in range(n_lags))
    c = c * (num_c / _guard(den_c))
    return c, s


class CNMFState(NamedTuple):
    c: torch.Tensor  # (..., T, K) activations
    s: torch.Tensor  # (..., K, D, L) spatiotemporal synergies
    n_iter: torch.Tensor  # int32
    previous_error: torch.Tensor
    converged: torch.Tensor  # bool


def _frobenius_error(x, c, s, precision=None):
    diff = x - cnmf_reconstruct(c, s, precision)
    return (diff * diff).sum(dim=(-2, -1)).sqrt()


def fit_cnmf(
    x: torch.Tensor,
    c0: torch.Tensor,
    s0: torch.Tensor,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    update_c: bool = True,
    update_s: bool = True,
    precision=None,
) -> CNMFState:
    """Convolutive NMF to convergence, each problem stopping on its own.

    Every ``check_every`` iterations the Frobenius error is evaluated
    and a fit stops when ``(previous - current) / max(initial,
    EPSILON) < tol``.  There is no tail chunk: the count moves in steps
    of ``check_every`` and may pass ``max_iter``, as in the JAX
    package's ``while_loop``.

    Args:
        x: ``(T, L)`` or ``(B, T, L)`` non-negative data.
        c0, s0: initial activations ``(..., T, K)`` and synergies
            ``(..., K, D, L)``.
        update_c / update_s: freeze one factor (see :func:`cnmf_update`;
            freezing both is refused).
        precision: matmul precision of the contractions, the stopping
            checks' included.
    """
    if not (update_c or update_s):
        raise ValueError("update_c and update_s cannot both be False")
    return _fit_loop(
        x, c0, s0,
        lambda xa, ca, sa: cnmf_update(xa, ca, sa, update_c, update_s, precision),
        lambda xa, ca, sa: _frobenius_error(xa, ca, sa, precision),
        max_iter, tol, check_every)


def _fit_loop(x, c0, s0, step, error, max_iter: int, tol: float, check_every: int,
              mask=None) -> CNMFState:
    """:func:`fit_cnmf`'s loop: ``step(x, c, s)`` is one update and
    ``error(x, c, s)`` the stopping statistic; with a ``mask`` of
    ``x``'s shape both also take the fits' mask.  Whole chunks of
    ``check_every`` updates run on the fits still going, each stopping
    on its own."""
    single = x.ndim == 2
    if single:
        x, c0, s0 = x[None], c0[None], s0[None]
    masks = () if mask is None else (mask[None] if single else mask,)
    b = x.shape[0]
    c, s = c0.to(x.dtype).clone(), s0.to(x.dtype).clone()
    err0 = error(x, c, s, *masks)
    scale = err0.clamp(min=EPSILON)
    prev = err0.clone()
    n_iter = torch.zeros(b, dtype=torch.int32, device=x.device)
    converged = torch.zeros(b, dtype=torch.bool, device=x.device)
    while True:
        active = ((n_iter < max_iter) & ~converged).nonzero().flatten()
        if active.numel() == 0:
            break
        xa, ca, sa = x[active], c[active], s[active]
        ma = tuple(m[active] for m in masks)
        for _ in range(check_every):
            ca, sa = step(xa, ca, sa, *ma)
        err = error(xa, ca, sa, *ma)
        c[active], s[active] = ca, sa
        n_iter[active] += check_every
        converged[active] = (prev[active] - err) / scale[active] < tol
        prev[active] = err
    state = CNMFState(c, s, n_iter, prev, converged)
    if single:
        return CNMFState(*(t[0] for t in state))
    return state


def _masked_update(x, c, s, mask):
    """One weighted convolutive update, S then C: every projection of X
    and of its reconstruction sees ``mask`` (the EM treatment of missing
    entries), :func:`cnmf_update` otherwise."""
    n_lags = s.shape[-2]
    mx = mask * x
    cs = _lag_stack(c, n_lags)
    xhat = mask * torch.einsum("...dtk,...kdl->...tl", cs, s)
    num_s = torch.einsum("...dtk,...tl->...kdl", cs, mx)
    den_s = torch.einsum("...dtk,...tl->...kdl", cs, xhat)
    s = s * (num_s / _guard(den_s))
    xhat = mask * torch.einsum("...dtk,...kdl->...tl", cs, s)
    g_num = torch.einsum("...tl,...kdl->...dtk", mx, s)
    g_den = torch.einsum("...tl,...kdl->...dtk", xhat, s)
    num_c = sum(_shift_up(g_num[..., d, :, :], d) for d in range(n_lags))
    den_c = sum(_shift_up(g_den[..., d, :, :], d) for d in range(n_lags))
    return c * (num_c / _guard(den_c)), s


def _masked_error(x, c, s, mask):
    """``||mask * (X - X^)||_F`` per problem."""
    diff = mask * (x - cnmf_reconstruct(c, s))
    return (diff * diff).sum(dim=(-2, -1)).sqrt()


def _refuse_frozen_factors(update_c: bool, update_s: bool) -> None:
    """K5 always updates both factors: a frozen one needs the plain fit."""
    if not (update_c and update_s):
        raise ValueError(
            "the CUDA kernel K5 always updates both factors; use "
            "impl='torch' for update_c=False / update_s=False (the "
            "frozen-factor paths)"
        )


def fit_cnmf_batch(
    xs: torch.Tensor,
    c0: torch.Tensor,
    s0: torch.Tensor,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    update_c: bool = True,
    update_s: bool = True,
    impl: str = "auto",
    block_b=None,
    precision=None,
) -> CNMFState:
    """Convolutive NMF over a ``(B, T, L)`` stack, per-problem stopping.

    ``impl="cuda"`` (``"auto"`` on a CUDA float32 batch) is kernel K5
    with its stop inside each block; ``"torch"`` is :func:`fit_cnmf`,
    its contractions at ``precision``.  Both follow the JAX package's
    ``fit_cnmf_batch`` iterate for iterate.  K5 updates both factors,
    so a frozen one (``update_c=False`` or ``update_s=False``) on the
    kernel route raises before any launch, as the JAX package's Pallas
    route does; ``impl="torch"`` runs it.  ``block_b`` is ignored (a
    Mosaic tile).
    """
    stop = dict(max_iter=max_iter, tol=tol, check_every=check_every)
    if resolve_impl(impl, xs) == "cuda":
        _refuse_frozen_factors(update_c, update_s)
        allows_tf32(precision)  # validated; K5 computes no matmul
        return cnmf_cuda.fit_cnmf_cuda(xs, c0, s0, **stop)
    return fit_cnmf(xs, c0, s0, update_c=update_c, update_s=update_s,
                    precision=precision, **stop)


def cnmf_iterations_batch(
    xs: torch.Tensor,
    c0: torch.Tensor,
    s0: torch.Tensor,
    n_iters: int,
    update_c: bool = True,
    impl: str = "auto",
    block_b=None,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` convolutive updates of every problem (no stopping).

    The fixed-iteration twin of :func:`fit_cnmf_batch`;
    ``impl="cuda"`` is kernel K5 with its stop compiled out, and the
    plain version contracts at ``precision``.  ``update_c=False``
    (frozen activations) runs only on the plain route; on the kernel
    route it raises before any launch.  ``block_b`` is ignored (a
    Mosaic tile).
    """
    if resolve_impl(impl, xs) == "cuda":
        _refuse_frozen_factors(update_c, True)
        allows_tf32(precision)  # validated; K5 computes no matmul
        return cnmf_cuda.cnmf_iterations_cuda(xs, c0, s0, n_iters)
    c, s = c0, s0
    for _ in range(n_iters):
        c, s = cnmf_update(xs, c, s, update_c=update_c, precision=precision)
    return c, s


def init_cnmf(
    x: np.ndarray,
    n_synergies: int,
    n_lags: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scaled-random non-negative init (sklearn's ``init='random'`` scale).

    Factors are drawn uniform and scaled so the reconstruction's
    expected magnitude matches the data:
    ``sqrt(mean(X) / (K * D))`` per factor entry.  Batched inputs
    ``(B, T, L)`` return batched factors, problem ``b`` drawn from
    ``np.random.default_rng(seed + b)``; the draws are the JAX
    package's, bit for bit.
    """
    x = np.asarray(x)
    if x.ndim == 3:
        pairs = [
            init_cnmf(x[b], n_synergies, n_lags, seed=seed + b)
            for b in range(x.shape[0])
        ]
        return (
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]),
        )
    t, n_m = x.shape
    rng = np.random.default_rng(seed)
    scale = np.sqrt(x.mean() / (n_synergies * n_lags)) if x.size else 1.0
    c = rng.uniform(0, 2 * scale, size=(t, n_synergies))
    s = rng.uniform(0, 2 * scale, size=(n_synergies, n_lags, n_m))
    return c.astype(x.dtype, copy=False), s.astype(x.dtype, copy=False)


def normalize_synergies(
    c: torch.Tensor, s: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-Frobenius-norm synergies; activations rescaled inversely.

    Zero synergies (norm 0) are left untouched.  Takes single
    ``(T, K)`` / ``(K, D, L)`` or batched ``(B, ...)`` factors.
    """
    norms = (s * s).sum(dim=(-2, -1), keepdim=True).sqrt()
    safe = torch.where(norms == 0, 1.0, norms)
    return c * safe.squeeze(-1).transpose(-1, -2), s / safe


class TimeVaryingSynergyResult(NamedTuple):
    """One trial's best-restart time-varying synergies.

    Attributes:
        synergies: ``{k: (n_lags, n_muscles) DataFrame}``, one
            spatiotemporal pattern per synergy, unit Frobenius norm,
            columns named after the muscles.
        activations: ``(T, n_synergies)`` DataFrame of recruitment
            trains.
        vaf: overall VAF of the reconstruction (scalar float).
        vaf_per_muscle: Series of per-muscle VAF, indexed by muscle.
        n_iter: iterations used by the winning restart.
        restart_errors: final Frobenius error of every restart (the
            winner is the argmin).
    """

    synergies: dict
    activations: "object"
    vaf: float
    vaf_per_muscle: "object"
    n_iter: int
    restart_errors: np.ndarray


def _init_c(x: torch.Tensor, k: int, n_lags: int, seed: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`cnmf_transform`'s default activations: :func:`init_cnmf`'s
    scale (``sqrt(mean(X) / (K * D))``) times uniform draws on ``[0,
    2)``.  The draws are the JAX package's (``jax.random.uniform`` from
    ``PRNGKey(seed)``, trial ``b`` of a batch from ``fold_in(key, b)``),
    equal bit for bit, computed on ``x``'s device by PyTorch integer
    operations (:func:`.._prng.uniform_torch`), so a traced transform
    draws them too; a ``torch.Generator`` is used instead when given."""
    denom = float(k * n_lags)
    t = x.shape[-2]
    if generator is not None:
        u = torch.rand(x.shape[:-2] + (t, k), generator=generator, dtype=x.dtype,
                       device=generator.device).to(x.device)
    else:
        key = _prng.prng_key(seed)
        if x.ndim == 2:
            u = _prng.uniform_torch(int(key[0]), int(key[1]), t * k, x.dtype, x.device)
        else:
            k0, k1 = _prng.fold_in_torch(
                key, torch.arange(x.shape[0], dtype=torch.int64, device=x.device))
            u = _prng.uniform_torch(k0[:, None], k1[:, None], t * k, x.dtype, x.device)
        u = u.reshape(x.shape[:-2] + (t, k))
    if x.ndim == 2:
        scale = (x.mean() / denom).sqrt() if x.numel() else 1.0
        return u * (2.0 * scale)
    scales = (x.mean(dim=(1, 2)) / denom).sqrt()
    return u * (2.0 * scales)[:, None, None]


def _transform_loop(x, s, c0, max_iter: int, tol: float, precision, loop=eager_loop):
    """:func:`fit_cnmf` of ``x (B, T, L)`` with the synergies ``s`` frozen,
    each trial stopping on its own, written for ``loop``
    (:func:`~.._common.eager_loop`, or ``while_loop`` when traced): a
    body call is one 10-iteration chunk of the trials still going, then
    the stopping check.  Returns ``(c, n_iter, previous_error,
    converged)``."""
    b = x.shape[0]

    def error(c):
        return _frobenius_error(x, c, s, precision)

    err0 = error(c0)
    scale = err0.clamp(min=EPSILON)

    def cond(c, n_iter, prev, conv):
        return (~conv & (n_iter < max_iter)).any()

    def body(c, n_iter, prev, conv):
        act = ~conv & (n_iter < max_iter)

        def one(c):
            c_new, _ = cnmf_update(x, c, s, update_s=False, precision=precision)
            return (torch.where(act[:, None, None], c_new, c),)

        (c,) = repeat(_CHUNK, one, (c,), loop)
        err = error(c)
        n_iter = n_iter + _CHUNK * act.to(n_iter.dtype)
        return (c, n_iter, torch.where(act, err, prev),
                torch.where(act, (prev - err) / scale < tol, conv))

    return loop(cond, body, (c0.clone(), torch.zeros(b, dtype=torch.int32, device=x.device),
                             err0.clone(), torch.zeros(b, dtype=torch.bool, device=x.device)))


def _transform(x, s, c0, max_iter, tol, seed, precision, generator=None,
               loop=eager_loop) -> CNMFState:
    """:func:`cnmf_transform` on tensors, its loop ``loop``."""
    if c0 is None:
        c0 = _init_c(x, s.shape[-3], s.shape[-2], seed, generator)
    single = x.ndim == 2
    if single:
        x, c0, s = x[None], c0[None], s[None]
    elif s.ndim == 3:
        s = s.expand((x.shape[0],) + tuple(s.shape))
    c, n_iter, prev, conv = _transform_loop(x, s, c0.to(x.dtype), max_iter, tol,
                                            precision, loop)
    state = CNMFState(c, s, n_iter, prev, conv)
    return CNMFState(*(f[0] for f in state)) if single else state


def cnmf_transform(
    x: torch.Tensor,
    s: torch.Tensor,
    c0: Optional[torch.Tensor] = None,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    precision=None,
    generator: Optional[torch.Generator] = None,
) -> CNMFState:
    """Project data onto a fixed synergy library: solve C, freeze S.

    The convolutive analog of ``NMFModel.transform``: given
    spatiotemporal synergies ``(K, D, L)`` from a prior fit, recover the
    recruitment trains of new trials.  Plain PyTorch on ``x``'s device
    (the JAX package runs it on XLA, never on its kernel), as a loop of
    10-iteration chunks that ``torch.export`` can capture
    (:mod:`.export`).

    Args:
        x: ``(T, L)`` or batched ``(B, T, L)`` non-negative data.
        s: ``(K, D, L)`` fixed synergies (or ``(B, K, D, L)`` matching
            a batched ``x``).
        c0: initial activations; by default :func:`init_cnmf`'s scale
            times the JAX package's uniform draws from ``seed`` (one
            draw for a 2-D ``x``, ``fold_in(key, b)`` for trial ``b``),
            or ``generator``'s when one is given.
        max_iter / tol: sklearn-style stopping on the Frobenius error,
            every 10 iterations, each trial on its own.

    Returns:
        :class:`CNMFState` whose ``s`` equals the input bit for bit.
    """
    x = as_tensor(x)
    s = as_tensor(s, x.device)
    if c0 is not None:
        c0 = as_tensor(c0, x.device)
    return _transform(x, s, c0, max_iter, tol, seed, precision, generator)


def tvaf(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
         precision=None) -> torch.Tensor:
    """Overall VAF of the convolutive reconstruction,
    ``1 - ||X - X^||^2 / ||X||^2``; batched factors ``(B, ...)`` give a
    ``(B,)`` vector."""
    recon = cnmf_reconstruct(c, s, precision)
    err = ((x - recon) ** 2).sum(dim=(-2, -1))
    tot = (x * x).sum(dim=(-2, -1))
    return 1.0 - err / torch.where(tot == 0, 1.0, tot)


class _TimeVaryingFit(NamedTuple):
    """:func:`_fit_time_varying`'s arrays: the winning restart's unit-norm
    synergies ``s`` and activations ``c``, VAF overall and per muscle,
    its iterations, every restart's final error."""

    c: np.ndarray
    s: np.ndarray
    vaf: float
    vaf_per_muscle: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


def _fit_time_varying(x: torch.Tensor, n_synergies: int, n_lags: int,
                      max_iter: int, tol: float, n_inits: int, seed: int,
                      impl: str, precision) -> _TimeVaryingFit:
    """The array core of :func:`find_time_varying_synergies` and
    :class:`CNMFModel`: the JAX package's refusals, its host-side
    restart inits (restart ``r`` seeded ``seed + r``), one
    :func:`fit_cnmf_batch` of the restarts where ``x`` lies, and the
    lowest-error restart's factors with their VAF, in NumPy."""
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("empty matrix passed to convolutive NMF")
    if not bool(torch.isfinite(x).all()):
        raise ValueError("Input X contains NaN or infinity.")
    if bool((x < 0).any()):
        raise ValueError("Negative values in data passed to NMF")
    t, _ = x.shape
    if not 1 <= n_synergies:
        raise ValueError(f"n_synergies must be >= 1, got {n_synergies}")
    if not 1 <= n_lags <= t:
        raise ValueError(f"n_lags must be in [1, n_samples={t}], got {n_lags}")
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")

    x_host = to_numpy(x).astype(float)
    c0, s0 = init_cnmf(np.broadcast_to(x_host, (n_inits,) + x_host.shape),
                       n_synergies, n_lags, seed=seed)
    state = fit_cnmf_batch(
        x.expand((n_inits,) + tuple(x.shape)), as_tensor(c0, x.device, x.dtype),
        as_tensor(s0, x.device, x.dtype), max_iter=max_iter, tol=tol,
        impl=torch_impl(impl), precision=precision,
    )
    errors = to_numpy(state.previous_error)
    best = int(np.argmin(errors))
    c, s = normalize_synergies(state.c[best], state.s[best])
    recon = to_numpy(cnmf_reconstruct(c, s, precision))
    err2 = ((x_host - recon) ** 2).sum(axis=0)
    tot2 = (x_host**2).sum(axis=0)
    overall = 1.0 - float(((x_host - recon) ** 2).sum()) / max(
        float((x_host**2).sum()), float(EPSILON))
    return _TimeVaryingFit(
        c=to_numpy(c), s=to_numpy(s), vaf=overall,
        vaf_per_muscle=1.0 - err2 / np.where(tot2 == 0, 1.0, tot2),
        n_iter=int(state.n_iter[best]), restart_errors=errors,
    )


def find_time_varying_synergies(
    signal_df,
    n_synergies: int,
    n_lags: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    impl: str = "auto",
    precision=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> TimeVaryingSynergyResult:
    """Extract d'Avella-style time-varying synergies from an EMG frame.

    The ``n_inits`` random restarts (restart ``r`` seeded ``seed + r``,
    :func:`init_cnmf`) are stacked on a batch axis and solved by one
    :func:`fit_cnmf_batch`: one K5 launch on the card.  The restart
    with the lowest final Frobenius error is returned with unit-norm
    synergies.  Needs pandas.

    Args:
        signal_df: non-negative ``(T, n_muscles)`` DataFrame (e.g. a
            rectified envelope), or a 2-D array or tensor.
        n_synergies: number of time-varying synergies ``K``.
        n_lags: temporal extent ``D`` of each synergy, in samples.
        max_iter / tol: sklearn-style stopping (see :func:`fit_cnmf`).
        impl: ``"auto"`` (K5 for a CUDA float32 frame, the plain fit
            otherwise), ``"torch"`` or ``"cuda"``; the JAX names
            ``"xla"`` / ``"pallas"`` map onto the last two.
        precision: matmul precision of the plain contractions.
        device, dtype: where the fit runs: the card by default, in
            float32 there; ``device="cpu"`` runs the plain fit.
    """
    import pandas

    fit = _fit_time_varying(_matrix(signal_df, device, dtype), n_synergies,
                            n_lags, max_iter, tol, n_inits, seed, impl, precision)
    t, n_m = fit.c.shape[0], fit.s.shape[-1]
    if isinstance(signal_df, pandas.DataFrame):
        columns, index = signal_df.columns, signal_df.index
    else:
        columns, index = pandas.RangeIndex(n_m), pandas.RangeIndex(t)
    return TimeVaryingSynergyResult(
        synergies={k: pandas.DataFrame(fit.s[k], columns=columns)
                   for k in range(n_synergies)},
        activations=pandas.DataFrame(
            fit.c, index=index, columns=[f"synergy {k}" for k in range(n_synergies)]),
        vaf=fit.vaf,
        vaf_per_muscle=pandas.Series(fit.vaf_per_muscle, index=columns),
        n_iter=fit.n_iter,
        restart_errors=fit.restart_errors,
    )


class CNMFModel:
    """sklearn-style estimator for the time-varying synergy model.

    The JAX package's ``CNMFModel``: ``fit`` / ``fit_transform`` solve
    both factors with batched restarts (the array core of
    :func:`find_time_varying_synergies`, one K5 launch on the card);
    ``transform`` projects new trials onto the fitted library with the
    synergies frozen (:func:`cnmf_transform`, plain PyTorch).  Needs no
    pandas.  ``device`` / ``dtype``: where it runs, the card by default
    (float32 there); ``device="cpu"`` runs the plain fits.

    Attributes after fitting:
        synergies_: ``(K, D, L)`` unit-Frobenius-norm library.
        n_components_ / n_lags_: model order actually used.
        n_iter_: iterations of the winning restart.
        reconstruction_err_: its final Frobenius error.
        restart_errors_: ``(n_inits,)`` final errors of all restarts.
    """

    def __init__(
        self,
        n_components: int,
        n_lags: int,
        *,
        tol: float = 1e-5,
        max_iter: int = 500,
        n_inits: int = 4,
        random_state: int = 0,
        impl: str = "auto",
        precision=None,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        self.n_components = n_components
        self.n_lags = n_lags
        self.tol = tol
        self.max_iter = max_iter
        self.n_inits = n_inits
        self.random_state = random_state
        self.impl = impl
        self.precision = precision
        self.device = device
        self.dtype = dtype

    def _set_fitted(self, synergies: np.ndarray, n_iter: int,
                    restart_errors: np.ndarray) -> None:
        self.synergies_ = synergies
        self.n_components_ = self.n_components
        self.n_lags_ = self.n_lags
        self.n_iter_ = n_iter
        self.restart_errors_ = restart_errors
        self.reconstruction_err_ = float(restart_errors.min())

    def fit_transform(self, X) -> np.ndarray:
        """Fit the library and return the ``(T, K)`` activations."""
        fit = _fit_time_varying(
            _matrix(X, self.device, self.dtype), self.n_components, self.n_lags,
            self.max_iter, self.tol, self.n_inits, self.random_state, self.impl,
            self.precision)
        self._set_fitted(fit.s, fit.n_iter, fit.restart_errors)
        return fit.c

    def fit(self, X) -> "CNMFModel":
        self.fit_transform(X)
        return self

    @classmethod
    def from_result(cls, res: TimeVaryingSynergyResult, n_lags: int,
                    **kwargs) -> "CNMFModel":
        """Wrap a :func:`find_time_varying_synergies` result as a fitted
        estimator; ``kwargs`` are the constructor's hyperparameters."""
        model = cls(len(res.synergies), n_lags, **kwargs)
        model._set_fitted(
            np.stack([np.asarray(res.synergies[k]) for k in range(model.n_components)]),
            res.n_iter, res.restart_errors)
        return model

    def _check_fitted(self):
        if not hasattr(self, "synergies_"):
            raise ValueError(
                "this CNMFModel instance is not fitted yet; call fit or "
                "fit_transform first"
            )

    def _transform_factors(self):
        """The fitted factors the transform holds fixed: ``(synergies,)``."""
        self._check_fitted()
        return (self.synergies_,)

    def _transform_torch(self, x: torch.Tensor, s: torch.Tensor, loop=eager_loop):
        """The transform on tensors: ``(activations, n_iter)`` against
        the library ``s``.  Traceable with ``loop=while_loop``, the
        counterpart of the JAX package's ``_transform_jax`` (what
        :mod:`.export` captures); :meth:`transform` wraps it."""
        state = _transform(x, s, None, self.max_iter, self.tol, self.random_state,
                           self.precision, loop=loop)
        return state.c, state.n_iter

    def transform(self, X) -> np.ndarray:
        """Activations of new data (``(T, L)`` or ``(B, T, L)``) against
        the fitted library."""
        (s,) = self._transform_factors()
        x = _matrix(X, self.device, self.dtype)
        return to_numpy(self._transform_torch(x, as_tensor(s, x.device, x.dtype))[0])

    def inverse_transform(self, C) -> np.ndarray:
        """Reconstruction ``X^`` from activations and the fitted library."""
        self._check_fitted()
        c = _matrix(C, self.device, self.dtype)
        return to_numpy(cnmf_reconstruct(
            c, as_tensor(self.synergies_, c.device, c.dtype), self.precision))

    def save(self, path):
        """Persist the fitted model as a pickle-free ``.npz``
        (:func:`~.persist.save_model`)."""
        from .persist import save_model

        return save_model(self, path)

    @classmethod
    def load(cls, path, device="cuda", dtype: Optional[torch.dtype] = None) -> "CNMFModel":
        """Load a model saved by :meth:`save` (``allow_pickle=False``),
        to run on ``device`` (the card by default)."""
        from .persist import load_model

        model = load_model(path, device=device, dtype=dtype)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}, not {cls.__name__}")
        return model
