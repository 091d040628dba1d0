"""Convolutive NMF: time-varying muscle synergies.

Port of the solver half of :mod:`muscle_synergies_tpu.models.cnmf`.
Each synergy is a short spatiotemporal pattern ``S_k`` (D lags x L
muscles) recruited by a non-negative activation train ``c_k(t)``
(d'Avella, Saltiel & Bizzi 2003), so that

    X[t, l] ~ sum_k sum_d C[t - d, k] * S[k, d, l],

fitted by Smaragdis's convolutive multiplicative updates in the
package's ``(time, muscles)`` orientation: S lag slice by lag slice,
then C by the ratio of sums over lags, with sklearn's EPSILON
denominator guard and its relative-improvement stop every
``check_every`` iterations.

Every function takes one problem (X ``(T, L)``, C ``(T, K)``, S
``(K, D, L)``) or a batch with a leading ``B``.  :func:`fit_cnmf_batch`
and :func:`cnmf_iterations_batch` pick the implementation (``impl``):
the hand-written kernel for a CUDA float32 batch
(:mod:`.kernels.cnmf_cuda`), the plain PyTorch functions here
otherwise.  Scale indeterminacy is fixed by
:func:`normalize_synergies`.

``precision=`` is the JAX package's matmul precision for the plain
contractions (see :func:`~muscle_synergies_tpu_torch._common.allows_tf32`;
full float32 by default); the kernel computes in float32 on the CUDA
cores whatever it says.  ``block_b=`` is accepted and ignored: it is the
Pallas kernel's tile of trials per Mosaic block.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._common import allows_tf32, matmul_precision, resolve_impl
from .kernels import cnmf_cuda
from .mu import EPSILON, _guard

__all__ = [
    "CNMFState",
    "TimeVaryingSynergyResult",
    "cnmf_iterations_batch",
    "cnmf_reconstruct",
    "cnmf_update",
    "fit_cnmf",
    "fit_cnmf_batch",
    "init_cnmf",
    "normalize_synergies",
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
    x: torch.Tensor, c: torch.Tensor, s: torch.Tensor, precision=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One multiplicative update of S then C.

    S update (each lag slice on its own, exact MU):
        ``S[k, d] *= (shift_d(C)^T X) / (shift_d(C)^T X^)``
    C update (ratio of sums over lags, with the fresh S):
        ``C *= (sum_d shift_{-d}(X S_d^T)) / (sum_d shift_{-d}(X^ S_d^T))``
    """
    n_lags = s.shape[-2]
    cs = _lag_stack(c, n_lags)
    with matmul_precision(precision):
        xhat = torch.einsum("...dtk,...kdl->...tl", cs, s)
        num_s = torch.einsum("...dtk,...tl->...kdl", cs, x)
        den_s = torch.einsum("...dtk,...tl->...kdl", cs, xhat)
    s = s * (num_s / _guard(den_s))
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
        precision: matmul precision of the contractions.
    """
    single = x.ndim == 2
    if single:
        x, c0, s0 = x[None], c0[None], s0[None]
    b = x.shape[0]
    c, s = c0.to(x.dtype).clone(), s0.to(x.dtype).clone()
    err0 = _frobenius_error(x, c, s, precision)
    scale = err0.clamp(min=EPSILON)
    prev = err0.clone()
    n_iter = torch.zeros(b, dtype=torch.int32, device=x.device)
    converged = torch.zeros(b, dtype=torch.bool, device=x.device)
    while True:
        active = ((n_iter < max_iter) & ~converged).nonzero().flatten()
        if active.numel() == 0:
            break
        xa, ca, sa = x[active], c[active], s[active]
        for _ in range(check_every):
            ca, sa = cnmf_update(xa, ca, sa, precision)
        err = _frobenius_error(xa, ca, sa, precision)
        c[active], s[active] = ca, sa
        n_iter[active] += check_every
        converged[active] = (prev[active] - err) / scale[active] < tol
        prev[active] = err
    state = CNMFState(c, s, n_iter, prev, converged)
    if single:
        return CNMFState(*(t[0] for t in state))
    return state


def fit_cnmf_batch(
    xs: torch.Tensor,
    c0: torch.Tensor,
    s0: torch.Tensor,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    impl: str = "auto",
    block_b=None,
    precision=None,
) -> CNMFState:
    """Convolutive NMF over a ``(B, T, L)`` stack, per-problem stopping.

    ``impl="cuda"`` (``"auto"`` on a CUDA float32 batch) is kernel K5
    with its stop inside each block; ``"torch"`` is :func:`fit_cnmf`,
    its contractions at ``precision``.  Both follow the JAX package's
    ``fit_cnmf_batch`` iterate for iterate.  ``block_b`` is ignored (a
    Mosaic tile).
    """
    stop = dict(max_iter=max_iter, tol=tol, check_every=check_every)
    if resolve_impl(impl, xs) == "cuda":
        allows_tf32(precision)  # validated; K5 computes no matmul
        return cnmf_cuda.fit_cnmf_cuda(xs, c0, s0, **stop)
    return fit_cnmf(xs, c0, s0, precision=precision, **stop)


def cnmf_iterations_batch(
    xs: torch.Tensor,
    c0: torch.Tensor,
    s0: torch.Tensor,
    n_iters: int,
    impl: str = "auto",
    block_b=None,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` convolutive updates of every problem (no stopping).

    The fixed-iteration twin of :func:`fit_cnmf_batch`;
    ``impl="cuda"`` is kernel K5 with its stop compiled out, and the
    plain version contracts at ``precision``.  ``block_b`` is ignored
    (a Mosaic tile).
    """
    if resolve_impl(impl, xs) == "cuda":
        allows_tf32(precision)  # validated; K5 computes no matmul
        return cnmf_cuda.cnmf_iterations_cuda(xs, c0, s0, n_iters)
    return cnmf_cuda.cnmf_iterations_plain(xs, c0, s0, n_iters, precision)


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
