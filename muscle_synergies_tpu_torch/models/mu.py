"""Frobenius multiplicative-update NMF in plain PyTorch.

Port of :mod:`muscle_synergies_tpu.models.mu`, with sklearn's semantics
(``sklearn.decomposition._nmf._fit_multiplicative_update``):

- W update ``W *= (X H^T) / (W H H^T)``, then H symmetrically;
- zero denominators replaced by float32 machine eps (sklearn EPSILON);
- optional L1/L2 penalties added to the denominators;
- a convergence test every ``check_every`` iterations on
  ``||X - WH||_F``: stop when ``(prev - err) / err_init < tol``.

Every function takes one problem ``(N, L)`` or a batch ``(B, N, L)``.
A batched :func:`fit_mu` stops each fit on its own: once a fit
converges it is frozen and the rest go on, which is the semantics of
the JAX package's vmapped ``while_loop`` and of the CUDA kernel
(:mod:`muscle_synergies_tpu_torch.models.kernels.mu_cuda`), for which
these functions are the plain reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._common import matmul_precision

# sklearn's EPSILON: np.finfo(np.float32).eps, independent of dtype.
EPSILON = 1.1920929e-07

__all__ = ["EPSILON", "mu_update", "frobenius_error", "fit_mu", "fit_chunked",
           "MUState"]


def frobenius_error(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                    precision=None) -> torch.Tensor:
    """``||X - W @ H||_F`` per problem (a scalar, or ``(B,)`` for a batch).

    ``precision`` is the JAX package's matmul precision for ``W @ H``
    (see :func:`~muscle_synergies_tpu_torch._common.allows_tf32`); the
    default is full float32.
    """
    with matmul_precision(precision):
        wh = w @ h
    diff = x - wh
    return (diff * diff).sum(dim=(-2, -1)).sqrt()


def _guard(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den == 0, torch.full_like(den, EPSILON), den)


def mu_update(
    x: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
    update_h: bool = True,
):
    """One multiplicative update of W then H (sklearn's order).

    ``inner_iter > 1`` repeats each factor's update reusing ``X H^T`` /
    ``H H^T`` (and ``W^T X`` / ``W^T W``): the accelerated MU of Gillis
    & Glineur 2012.  ``inner_iter=1`` is exactly sklearn's update.
    ``update_h=False`` freezes H (sklearn's ``transform`` path).
    """
    ht = h.transpose(-1, -2)
    xht = x @ ht
    hht = h @ ht
    for _ in range(inner_iter):
        den = w @ hht
        if l1_reg_w > 0:
            den = den + l1_reg_w
        if l2_reg_w > 0:
            den = den + l2_reg_w * w
        w = w * (xht / _guard(den))
    if not update_h:
        return w, h
    wt = w.transpose(-1, -2)
    return w, _update_h(h, wt @ x, wt @ w, l1_reg_h, l2_reg_h, inner_iter)


def _update_h(h, wtx, wtw, l1_reg_h: float, l2_reg_h: float, inner_iter: int):
    """H's half of :func:`mu_update` from ``W^T X`` and ``W^T W``."""
    for _ in range(inner_iter):
        den = wtw @ h
        if l1_reg_h > 0:
            den = den + l1_reg_h
        if l2_reg_h > 0:
            den = den + l2_reg_h * h
        h = h * (wtx / _guard(den))
    return h


def _masked_update(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                   mask: torch.Tensor):
    """One weighted multiplicative update of W then H, on the observed
    (``mask`` = 1) entries only: the EM treatment of missing entries,
    ``W *= ((M*X) H^T) / ((M*(WH)) H^T)`` and symmetrically for H."""
    mx = mask * x
    ht = h.transpose(-1, -2)
    w = w * ((mx @ ht) / _guard((mask * (w @ h)) @ ht))
    wt = w.transpose(-1, -2)
    h = h * ((wt @ mx) / _guard(wt @ (mask * (w @ h))))
    return w, h


def _masked_error(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """``||mask * (X - W @ H)||_F`` per problem."""
    diff = mask * (x - w @ h)
    return (diff * diff).sum(dim=(-2, -1)).sqrt()


class MUState(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor
    n_iter: torch.Tensor  # int32
    previous_error: torch.Tensor
    converged: torch.Tensor  # bool


def fit_mu(
    x: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
    update_h: bool = True,
) -> MUState:
    """Run MU-NMF to convergence, per problem.

    Args:
        x: ``(N, L)`` or ``(B, N, L)`` non-negative data.
        w0, h0: initial factors ``(..., N, k)`` / ``(..., k, L)``.
        max_iter: iteration cap (one W+H update is one iteration).
        tol: relative Frobenius improvement threshold; ``tol <= 0``
            disables the check (always runs ``max_iter``).
        check_every: cadence of the convergence test (sklearn uses 10).
        update_h: ``False`` keeps H fixed at ``h0`` (the caller is
            ``NMFModel.transform``).

    Returns:
        :class:`MUState` with final factors, iterations done, the error
        at the last convergence check and the convergence flags.
    """
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    return MUState(*fit_chunked(
        x, w0, h0,
        lambda xa, wa, ha: mu_update(xa, wa, ha, *regs, inner_iter, update_h),
        frobenius_error, max_iter, tol, check_every,
    ))


def fit_chunked(x, w0, h0, step, error, max_iter: int, tol: float,
                check_every: int, mask=None):
    """sklearn's multiplicative-update loop, each fit stopping on its own.

    ``step(x, w, h)`` is one update and ``error(x, w, h)`` the
    per-problem stopping statistic; with a ``mask`` of ``x``'s shape
    both also take the fits' mask, ``step(x, w, h, mask)``.  Updates
    run in chunks of ``check_every``, the last one cut at ``max_iter``;
    after each chunk (when ``tol > 0``) a fit converges if ``(previous
    - current) / initial < tol`` at an exact multiple of
    ``check_every``, and is frozen from then on.  The statistic at
    ``max_iter`` is stored without a test.

    Returns:
        ``(w, h, n_iter, previous_error, converged)``, without the
        batch dimension for a 2-D ``x``.
    """
    single = x.ndim == 2
    if single:
        x, w0, h0 = x[None], w0[None], h0[None]
    b = x.shape[0]
    masks = () if mask is None else (mask[None] if single else mask,)
    w, h = w0.clone(), h0.clone()
    err0 = error(x, w, h, *masks)
    prev = err0.clone()
    n_iter = torch.zeros(b, dtype=torch.int32, device=x.device)
    converged = torch.zeros(b, dtype=torch.bool, device=x.device)
    done = 0  # iterations run by every fit still going (they move together)
    while done < max_iter:
        active = (~converged).nonzero().flatten()
        if active.numel() == 0:
            break
        xa, wa, ha = x[active], w[active], h[active]
        ma = tuple(m[active] for m in masks)
        steps = min(check_every, max_iter - done)
        for _ in range(steps):
            wa, ha = step(xa, wa, ha, *ma)
        done += steps
        w[active], h[active] = wa, ha
        n_iter[active] = done
        if tol > 0:
            err = error(xa, wa, ha, *ma)
            newly = (prev[active] - err) / err0[active] < tol
            converged[active] = newly & (done % check_every == 0)
            prev[active] = err
    out = (w, h, n_iter, prev, converged)
    if single:
        return tuple(t[0] for t in out)
    return out
