"""Beta-divergence multiplicative-update NMF (KL, Itakura-Saito, any beta).

Port of :mod:`muscle_synergies_tpu.models.beta`: sklearn's
``_fit_multiplicative_update`` for ``beta_loss != 2``, branch for
branch (sklearn ``_multiplicative_update_w/_h``, ``_beta_divergence``):

- numerators and denominators with sklearn's EPSILON (float32 eps)
  clamps in the same places (``WH`` clamped where a negative power
  would blow up; zero denominators replaced);
- sklearn's damping exponent ``gamma`` (``1/(2-beta)`` for
  ``beta < 1``, ``1/(beta-1)`` for ``beta > 2``, else 1);
- the stability flushes (``W[W < float64-eps] = 0`` for ``beta < 1``,
  the same for H when ``beta <= 1``);
- the stopping rule: the square-rooted beta divergence every
  ``check_every`` iterations, ``(previous - current) / at_init < tol``.

Every function takes one problem ``(N, L)`` or a batch ``(B, N, L)``;
a batched :func:`fit_mu_beta` stops each fit on its own, which is the
semantics of the JAX package's vmapped ``while_loop`` and of the CUDA
kernel (:mod:`muscle_synergies_tpu_torch.models.kernels.beta_cuda`),
for which these functions are the plain reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._common import matmul_precision
from .mu import EPSILON, _guard, fit_chunked

# sklearn's stability-flush threshold (np.finfo(np.float64).eps)
F64_EPS = float(np.finfo(np.float64).eps)

__all__ = [
    "F64_EPS",
    "BetaState",
    "beta_divergence",
    "beta_loss_to_float",
    "fit_mu_beta",
    "mu_update_beta",
]

_SUM = (-2, -1)


def beta_loss_to_float(beta_loss) -> float:
    """sklearn's string-to-float mapping for ``beta_loss``.

    Example:
        >>> beta_loss_to_float("kullback-leibler")
        1.0
        >>> beta_loss_to_float(1.5)
        1.5
    """
    mapping = {"frobenius": 2.0, "kullback-leibler": 1.0, "itakura-saito": 0.0}
    if isinstance(beta_loss, str):
        try:
            return mapping[beta_loss]
        except KeyError:
            raise ValueError(
                f"Invalid beta_loss parameter: got {beta_loss!r} instead of "
                f"one of {sorted(mapping)}, or a float"
            ) from None
    return float(beta_loss)


def _gamma(beta: float) -> float:
    """sklearn's MU exponent for general beta."""
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


def beta_divergence(x, w, h, beta: float, square_root: bool = True, precision=None):
    """sklearn's ``_beta_divergence`` for dense inputs, per problem.

    Entries with ``x <= EPSILON`` leave the data-dependent terms, as
    sklearn's ``indices = X_data > EPSILON`` mask does, including the
    quirk that the Itakura-Saito constant counts *all* entries.
    ``precision`` is the JAX-style matmul precision of ``W @ H`` (see
    :func:`~muscle_synergies_tpu_torch._common.allows_tf32`; full
    float32 by default).

    Returns:
        a scalar for one problem, ``(B,)`` for a batch.
    """
    with matmul_precision(precision):
        wh = w @ h
    if beta == 2.0:
        res = ((x - wh) ** 2).sum(dim=_SUM) / 2.0
        return (res * 2.0).clamp(min=0.0).sqrt() if square_root else res
    mask = x > EPSILON
    whc = wh.clamp(min=EPSILON)
    div = torch.where(mask, x / whc, 1.0)
    if beta == 1.0:
        log_term = torch.where(mask, x * div.log(), 0.0).sum(dim=_SUM)
        sum_wh = (w.sum(dim=-2) * h.sum(dim=-1)).sum(dim=-1)
        res = log_term + sum_wh - torch.where(mask, x, 0.0).sum(dim=_SUM)
    elif beta == 0.0:
        res = (
            torch.where(mask, div, 0.0).sum(dim=_SUM)
            - x.shape[-2] * x.shape[-1]
            - torch.where(mask, div.log(), 0.0).sum(dim=_SUM)
        )
    else:
        sum_wh_beta = (wh**beta).sum(dim=_SUM)
        sum_x_wh = torch.where(mask, x * whc ** (beta - 1.0), 0.0).sum(dim=_SUM)
        res = torch.where(mask, x**beta, 0.0).sum(dim=_SUM) - beta * sum_x_wh
        res = res + sum_wh_beta * (beta - 1.0)
        res = res / (beta * (beta - 1.0))
    if square_root:
        return (2.0 * res.clamp(min=0.0)).sqrt()
    return res


def _wh_pow_times_x(x, wh, beta: float):
    """``(WH)^(beta-2) * X`` with sklearn's sub-EPSILON clamp."""
    if beta - 2.0 < 0:
        wh = wh.clamp(min=EPSILON)
    if beta == 1.0:
        return x / wh
    if beta == 0.0:
        return x * wh**-2
    return x * wh ** (beta - 2.0)


def mu_update_beta(
    x,
    w,
    h,
    beta: float,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    update_h: bool = True,
):
    """One sklearn-order MU iteration for general beta (W then H).

    ``update_h=False`` freezes H (sklearn's ``transform`` path).
    """
    gamma = _gamma(beta)

    # ---- W update ----
    ht = h.transpose(-1, -2)
    wh = w @ h
    numerator = _wh_pow_times_x(x, wh, beta) @ ht
    if beta == 1.0:
        denominator = h.sum(dim=-1).unsqueeze(-2).expand_as(w)
    else:
        whd = wh.clamp(min=EPSILON) if beta - 1.0 < 0 else wh
        denominator = whd ** (beta - 1.0) @ ht
    if l1_reg_w > 0:
        denominator = denominator + l1_reg_w
    if l2_reg_w > 0:
        denominator = denominator + l2_reg_w * w
    delta = numerator / _guard(denominator)
    if gamma != 1.0:
        delta = delta**gamma
    w = w * delta
    if beta < 1.0:
        w = torch.where(w < F64_EPS, 0.0, w)
    if not update_h:
        return w, h

    # ---- H update ----
    wt = w.transpose(-1, -2)
    wh = w @ h
    numerator = wt @ _wh_pow_times_x(x, wh, beta)
    if beta == 1.0:
        w_sum = w.sum(dim=-2)
        w_sum = torch.where(w_sum == 0, 1.0, w_sum)
        denominator = w_sum.unsqueeze(-1).expand_as(h)
    else:
        whd = wh.clamp(min=EPSILON) if beta - 1.0 < 0 else wh
        denominator = wt @ whd ** (beta - 1.0)
    if l1_reg_h > 0:
        denominator = denominator + l1_reg_h
    if l2_reg_h > 0:
        denominator = denominator + l2_reg_h * h
    delta = numerator / _guard(denominator)
    if gamma != 1.0:
        delta = delta**gamma
    h = h * delta
    if beta <= 1.0:
        h = torch.where(h < F64_EPS, 0.0, h)
    return w, h


class BetaState(NamedTuple):
    """Final state of a beta-MU solve (mirrors ``MUState``)."""

    w: torch.Tensor
    h: torch.Tensor
    n_iter: torch.Tensor  # int32
    previous_error: torch.Tensor
    converged: torch.Tensor  # bool


def fit_mu_beta(
    x,
    w0,
    h0,
    beta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    update_h: bool = True,
) -> BetaState:
    """Beta-MU to convergence with sklearn's exact stopping rule, per problem.

    Checks come only at multiples of ``check_every``; a last partial
    chunk runs up to ``max_iter`` and stores its divergence untested.
    ``update_h=False`` keeps H fixed at ``h0`` (the caller is
    ``NMFModel.transform``).
    """
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    return BetaState(*fit_chunked(
        x, w0, h0,
        lambda xa, wa, ha: mu_update_beta(xa, wa, ha, beta, *regs, update_h),
        lambda xa, wa, ha: beta_divergence(xa, wa, ha, beta),
        max_iter, tol, check_every,
    ))
