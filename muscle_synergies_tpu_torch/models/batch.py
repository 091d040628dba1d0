"""Batched NMF: a whole dataset's fits in one solve.

Port of :mod:`muscle_synergies_tpu.models.batch` (the Frobenius MU and
CD paths, the beta-divergence MU path and :func:`rank_sweep_batch`).
Every function takes a ``(B, N, L)`` stack of problems with factors W
``(B, N, k)`` and H ``(B, k, L)``.  ``impl`` picks the implementation:

- ``"cuda"``: the hand-written kernels (:mod:`.kernels`), one thread
  block per fit, the whole solve one launch, L1/L2 penalties included;
  CUDA float32 only;
- ``"torch"``: the plain PyTorch versions (:mod:`.mu`, :mod:`.hals`,
  :mod:`.beta`) on any device and dtype;
- ``"auto"`` (the default): the kernel for a CUDA problem (which must
  be float32), the plain version for a CPU one.

Ragged trials are zero-padded (:func:`pad_and_stack`): padded rows of X
are zero and the matching rows of W start at zero, which both solvers
preserve.  Rank sweeps zero-pad factors to the largest rank; padded
components stay exactly zero under both solvers and both
implementations.

``block_b=`` is accepted wherever the JAX package takes it and ignored:
it is the Pallas kernels' tile of trials per Mosaic block, and the CUDA
kernels pick their own layout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._common import as_tensor, entry_placement, resolve_impl
from .beta import BetaState, beta_loss_to_float, fit_mu_beta
from .hals import CDState, fit_cd
from .init import initialize_nmf
from .kernels import beta_cuda, cd_cuda, mu_cuda
from .mu import MUState, fit_mu, mu_update

__all__ = [
    "pad_and_stack",
    "init_batch",
    "mu_update_batch",
    "mu_iterations_batch",
    "fit_mu_batch",
    "cd_iterations_batch",
    "fit_cd_batch",
    "beta_mu_iterations_batch",
    "fit_mu_beta_batch",
    "rank_sweep_batch",
    "vaf_batch",
]


def pad_and_stack(
    trials: Sequence[np.ndarray], pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged ``(N_i, L)`` trials into ``(B, N_max, L)`` + mask.

    The package's one padding step, on the host (NumPy in, NumPy out);
    callers place the result with ``as_tensor``.

    Returns:
        ``(batch, mask)`` where ``mask[b, n]`` is 1.0 for real samples
        and 0.0 for padding.  Padded cells are zero.
    """
    lengths = [t.shape[0] for t in trials]
    n_max = pad_to if pad_to is not None else max(lengths)
    if any(n > n_max for n in lengths):
        raise ValueError(f"pad_to={n_max} is smaller than the longest trial")
    l = trials[0].shape[1]
    batch = np.zeros((len(trials), n_max, l), dtype=np.asarray(trials[0]).dtype)
    mask = np.zeros((len(trials), n_max), dtype=batch.dtype)
    for b, t in enumerate(trials):
        if t.shape[1] != l:
            raise ValueError("all trials must share the channel count")
        batch[b, : t.shape[0]] = t
        mask[b, : t.shape[0]] = 1.0
    return batch, mask


def init_batch(
    xs,
    n_components: int,
    init: Optional[str] = None,
    mask=None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
):
    """Factor initialization of every problem of a ``(B, N, L)`` batch.

    With a padding ``mask``, the padded rows of every ``W`` are zeroed
    so they stay zero through the updates.
    """
    xs = as_tensor(xs, device, dtype)
    w, h = initialize_nmf(xs, n_components, init=init, seed=seed,
                          generator=generator)
    if mask is not None:
        w = w * as_tensor(mask, xs.device, xs.dtype)[..., None]
    return w, h


def mu_update_batch(xs, w, h, inner_iter: int = 1):
    """One MU iteration over a ``(B, N, L)`` batch (batched matmuls).

    The JAX package's ``mu_update_batch``, in its order: ``X H^T`` and
    ``H H^T`` first, zero denominators replaced by ``EPSILON``, and
    ``inner_iter > 1`` repeating each factor's update with the fixed
    factor's cross products reused.  That is
    :func:`~muscle_synergies_tpu_torch.models.mu.mu_update` without
    penalties, which it calls.
    """
    return mu_update(xs, w, h, inner_iter=inner_iter)


def mu_iterations_batch(xs, w, h, n_iters: int, impl: str = "auto",
                        block_b: Optional[int] = None, inner_iter: int = 1):
    """Run ``n_iters`` MU iterations of every problem (no stopping).

    The throughput primitive; ``impl="cuda"`` is kernel K1 with its
    stopping rule compiled out.  ``block_b`` is ignored (a Mosaic tile).
    """
    if resolve_impl(impl, xs) == "cuda":
        return mu_cuda.mu_iterations_cuda(xs, w, h, n_iters, inner_iter)
    return mu_cuda.mu_iterations_plain(xs, w, h, n_iters, inner_iter)


def fit_mu_batch(
    xs,
    w0,
    h0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    impl: str = "auto",
    block_b: Optional[int] = None,
    inner_iter: int = 1,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    *,
    plan_batch: Optional[int] = None,
) -> MUState:
    """MU-NMF over a ``(B, N, L)`` batch with per-problem convergence.

    ``block_b`` is ignored (a Mosaic tile).  ``plan_batch``: on the card,
    the larger batch these fits were cut from, whose kernel plan they
    take (:func:`~.kernels.mu_cuda.fit_mu_cuda`); the plain fit has no
    plan.
    """
    kw = dict(max_iter=max_iter, tol=tol, check_every=check_every, inner_iter=inner_iter,
              l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w, l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)
    if resolve_impl(impl, xs) == "cuda":
        return mu_cuda.fit_mu_cuda(xs, w0, h0, plan_batch=plan_batch, **kw)
    return fit_mu(xs, w0, h0, **kw)


def cd_iterations_batch(xs, w, h, n_iters: int, impl: str = "auto",
                        block_b: Optional[int] = None):
    """Run ``n_iters`` CD/HALS outer iterations of every problem (no stopping).

    One iteration is a cyclic pass over W's components then H's
    (sklearn's ``shuffle=False`` order); ``impl="cuda"`` is kernel K2
    with its stopping rule compiled out.  ``block_b`` is ignored (a
    Mosaic tile).
    """
    if resolve_impl(impl, xs) == "cuda":
        return cd_cuda.cd_iterations_cuda(xs, w, h, n_iters)
    return cd_cuda.cd_iterations_plain(xs, w, h, n_iters)


def fit_cd_batch(
    xs,
    w0,
    h0,
    max_iter: int = 200,
    tol: float = 1e-4,
    impl: str = "auto",
    block_b: Optional[int] = None,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
) -> CDState:
    """Coordinate-descent NMF over a ``(B, N, L)`` batch, per-problem stop.

    ``block_b`` is ignored (a Mosaic tile).
    """
    fit = cd_cuda.fit_cd_cuda if resolve_impl(impl, xs) == "cuda" else fit_cd
    return fit(xs, w0, h0, max_iter=max_iter, tol=tol, l1_reg_w=l1_reg_w,
               l2_reg_w=l2_reg_w, l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)


def beta_mu_iterations_batch(xs, w, h, n_iters: int, beta: float = 1.0,
                             impl: str = "auto", block_b: Optional[int] = None):
    """Run ``n_iters`` beta-MU iterations of every problem (no stopping).

    The beta-divergence counterpart of :func:`mu_iterations_batch`, for
    any float ``beta``; ``impl="cuda"`` is kernel K4 with its stopping
    rule compiled out.  ``block_b`` is ignored (a Mosaic tile).
    """
    if resolve_impl(impl, xs) == "cuda":
        return beta_cuda.beta_iterations_cuda(xs, w, h, n_iters, beta)
    return beta_cuda.beta_iterations_plain(xs, w, h, n_iters, beta)


def fit_mu_beta_batch(
    xs,
    w0,
    h0,
    beta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    impl: str = "auto",
    block_b: Optional[int] = None,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
) -> BetaState:
    """Beta-divergence MU over a ``(B, N, L)`` batch, per-problem stop.

    ``impl="cuda"`` is kernel K4 with sklearn's stop inside each block;
    ``"torch"`` is
    :func:`~muscle_synergies_tpu_torch.models.beta.fit_mu_beta`.
    ``block_b`` is ignored (a Mosaic tile).
    """
    cuda = resolve_impl(impl, xs) == "cuda"
    fit = beta_cuda.fit_beta_cuda if cuda else fit_mu_beta
    return fit(xs, w0, h0, beta=beta, max_iter=max_iter, tol=tol,
               check_every=check_every, l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
               l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)


def rank_sweep_batch(
    x,
    ranks: Sequence[int],
    init: Optional[str] = None,
    solver: str = "mu",
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    svd_method: str = "exact",
    beta_loss="frobenius",
    inner_iter: int = 1,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    impl: str = "auto",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Factorize one ``(N, L)`` trial at several ranks in one batched fit.

    Factors for every rank are zero-padded to ``max(ranks)``; the padded
    components stay exactly zero under every solver, with or without
    the L1/L2 penalties, so entry ``i`` equals an independent
    rank-``ranks[i]`` fit.  ``beta_loss != 'frobenius'`` requires
    ``solver='mu'``; so does ``inner_iter > 1``.

    Runs on the card unless ``device="cpu"`` (float32 there unless
    ``dtype`` says otherwise), where ``impl="auto"`` makes the whole
    sweep one launch of K2 (CD), K1 (MU) or K4 (beta-MU).  Each runs a
    trial of any length: one warp or one thread block a fit for a
    time-normalised 200 x 8 trial, many blocks of the card a fit (K1,
    K2) or one thread-block cluster a fit (K4) for a longer one (20,000
    or 124,460 x 8).  ``impl="torch"`` is the plain
    fit on the card.

    Returns:
        ``(states, vafs)``: the stacked solver states (leading axis =
        rank index; slice each rank's factors as ``w[i][:, :ranks[i]]``)
        and the overall VAF per rank.
    """
    x = as_tensor(x, *entry_placement(device, dtype))
    ranks = list(ranks)
    beta = beta_loss_to_float(beta_loss)
    if beta != 2.0 and solver != "mu":
        raise ValueError(
            f"beta_loss={beta_loss!r} requires solver='mu', got {solver!r}"
        )
    if inner_iter != 1 and (solver != "mu" or beta != 2.0):
        raise ValueError(
            "inner_iter > 1 is only available for the Frobenius MU solver"
        )
    if solver not in ("mu", "cd"):
        raise ValueError(f"unknown solver: {solver!r}")
    k_max = max(ranks)
    w_stack, h_stack = [], []
    for k in ranks:
        w0, h0 = initialize_nmf(x, k, init=init, seed=seed, svd_method=svd_method)
        w_stack.append(torch.nn.functional.pad(w0.to(x.dtype), (0, k_max - k)))
        h_stack.append(torch.nn.functional.pad(h0.to(x.dtype), (0, 0, 0, k_max - k)))
    w0s, h0s = torch.stack(w_stack), torch.stack(h_stack)
    xs = x.expand((len(ranks),) + tuple(x.shape)).contiguous()
    regs = dict(l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
                l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)
    if beta != 2.0:
        states = fit_mu_beta_batch(xs, w0s, h0s, beta=beta, max_iter=max_iter,
                                   tol=tol, impl=impl, **regs)
        h_final = states.h
    elif solver == "mu":
        states = fit_mu_batch(xs, w0s, h0s, max_iter=max_iter, tol=tol,
                              impl=impl, inner_iter=inner_iter, **regs)
        h_final = states.h
    else:
        states = fit_cd_batch(xs, w0s, h0s, max_iter=max_iter, tol=tol,
                              impl=impl, **regs)
        h_final = states.ht.transpose(-1, -2)
    vafs, _ = vaf_batch(xs, states.w, h_final)
    return states, vafs


def vaf_batch(xs, ws, hs):
    """Overall and per-channel VAF for a batch of factorizations.

    ``VAF = 1 - ||X - WH||^2 / ||X||^2``.

    Returns:
        ``(overall, per_channel)`` with shapes ``(B,)`` and ``(B, L)``.
    """
    err = xs - ws @ hs
    e2, x2 = err * err, xs * xs
    overall = 1.0 - e2.sum(dim=(-2, -1)) / x2.sum(dim=(-2, -1))
    per_channel = 1.0 - e2.sum(dim=-2) / x2.sum(dim=-2)
    return overall, per_channel
