"""Mesh-sharded NMF: data-parallel trials x time-sharded samples.

Port of :mod:`muscle_synergies_tpu.parallel.nmf`.  The sharded
multiplicative update is exact, not approximate:

- ``X`` and ``W`` are sharded ``(data, time)``: each process owns a
  slice of the trial batch and a contiguous block of each trial's
  samples.  ``H`` is replicated within a time group.
- The W update is local: its numerator ``X Ht`` and denominator
  ``W (H Ht)`` involve only the process's own sample rows.
- The H update needs the time-reduced Grams ``Wt X`` and ``Wt W``;
  each process contributes its partial product and an ``all_reduce``
  over the ``time`` group completes them.
- The stopping error is likewise a time-reduced sum of local squared
  residuals, so every process of a time group takes the same stopping
  decision and leaves the loop at the same chunk (a process that left
  while a peer waits in a collective would hang the job); different
  data shards stop independently and never communicate in the loop.

The loop is the port's :func:`~..models.mu.fit_chunked`, in Python:
chunks of ``check_every`` iterations on the fits still going, one host
read a chunk.  The local steps are plain PyTorch, as the JAX local
steps are XLA (no kernel).
"""

from __future__ import annotations

import functools

import torch

from ..models.hals import CDState, _sweep
from ..models.mu import EPSILON, MUState, _guard, fit_chunked, mu_update
from . import _spmd
from .collectives import axis_sum, time_sum
from .mesh import DATA_AXIS, MODEL_AXIS, TIME_AXIS

__all__ = [
    "sharded_mu_step",
    "sharded_fit_mu",
    "sharded_fit_beta",
    "sharded_fit_kl",
    "sharded_fit_cd",
    "sharded_fit_mu_tp",
]

X_SPEC = (DATA_AXIS, TIME_AXIS, None)  # (B, N, L) and (B, N, k)
H_SPEC = (DATA_AXIS, None, None)  # (B, k, L), replicated over time
B_SPEC = (DATA_AXIS,)  # per-fit scalars


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _penalised(den, f, l1: float, l2: float):
    if l1 > 0:
        den = den + l1
    if l2 > 0:
        den = den + l2 * f
    return _guard(den)


def _local_mu_step(
    x, w, h, axis_name: str,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
    inner_iter: int = 1,
):
    """One MU iteration on local shards, the Grams summed over ``axis_name``.

    Shapes (local): x ``(b, n_loc, L)``, w ``(b, n_loc, k)``, h
    ``(b, k, L)`` (replicated over the time group).  The penalties are
    the caller's values, pre-scaled from the global shape, and enter
    the denominators as in :func:`~..models.mu.mu_update`;
    ``inner_iter > 1`` reuses the cross products (no extra collective).
    """
    w, _ = mu_update(x, w, h, l1_reg_w, l2_reg_w, inner_iter=inner_iter,
                     update_h=False)
    wt = _t(w)
    wtx = time_sum(wt @ x, axis_name)
    wtw = time_sum(wt @ w, axis_name)
    for _ in range(inner_iter):
        h = h * (wtx / _penalised(wtw @ h, h, l1_reg_h, l2_reg_h))
    return w, h


def _local_error(x, w, h, axis_name: str):
    """Per-fit Frobenius error, the sum of squares summed over the axis."""
    diff = x - w @ h
    return time_sum((diff * diff).sum(dim=(-1, -2)), axis_name).sqrt()


def _run(mesh, fn):
    with _spmd.bound(mesh):
        return fn()


def _wrap_state(cls, out, mesh, specs):
    return cls(*(_spmd.wrap(f, mesh, s) for f, s in zip(out, specs)))


def _fit_on_mesh(x, w0, h0, mesh, specs, step, error, max_iter, tol,
                 check_every, state_cls, out_specs):
    """:func:`~..models.mu.fit_chunked` on this process's shards."""
    xb, wb, hb = (_spmd.local(a, mesh, s, name=n)
                  for a, s, n in zip((x, w0, h0), specs, ("x", "w0", "h0")))
    wb, hb = wb.to(xb.dtype), hb.to(xb.dtype)
    out = _run(mesh, lambda: fit_chunked(xb, wb, hb, step, error, max_iter, tol,
                                         check_every))
    return _wrap_state(state_cls, out, mesh, out_specs)


def sharded_mu_step(x, w, h, mesh):
    """One sharded MU iteration over a ``(data, time)`` mesh.

    Args:
        x: ``(B, N, L)`` batch, sharded ``(data, time, None)``.
        w: ``(B, N, k)`` factors, sharded like ``x``.
        h: ``(B, k, L)`` factors, sharded ``(data, None, None)``.

    Returns:
        ``(w, h, error)`` as DTensors, ``error`` the per-fit Frobenius
        error after the update.
    """
    xb, wb, hb = (_spmd.local(a, mesh, s)
                  for a, s in zip((x, w, h), (X_SPEC, X_SPEC, H_SPEC)))

    def body():
        w_, h_ = _local_mu_step(xb, wb.to(xb.dtype), hb.to(xb.dtype), TIME_AXIS)
        return w_, h_, _local_error(xb, w_, h_, TIME_AXIS)

    out = _run(mesh, body)
    return tuple(_spmd.wrap(f, mesh, s) for f, s in zip(out, (X_SPEC, H_SPEC, B_SPEC)))


_MU_OUT = (X_SPEC, H_SPEC, B_SPEC, B_SPEC, B_SPEC)


def sharded_fit_mu(
    x, w0, h0, mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
) -> MUState:
    """MU-NMF to convergence on a ``(data, time)`` mesh.

    The semantics of :func:`~..models.mu.fit_mu` (sklearn's stopping
    rule every ``check_every`` iterations, converged fits frozen, no
    criterion at all when ``tol == 0``; the L1/L2 denominator penalties,
    pre-scaled from the GLOBAL shape; the accelerated-MU
    ``inner_iter``), with every time reduction an ``all_reduce``.

    Args:
        x, w0: ``(B, N, L)`` / ``(B, N, k)``, sharded ``(data, time, None)``.
        h0: ``(B, k, L)``, sharded ``(data, None, None)``.
        Plain tensors (the same on every process) or DTensors.

    Returns:
        :class:`~..models.mu.MUState` of DTensors with those placements
        (``n_iter``, ``previous_error``, ``converged`` over ``data``).
    """
    step = functools.partial(_local_mu_step, axis_name=TIME_AXIS,
                             l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
                             l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
                             inner_iter=inner_iter)
    error = functools.partial(_local_error, axis_name=TIME_AXIS)
    return _fit_on_mesh(x, w0, h0, mesh, (X_SPEC, X_SPEC, H_SPEC), step, error,
                        max_iter, tol, check_every, MUState, _MU_OUT)


def _local_beta_step(
    x, w, h, axis_name: str, beta: float = 1.0,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
):
    """One beta-MU iteration on local time shards (any float beta).

    The W update is local; the H update's two projections (its
    numerator, and W's column sums for KL or ``Wt (WH)^(b-1)``
    otherwise) are summed over the time group.  The clamps, damping,
    guards and stability flushes of :func:`~..models.beta.mu_update_beta`.
    """
    from ..models.beta import F64_EPS, _gamma, _wh_pow_times_x

    gamma = _gamma(beta)

    def damp(delta):
        return delta if gamma == 1.0 else delta**gamma

    ht = _t(h)
    wh = w @ h
    numerator = _wh_pow_times_x(x, wh, beta) @ ht
    if beta == 1.0:
        denominator = h.sum(dim=-1)[:, None, :].expand(w.shape)
    else:
        whd = wh.clamp(min=EPSILON) if beta - 1.0 < 0 else wh
        denominator = whd ** (beta - 1.0) @ ht
    w = w * damp(numerator / _penalised(denominator, w, l1_reg_w, l2_reg_w))
    if beta < 1.0:
        w = torch.where(w < F64_EPS, 0.0, w)

    wh = w @ h
    wt = _t(w)
    numerator = time_sum(wt @ _wh_pow_times_x(x, wh, beta), axis_name)
    if beta == 1.0:
        w_sum = time_sum(w.sum(dim=-2), axis_name)
        w_sum = torch.where(w_sum == 0, 1.0, w_sum)
        denominator = w_sum[:, :, None].expand(h.shape)
    else:
        whd = wh.clamp(min=EPSILON) if beta - 1.0 < 0 else wh
        denominator = time_sum(wt @ whd ** (beta - 1.0), axis_name)
    h = h * damp(numerator / _penalised(denominator, h, l1_reg_h, l2_reg_h))
    if beta <= 1.0:
        h = torch.where(h < F64_EPS, 0.0, h)
    return w, h


def _local_beta_error(x, w, h, axis_name: str, beta: float = 1.0):
    """Per-fit ``sqrt(2 * divergence)``: every term of
    :func:`~..models.beta.beta_divergence` is a sum over entries (the
    Itakura-Saito constant counts every entry of the shard), so this
    shard's divergence summed over the time group is the divergence of
    the gathered data."""
    from ..models.beta import beta_divergence

    res = time_sum(beta_divergence(x, w, h, beta, square_root=False), axis_name)
    return (2.0 * res.clamp(min=0.0)).sqrt()


def sharded_fit_beta(
    x, w0, h0, mesh,
    beta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
):
    """Beta-divergence MU-NMF to convergence on a ``(data, time)`` mesh.

    The sequence-parallel :func:`~..models.beta.fit_mu_beta` for any
    float ``beta`` (1 = KL, 0 = Itakura-Saito): exact, the H update's
    two projections its only collectives; sklearn's stopping per fit,
    converged fits frozen; the pre-scaled L1/L2 penalties local.
    Shardings as :func:`sharded_fit_mu`.
    """
    from ..models.beta import BetaState

    beta = float(beta)
    step = functools.partial(_local_beta_step, axis_name=TIME_AXIS, beta=beta,
                             l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
                             l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)
    error = functools.partial(_local_beta_error, axis_name=TIME_AXIS, beta=beta)
    return _fit_on_mesh(x, w0, h0, mesh, (X_SPEC, X_SPEC, H_SPEC), step, error,
                        max_iter, tol, check_every, BetaState, _MU_OUT)


def sharded_fit_kl(
    x, w0, h0, mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
):
    """KL specialization of :func:`sharded_fit_beta` (``beta=1``)."""
    return sharded_fit_beta(
        x, w0, h0, mesh, beta=1.0, max_iter=max_iter, tol=tol,
        check_every=check_every, l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
        l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
    )


def _local_mu_step_tp(
    x, w, h, axis_name: str,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
    inner_iter: int = 1,
):
    """One MU iteration with the *channel* axis sharded (tensor parallel).

    Shapes (local): x ``(b, n, l_loc)``, w ``(b, n, k)`` replicated over
    the model group, h ``(b, k, l_loc)``.  The W update contracts over
    channels, so ``X Ht`` and ``H Ht`` are summed over the model axis;
    the H update is then local to each channel shard.
    """
    ht = _t(h)
    xht = axis_sum(x @ ht, axis_name)
    hht = axis_sum(h @ ht, axis_name)
    for _ in range(inner_iter):
        w = w * (xht / _penalised(w @ hht, w, l1_reg_w, l2_reg_w))
    wt = _t(w)
    wtx, wtw = wt @ x, wt @ w
    for _ in range(inner_iter):
        h = h * (wtx / _penalised(wtw @ h, h, l1_reg_h, l2_reg_h))
    return w, h


def sharded_fit_mu_tp(
    x, w0, h0, mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
) -> MUState:
    """MU-NMF on a ``(data, model)`` mesh: trials x channel shards.

    The tensor-parallel counterpart of :func:`sharded_fit_mu`: ``H`` and
    ``X``'s channel axis shard over ``"model"``, ``W`` is replicated
    within a model group, and the W update's Grams cross shards as two
    small ``all_reduce``s an iteration.

    Args:
        x: ``(B, N, L)`` batch, sharded ``(data, None, model)``.
        w0: ``(B, N, k)``, sharded ``(data, None, None)``.
        h0: ``(B, k, L)``, sharded ``(data, None, model)``.
    """
    xs, ws = (DATA_AXIS, None, MODEL_AXIS), (DATA_AXIS, None, None)
    step = functools.partial(_local_mu_step_tp, axis_name=MODEL_AXIS,
                             l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
                             l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
                             inner_iter=inner_iter)
    error = functools.partial(_local_error, axis_name=MODEL_AXIS)
    return _fit_on_mesh(x, w0, h0, mesh, (xs, ws, xs), step, error, max_iter, tol,
                        check_every, MUState, (ws, xs, B_SPEC, B_SPEC, B_SPEC))


def _local_cd_pass_w(x, w, h, axis_name: str, l1_reg: float = 0.0,
                     l2_reg: float = 0.0):
    """One cyclic CD pass over W's components (H fixed), time-sharded:
    ``H Ht`` and the rows of ``X Ht`` are local, only the violation is
    summed over the time group.  Shapes: x ``(b, n_loc, L)``, w
    ``(b, n_loc, k)``, h ``(b, k, L)``."""
    k = w.shape[-1]
    ht = _t(h)
    hht, xht = h @ ht, x @ ht
    if l2_reg != 0.0:
        hht = hht + l2_reg * torch.eye(k, dtype=hht.dtype, device=hht.device)
    if l1_reg != 0.0:
        xht = xht - l1_reg
    w, violation = _sweep(w, hht, xht)
    return w, time_sum(violation, axis_name)


def _local_cd_pass_h(x, w, h, axis_name: str, l1_reg: float = 0.0,
                     l2_reg: float = 0.0):
    """One cyclic CD pass over H's components (W fixed), time-sharded:
    the W pass on ``X.T``, its Gram ``Wt W`` and cross products
    ``Wt X`` summed over the time group first, the penalties applied
    after the sums.  Every process of a time group then computes the
    same update and the same violation."""
    k = w.shape[-1]
    wt = _t(w)
    wtw = time_sum(wt @ w, axis_name)
    wtx = time_sum(wt @ x, axis_name)
    if l2_reg != 0.0:
        wtw = wtw + l2_reg * torch.eye(k, dtype=wtw.dtype, device=wtw.device)
    if l1_reg != 0.0:
        wtx = wtx - l1_reg
    ht, violation = _sweep(_t(h), wtw, _t(wtx))
    return _t(ht), violation


def sharded_fit_cd(
    x, w0, h0, mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
) -> CDState:
    """Coordinate-descent NMF to convergence on a ``(data, time)`` mesh.

    The semantics of :func:`~..models.hals.fit_cd` (sklearn's 'cd'
    solver, ``shuffle=False``): an outer iteration is one cyclic pass
    over W then H, and a fit stops when its summed |projected gradient|
    falls to ``tol`` of the first iteration's; L2 on the Gram
    diagonal, L1 on the cross products, pre-scaled from the global
    shape.  Each update applies after its sums.

    Args:
        x, w0: sharded ``(data, time, None)``; h0: ``(data, None, None)``.

    Returns:
        :class:`~..models.hals.CDState` ``(w, ht, n_iter,
        violation_init, converged)`` of DTensors (``ht`` is ``(B, L, k)``).
    """
    xb, wb, hb = (_spmd.local(a, mesh, s, name=n) for a, s, n in
                  zip((x, w0, h0), (X_SPEC, X_SPEC, H_SPEC), ("x", "w0", "h0")))

    def loop():
        b = xb.shape[0]
        w, ht = wb.to(xb.dtype).clone(), _t(hb.to(xb.dtype)).clone()
        n_iter = torch.zeros(b, dtype=torch.int32, device=xb.device)
        viol_init = torch.zeros(b, dtype=xb.dtype, device=xb.device)
        converged = torch.zeros(b, dtype=torch.bool, device=xb.device)
        for it in range(1, max_iter + 1):
            active = (~converged).nonzero().flatten()
            if active.numel() == 0:
                break
            xa, ha = xb[active], _t(ht[active])
            wa, viol = _local_cd_pass_w(xa, w[active], ha, TIME_AXIS, l1_reg_w, l2_reg_w)
            ha, viol_h = _local_cd_pass_h(xa, wa, ha, TIME_AXIS, l1_reg_h, l2_reg_h)
            viol = viol + viol_h
            w[active], ht[active] = wa, _t(ha)
            n_iter[active] = it
            if it == 1:
                viol_init = viol.clone()
            vi = viol_init[active]
            converged[active] = (vi == 0) | (viol / vi <= tol)
        return w, ht, n_iter, viol_init, converged

    out = _run(mesh, loop)
    return _wrap_state(CDState, out, mesh, (X_SPEC, H_SPEC, B_SPEC, B_SPEC, B_SPEC))
