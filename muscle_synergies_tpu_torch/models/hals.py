"""HALS / coordinate-descent NMF (sklearn's 'cd' solver) in plain PyTorch.

Port of :mod:`muscle_synergies_tpu.models.hals`, replicating
``sklearn.decomposition._nmf._fit_coordinate_descent`` with
``shuffle=False``:

- per outer iteration, W gets one cyclic coordinate pass with H fixed,
  then H symmetrically (through ``X^T``);
- L2 regularization adds to the Gram diagonal, L1 subtracts from
  ``X H^T``;
- stopping: the summed |projected gradient| (violation) relative to the
  first iteration's, ``violation / violation_init <= tol``.

Every function takes one problem or a batch with a leading axis; a
batched :func:`fit_cd` stops each fit on its own (converged fits are
frozen).  These are the plain reference of the CUDA kernel
(:mod:`muscle_synergies_tpu_torch.models.kernels.cd_cuda`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["cd_pass", "fit_cd", "CDState"]


def cd_pass(
    x: torch.Tensor,
    w: torch.Tensor,
    ht: torch.Tensor,
    l1_reg: float = 0.0,
    l2_reg: float = 0.0,
):
    """One cyclic coordinate-descent pass updating ``w`` (``ht`` fixed).

    sklearn's ``_update_coordinate_descent``: for each component ``s``
    in order, the gradient w.r.t. ``W[:, s]`` is ``W @ HHt[:, s] -
    XHt[:, s]`` and the Newton step divides by ``HHt[s, s]``, clipped at
    zero; a component with ``HHt[s, s] == 0`` is left unchanged.

    Returns:
        ``(w_new, violation)``: violation is the summed absolute
        projected gradient per problem, taken from each column before
        its update (sklearn's stopping statistic).
    """
    k = ht.shape[-1]
    hht = ht.transpose(-1, -2) @ ht
    xht = x @ ht
    if l2_reg != 0.0:
        hht = hht + l2_reg * torch.eye(k, dtype=hht.dtype, device=hht.device)
    if l1_reg != 0.0:
        xht = xht - l1_reg
    return _sweep(w, hht, xht)


def _sweep(w: torch.Tensor, hht: torch.Tensor, xht: torch.Tensor):
    """:func:`cd_pass` from its (penalised) Gram ``hht`` and cross
    products ``xht``: the cyclic column updates and the violation."""
    w = w.clone()
    violation = torch.zeros(w.shape[:-2], dtype=w.dtype, device=w.device)
    for s in range(w.shape[-1]):
        grad = (w @ hht[..., :, s : s + 1])[..., 0] - xht[..., s]
        col = w[..., s]
        pg = torch.where(col == 0.0, grad.clamp(max=0.0), grad)
        violation = violation + pg.abs().sum(dim=-1)
        hess = hht[..., s, s][..., None]
        safe = torch.where(hess == 0, torch.ones_like(hess), hess)
        new_col = (col - grad / safe).clamp(min=0.0)
        w[..., s] = torch.where(hess != 0, new_col, col)
    return w, violation


class CDState(NamedTuple):
    w: torch.Tensor
    ht: torch.Tensor
    n_iter: torch.Tensor
    violation_init: torch.Tensor
    converged: torch.Tensor


def fit_cd(
    x: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    max_iter: int = 200,
    tol: float = 1e-4,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    update_h: bool = True,
) -> CDState:
    """Run coordinate-descent NMF to convergence, per problem.

    ``x`` is ``(N, L)`` or ``(B, N, L)``.  Returns a :class:`CDState`;
    read the factors as ``state.w`` and ``state.ht`` transposed.
    ``update_h=False`` keeps H fixed at ``h0`` and stops on W's
    violation alone (the caller is ``NMFModel.transform``).
    """
    single = x.ndim == 2
    if single:
        x, w0, h0 = x[None], w0[None], h0[None]
    b = x.shape[0]
    xt = x.transpose(-1, -2)
    w, ht = w0.clone(), h0.transpose(-1, -2).clone()
    n_iter = torch.zeros(b, dtype=torch.int32, device=x.device)
    viol_init = torch.zeros(b, dtype=x.dtype, device=x.device)
    converged = torch.zeros(b, dtype=torch.bool, device=x.device)
    for it in range(1, max_iter + 1):
        active = (~converged).nonzero().flatten()
        if active.numel() == 0:
            break
        wa, viol = cd_pass(x[active], w[active], ht[active], l1_reg_w, l2_reg_w)
        if update_h:
            hta, viol_h = cd_pass(xt[active], ht[active], wa, l1_reg_h, l2_reg_h)
            viol = viol + viol_h
            ht[active] = hta
        w[active] = wa
        n_iter[active] = it
        if it == 1:
            viol_init = viol.clone()
        vi = viol_init[active]
        converged[active] = (vi == 0) | (viol / vi <= tol)
    state = CDState(w, ht, n_iter, viol_init, converged)
    if single:
        return CDState(*(t[0] for t in state))
    return state
