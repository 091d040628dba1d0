"""Plain mirrors of the cluster entries' split, for the CPU tests.

The cluster entries of K1 (MU) and K2 (CD) cut a fit's rows into one
range a block; each block updates its rows of W, adds their share of
W^T W and W^T X (and, for CD, its W-pass violation, for MU its squared
error), and every block sums the ranges' shares in range order before
updating H.  :func:`fit_mu_cluster_plain` and :func:`fit_cd_cluster_plain`
compute a fit the same way in plain PyTorch, so ``test_torch_cluster.py``
can hold the decomposition to the JAX package's fits.
"""

import torch

from muscle_synergies_tpu_torch.models.hals import CDState, _sweep
from muscle_synergies_tpu_torch.models.mu import MUState, _update_h, fit_chunked, mu_update


def split_rows(n: int, ranges) -> list:
    """Row bounds ``[0, .., n]`` of a cluster's blocks: ``ranges`` blocks
    of ``ceil(n / ranges)`` rows, the last ones shorter (the kernels'
    split: ``csrc/nmf_common.cuh`` ``nmf_cluster``), or, given a sequence,
    those bounds themselves (ranges of any lengths)."""
    if isinstance(ranges, int):
        if ranges < 1:
            raise ValueError(f"ranges must be >= 1, got {ranges}")
        per = -(-n // ranges)
        return [min(n, r * per) for r in range(ranges + 1)]
    bounds = [int(b) for b in ranges]
    if bounds[0] != 0 or bounds[-1] != n or any(
            a > b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"row bounds {bounds} do not run from 0 up to {n}")
    return bounds


def _mu_split_update(xs, w, h, bounds, regs, inner_iter):
    """One MU iteration with H's Grams summed range by range, in range
    order, as the cluster entry's blocks add theirs."""
    l1_w, l2_w, l1_h, l2_h = regs
    w, _ = mu_update(xs, w, h, l1_w, l2_w, inner_iter=inner_iter, update_h=False)
    wtw = wtx = 0
    for a, b in zip(bounds, bounds[1:]):
        wr = w[..., a:b, :].transpose(-1, -2)
        wtw = wtw + wr @ w[..., a:b, :]
        wtx = wtx + wr @ xs[..., a:b, :]
    return w, _update_h(h, wtx, wtw, l1_h, l2_h, inner_iter)


def _mu_split_error(xs, w, h, bounds):
    """``||X - W H||_F``: the ranges' sums of squares added in range order."""
    total = 0
    for a, b in zip(bounds, bounds[1:]):
        d = xs[..., a:b, :] - w[..., a:b, :] @ h
        total = total + (d * d).sum(dim=(-2, -1))
    return total.sqrt()


def fit_mu_cluster_plain(
    xs, w0, h0, ranges, max_iter: int = 200, tol: float = 1e-4,
    check_every: int = 10, inner_iter: int = 1, l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0, l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> MUState:
    """``mu_cuda.fit_mu_plain`` computed as the cluster entry splits it:
    the rows cut into ``ranges`` (a count, or bounds; :func:`split_rows`),
    each range's W^T W, W^T X and squared error summed in range order.
    ``tol <= 0`` runs ``max_iter`` iterations."""
    bounds = split_rows(xs.shape[-2], ranges)
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    return MUState(*fit_chunked(
        xs, w0, h0,
        lambda xa, wa, ha: _mu_split_update(xa, wa, ha, bounds, regs, inner_iter),
        lambda xa, wa, ha: _mu_split_error(xa, wa, ha, bounds),
        max_iter, tol, check_every,
    ))


def _cd_split_iteration(xs, w, ht, bounds, regs):
    """One CD outer iteration as the cluster entry splits it: the W pass
    range by range (row-local), the ranges' W^T W, W^T X and violations
    added in range order, then the H pass from those sums."""
    l1_w, l2_w, l1_h, l2_h = regs
    k = ht.shape[-1]
    eye = torch.eye(k, dtype=ht.dtype, device=ht.device)
    hht = ht.transpose(-1, -2) @ ht
    xht = xs @ ht
    if l2_w != 0.0:
        hht = hht + l2_w * eye
    if l1_w != 0.0:
        xht = xht - l1_w
    rows, viol, wtw, wtx = [], 0, 0, 0
    for a, b in zip(bounds, bounds[1:]):
        wr, vr = _sweep(w[..., a:b, :], hht, xht[..., a:b, :])
        rows.append(wr)
        viol = viol + vr
        wtw = wtw + wr.transpose(-1, -2) @ wr
        wtx = wtx + wr.transpose(-1, -2) @ xs[..., a:b, :]
    if l2_h != 0.0:
        wtw = wtw + l2_h * eye
    cross = wtx.transpose(-1, -2)
    if l1_h != 0.0:
        cross = cross - l1_h
    ht, viol_h = _sweep(ht, wtw, cross)
    return torch.cat(rows, dim=-2), ht, viol + viol_h


def fit_cd_cluster_plain(
    xs, w0, h0, ranges, max_iter: int = 200, tol: float = 1e-4,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0, l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
) -> CDState:
    """``cd_cuda.fit_cd_plain`` computed as the cluster entry splits it:
    the rows cut into ``ranges`` (a count, or bounds; :func:`split_rows`),
    each range's W^T W, W^T X and W-pass violation summed in range order;
    each fit stops on its own."""
    single = xs.ndim == 2
    if single:
        xs, w0, h0 = xs[None], w0[None], h0[None]
    bounds = split_rows(xs.shape[-2], ranges)
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    b = xs.shape[0]
    w, ht = w0.clone(), h0.transpose(-1, -2).clone()
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    viol_init = torch.zeros(b, dtype=xs.dtype, device=xs.device)
    converged = torch.zeros(b, dtype=torch.bool, device=xs.device)
    for it in range(1, max_iter + 1):
        active = (~converged).nonzero().flatten()
        if active.numel() == 0:
            break
        wa, hta, viol = _cd_split_iteration(xs[active], w[active], ht[active],
                                            bounds, regs)
        w[active], ht[active] = wa, hta
        n_iter[active] = it
        if it == 1:
            viol_init = viol.clone()
        vi = viol_init[active]
        converged[active] = (vi == 0) | (viol / vi <= tol)
    state = CDState(w, ht, n_iter, viol_init, converged)
    if single:
        return CDState(*(t[0] for t in state))
    return state
