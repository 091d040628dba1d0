"""Plain mirrors of the cluster entries' split, for the CPU tests.

The cluster entries of K1 (MU), K2 (CD), K4 (beta-MU) and K5 (cNMF)
spread a fit over many blocks of the card (one design, the grid entries
of ``csrc/nmf_common.cuh``) and cut its rows into one range a block
(``mu_cuda.grid_plan``, ``beta_cuda.grid_plan``, ``cnmf_cuda.grid_plan``
pick the ranges).  Each block updates its rows of W, adds their share of
the H update's sums (W^T W and W^T X; for K4 the two weight planes W^T
(X WH^(beta-2)) and W^T WH^(beta-1), for KL the column sums of W) and of
the stopping statistic, and every block adds the ranges' shares in range
order before updating H; a block that streams its rows adds its tiles'
shares in tile order into its own before the ranges are summed
(``tile=``).  K5 cuts time the same way: the S sums are added range by
range, and each range updates its rows of C from its own rows and a
halo of D - 1 rows of C on each side, read from the ranges that own
them.  :func:`fit_mu_cluster_plain`, :func:`fit_cd_cluster_plain`,
:func:`fit_beta_cluster_plain` and :func:`fit_cnmf_cluster_plain`
compute a fit the same way in plain PyTorch, so the CPU tests can hold
the decomposition to the JAX package's fits.
"""

import bisect

import torch

from muscle_synergies_tpu_torch.models.beta import (
    F64_EPS,
    BetaState,
    _gamma,
    _wh_pow_times_x,
    mu_update_beta,
)
from muscle_synergies_tpu_torch.models.cnmf import (
    CNMFState,
    _fit_loop,
    _lag_stack,
    cnmf_reconstruct,
)
from muscle_synergies_tpu_torch.models.hals import CDState, _sweep
from muscle_synergies_tpu_torch.models.mu import (
    EPSILON,
    MUState,
    _guard,
    _update_h,
    fit_chunked,
    mu_update,
)


def split_rows(n: int, ranges) -> list:
    """Row bounds ``[0, .., n]`` of a fit's blocks: ``ranges`` blocks of
    ``ceil(n / ranges)`` rows, the last ones shorter (the kernels' split:
    ``csrc/nmf_common.cuh`` ``nmf_grid``), or, given a sequence, those
    bounds themselves (ranges of any lengths)."""
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


def _in_order(parts, dim):
    """Sum ``parts`` along ``dim`` one after another, first to last (the
    kernels' order: a running sum, each part added to it)."""
    return parts.cumsum(dim).select(dim, -1)


def _ranges(v, bounds, dim=-2):
    """``v`` cut along ``dim`` into the ranges of ``bounds``, zero-padded to
    equal lengths and stacked just before ``dim``."""
    dim = dim % v.ndim
    longest = max(b - a for a, b in zip(bounds, bounds[1:]))
    pieces = []
    for a, b in zip(bounds, bounds[1:]):
        piece = v.narrow(dim, a, b - a)
        pad = [0, 0] * (v.ndim - 1 - dim) + [0, longest - (b - a)]
        pieces.append(torch.nn.functional.pad(piece, pad))
    return torch.stack(pieces, dim)


def _range_grams(w, xs, bounds, tile):
    """``W^T W`` and ``W^T X`` summed as the grid entries' blocks sum them:
    each range's tiles of ``tile`` rows (the whole range when ``None``)
    in tile order into the range's share, the shares in range order."""
    k = w.shape[-1]
    y = _ranges(torch.cat([w, xs], dim=-1), bounds)  # (..., P, rows, k + l)
    rows = y.shape[-2]
    tile = rows if tile is None else tile
    n_tiles = -(-rows // tile) if rows else 1
    y = torch.nn.functional.pad(y, (0, 0, 0, n_tiles * tile - rows))
    y = y.unflatten(-2, (n_tiles, tile))  # (..., P, T, tile, k + l)
    part = y[..., :k].transpose(-1, -2) @ y  # (..., P, T, k, k + l)
    total = _in_order(_in_order(part, -3), -3)
    return total[..., :k], total[..., k:]


def _mu_split_update(xs, w, h, bounds, regs, inner_iter, tile=None):
    """One MU iteration with H's Grams summed range by range, in range
    order, as the cluster entry's blocks add theirs."""
    l1_w, l2_w, l1_h, l2_h = regs
    w, _ = mu_update(xs, w, h, l1_w, l2_w, inner_iter=inner_iter, update_h=False)
    wtw, wtx = _range_grams(w, xs, bounds, tile)
    return w, _update_h(h, wtx, wtw, l1_h, l2_h, inner_iter)


def _mu_split_error(xs, w, h, bounds):
    """``||X - W H||_F``: the ranges' sums of squares added in range order
    (a block's threads carry theirs across its tiles)."""
    d = xs - w @ h
    return _in_order(_ranges((d * d).sum(dim=-1), bounds, -1).sum(dim=-1), -1).sqrt()


def fit_mu_cluster_plain(
    xs, w0, h0, ranges, max_iter: int = 200, tol: float = 1e-4,
    check_every: int = 10, inner_iter: int = 1, l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0, l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
    tile=None,
) -> MUState:
    """``mu_cuda.fit_mu_plain`` computed as the cluster entry splits it:
    the rows cut into ``ranges`` (a count, or bounds; :func:`split_rows`),
    each range's W^T W, W^T X and squared error summed in range order,
    a range's Grams over its tiles of ``tile`` rows first where the plan
    streams them.
    ``tol <= 0`` runs ``max_iter`` iterations."""
    bounds = split_rows(xs.shape[-2], ranges)
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    return MUState(*fit_chunked(
        xs, w0, h0,
        lambda xa, wa, ha: _mu_split_update(xa, wa, ha, bounds, regs, inner_iter, tile),
        lambda xa, wa, ha: _mu_split_error(xa, wa, ha, bounds),
        max_iter, tol, check_every,
    ))


def _cd_split_iteration(xs, w, ht, bounds, regs, tile=None):
    """One CD outer iteration as the cluster entry splits it: the W pass
    range by range (row-local), the ranges' W^T W, W^T X and violations
    added in range order (a range's Grams over its tiles first, in tile
    order), then the H pass from those sums."""
    l1_w, l2_w, l1_h, l2_h = regs
    k = ht.shape[-1]
    eye = torch.eye(k, dtype=ht.dtype, device=ht.device)
    hht = ht.transpose(-1, -2) @ ht
    xht = xs @ ht
    if l2_w != 0.0:
        hht = hht + l2_w * eye
    if l1_w != 0.0:
        xht = xht - l1_w
    # the W pass is row-local: every range at once, the padding rows 0
    # (their gradient is 0, so they stay 0 and add no violation)
    wr, vr = _sweep(_ranges(w, bounds), hht.unsqueeze(-3), _ranges(xht, bounds))
    w = torch.cat([wr[..., r, :b - a, :] for r, (a, b) in
                   enumerate(zip(bounds, bounds[1:]))], dim=-2)
    viol = _in_order(vr, -1)
    wtw, wtx = _range_grams(w, xs, bounds, tile)
    if l2_h != 0.0:
        wtw = wtw + l2_h * eye
    cross = wtx.transpose(-1, -2)
    if l1_h != 0.0:
        cross = cross - l1_h
    ht, viol_h = _sweep(ht, wtw, cross)
    return w, ht, viol + viol_h


def fit_cd_cluster_plain(
    xs, w0, h0, ranges, max_iter: int = 200, tol: float = 1e-4,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0, l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0, tile=None,
) -> CDState:
    """``cd_cuda.fit_cd_plain`` computed as the cluster entry splits it:
    the rows cut into ``ranges`` (a count, or bounds; :func:`split_rows`),
    each range's W^T W, W^T X and W-pass violation summed in range order,
    a range's Grams over its tiles of ``tile`` rows first where the plan
    streams them; each fit stops on its own."""
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
                                            bounds, regs, tile)
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


def _beta_split_update(xs, w, h, beta, bounds, regs):
    """One beta-MU iteration, W then H, as K4's cluster entry splits it:
    the W update row-local, then each range's W^T (X WH^(beta-2)) and
    W^T WH^(beta-1) (KL: its column sums of W), WH from the new W and
    the old H, added in range order before H is updated."""
    l1_w, l2_w, l1_h, l2_h = regs
    w, _ = mu_update_beta(xs, w, h, beta, l1_w, l2_w, update_h=False)
    num = den = 0
    for a, b in zip(bounds, bounds[1:]):
        wr = w[..., a:b, :]
        wh = wr @ h
        num = num + wr.transpose(-1, -2) @ _wh_pow_times_x(xs[..., a:b, :], wh, beta)
        if beta == 1.0:
            den = den + wr.sum(dim=-2)
        else:
            whd = wh.clamp(min=EPSILON) if beta < 1.0 else wh
            den = den + wr.transpose(-1, -2) @ whd ** (beta - 1.0)
    if beta == 1.0:
        den = torch.where(den == 0, 1.0, den).unsqueeze(-1).expand_as(h)
    if l1_h > 0:
        den = den + l1_h
    if l2_h > 0:
        den = den + l2_h * h
    delta = num / _guard(den)
    gamma = _gamma(beta)
    if gamma != 1.0:
        delta = delta**gamma
    h = h * delta
    if beta <= 1.0:
        h = torch.where(h < F64_EPS, 0.0, h)
    return w, h


def _beta_split_divergence(xs, w, h, beta, bounds):
    """sklearn's square-rooted beta divergence, each range's entries
    summed (KL: X log(X / WH) - X + WH; IS: X / WH - log(X / WH) - 1;
    entries with X <= EPSILON keep only the WH terms) and the ranges'
    sums added in range order, as K4's cluster entry sums it."""
    total = 0
    for a, b in zip(bounds, bounds[1:]):
        x = xs[..., a:b, :]
        wh = w[..., a:b, :] @ h
        inside = x > EPSILON
        whc = wh.clamp(min=EPSILON)
        if beta == 1.0:
            terms = wh + torch.where(inside, x * (x / whc).log() - x, 0.0)
        elif beta == 0.0:
            terms = torch.where(inside, x / whc - (x / whc).log(), 0.0) - 1.0
        else:
            terms = (beta - 1.0) * wh**beta + torch.where(
                inside, x**beta - beta * x * whc ** (beta - 1.0), 0.0)
        total = total + terms.sum(dim=(-2, -1))
    if beta not in (0.0, 1.0):
        total = total / (beta * (beta - 1.0))
    return (2.0 * total.clamp(min=0.0)).sqrt()


def fit_beta_cluster_plain(
    xs, w0, h0, ranges, beta: float = 1.0, max_iter: int = 200,
    tol: float = 1e-4, check_every: int = 10, l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0, l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> BetaState:
    """``beta_cuda.fit_beta_plain`` computed as the cluster entry splits
    it: the rows cut into ``ranges`` (a count, or bounds;
    :func:`split_rows`), each range's weight planes and divergence summed
    in range order.  ``tol <= 0`` runs ``max_iter`` iterations."""
    bounds = split_rows(xs.shape[-2], ranges)
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    return BetaState(*fit_chunked(
        xs, w0, h0,
        lambda xa, wa, ha: _beta_split_update(xa, wa, ha, beta, bounds, regs),
        lambda xa, wa, ha: _beta_split_divergence(xa, wa, ha, beta, bounds),
        max_iter, tol, check_every,
    ))


def halo_rows(bounds, r: int, n_lags: int, n_rows: int) -> list:
    """Range ``r``'s halo as K5's cluster entry reads it: ``(row, owner,
    edge, index)`` for rows ``t0 - D + 1 .. t0 - 1`` and ``t1 .. t1 + D -
    2`` inside the fit, each from the range that owns it (possibly more
    than one range away, when ranges are shorter than D - 1), where it is
    among that range's first D - 1 rows (``edge`` "first") or its last
    (``edge`` "last") at ``index`` of that edge."""
    h1 = n_lags - 1
    t0, t1 = bounds[r], bounds[r + 1]
    out = []
    if t1 == t0:
        return out
    rows = [g for g in range(t0 - h1, t0) if g >= 0]
    rows += [g for g in range(t1, t1 + h1) if g < n_rows]
    for g in rows:
        q = bisect.bisect_right(bounds, g) - 1
        a, b = bounds[q], bounds[q + 1]
        e = min(h1, b - a)
        if g >= t1:
            assert g - a < e, (g, q)  # among the owner's first rows
            out.append((g, q, "first", g - a))
        else:
            assert g >= b - e, (g, q)  # among the owner's last rows
            out.append((g, q, "last", g - (b - e)))
    return out


def _cnmf_split_update(xs, c, s, bounds):
    """One convolutive update, S then C, as K5's cluster entry splits
    time: the ranges' S sums added in range order, then each range's C
    from its own rows of C and its halo rows (:func:`halo_rows`), X and
    Xh rows t..t+D-1 with Xh rebuilt from those rows and the new S."""
    n_lags, n_rows = s.shape[-2], xs.shape[-2]
    h1 = n_lags - 1
    cs = _lag_stack(c, n_lags)
    xhat = torch.einsum("...dtk,...kdl->...tl", cs, s)
    num = den = 0
    for a, b in zip(bounds, bounds[1:]):
        csr = cs[..., a:b, :]
        num = num + torch.einsum("...dtk,...tl->...kdl", csr, xs[..., a:b, :])
        den = den + torch.einsum("...dtk,...tl->...kdl", csr, xhat[..., a:b, :])
    s = s * (num / _guard(den))
    out = []
    for r, (a, b) in enumerate(zip(bounds, bounds[1:])):
        if a == b:
            continue
        halo = [g for g, *_ in halo_rows(bounds, r, n_lags, n_rows)]
        below, above = [g for g in halo if g < a], [g for g in halo if g >= b]
        hi = b + h1  # the range reads rows a - D + 1 .. b + D - 2, 0 outside the fit

        def zeros(m):
            return c.new_zeros(c.shape[:-2] + (m, c.shape[-1]))

        ext = torch.cat([zeros(h1 - len(below)), c[..., below, :], c[..., a:b, :],
                         c[..., above, :], zeros(h1 - len(above))], dim=-2)
        # X and Xh rows a .. b + D - 2, 0 past the fit's end
        xh = cnmf_reconstruct(ext, s)[..., h1:, :]
        xh[..., max(0, n_rows - a):, :] = 0.0
        xe = torch.nn.functional.pad(xs[..., a:min(hi, n_rows), :],
                                     (0, 0, 0, max(0, hi - n_rows)))
        g_num = torch.einsum("...tl,...kdl->...dtk", xe, s)
        g_den = torch.einsum("...tl,...kdl->...dtk", xh, s)
        n = b - a
        num_c = sum(g_num[..., d, d:d + n, :] for d in range(n_lags))
        den_c = sum(g_den[..., d, d:d + n, :] for d in range(n_lags))
        out.append(c[..., a:b, :] * (num_c / _guard(den_c)))
    return torch.cat(out, dim=-2), s


def _cnmf_split_error(xs, c, s, bounds):
    """``||X - Xh||_F``: the ranges' sums of squares added in range order."""
    diff = xs - cnmf_reconstruct(c, s)
    total = 0
    for a, b in zip(bounds, bounds[1:]):
        d = diff[..., a:b, :]
        total = total + (d * d).sum(dim=(-2, -1))
    return total.sqrt()


def fit_cnmf_cluster_plain(xs, c0, s0, ranges, max_iter: int = 200,
                           tol: float = 1e-4, check_every: int = 10) -> CNMFState:
    """``cnmf_cuda.fit_cnmf_plain`` computed as the cluster entry splits
    time: the rows cut into ``ranges`` (a count, or bounds;
    :func:`split_rows`), the S sums and squared errors added in range
    order, C updated range by range from its halo.  No tail chunk, as
    the plain loop."""
    bounds = split_rows(xs.shape[-2], ranges)
    return _fit_loop(
        xs, c0, s0,
        lambda xa, ca, sa: _cnmf_split_update(xa, ca, sa, bounds),
        lambda xa, ca, sa: _cnmf_split_error(xa, ca, sa, bounds),
        max_iter, tol, check_every)
