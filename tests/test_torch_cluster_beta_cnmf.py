"""PyTorch port: the cluster entries of K4 (beta-MU) and K5 (cNMF) on the CPU.

A beta-divergence or convolutive fit whose frame exceeds one block's
shared memory is spread over many blocks of the card (K1's grid
design): each block owns a range of rows.  K4's blocks update their
rows of W, add their share of the two weight planes W^T (X
WH^(beta-2)) and W^T WH^(beta-1) (KL: the column sums of W) and of the
divergence, and every block adds the blocks' shares in block order
before updating H.  K5's blocks add their share of the S sums, add them
in block order, update S, then update their rows of C from a halo of D
- 1 rows of C on each side, read from the blocks that own them.  The
kernels run only on the card; here

- :func:`route` of K4 and K5 is held to a table of frames (the warp,
  block and cluster entries, and the refusal past the cluster entry's
  least block);
- the plan mirrors ``beta_cuda.grid_plan`` and ``cnmf_cuda.grid_plan``
  (blocks a fit, rows a block, resident or streamed) are held to their
  rule, case by case, and their workspaces to their layout;
- the plain mirrors of those splits (``torch_cluster_split.py``),
  ``fit_beta_cluster_plain`` and ``fit_cnmf_cluster_plain``, are held
  in float64 to the JAX package's XLA solvers (``fit_mu_beta``,
  ``fit_cnmf``) on a 6,000 x 8 matrix (one range, three, sixteen, the
  split the plan gives on a card of 8 SMs, and ranges of unequal
  length, one of them shorter than D - 1, so that a halo is read from
  two ranges), and K5 also on a 257 x 8 matrix at 131 lags split as the
  plan gives on 3 SMs (two blocks, each shorter than D - 1, so each
  block's halo is all of the other): fixed iterations to 1e-10 relative, fits with
  the stop on to the same iteration count and factors to 1e-8, for KL,
  Itakura-Saito, beta = 1.5 and beta = -0.5, with and without sklearn's
  L1/L2 penalties;
- ``NMFModel`` with a beta loss (CPU, float64) is held to the JAX
  package's on the same 6,000 x 8 frame, which the card fits on K4's
  cluster entry.
Run serially: ``python -m pytest tests/test_torch_cluster_beta_cnmf.py -q``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_cluster_split import (  # noqa: E402
    fit_beta_cluster_plain,
    fit_cnmf_cluster_plain,
    halo_rows,
    split_rows,
)

import jax.numpy as jnp  # noqa: E402

from muscle_synergies_tpu.models import beta as jbeta  # noqa: E402
from muscle_synergies_tpu.models import cnmf as jcnmf  # noqa: E402
from muscle_synergies_tpu.models import select as jselect  # noqa: E402
from muscle_synergies_tpu_torch.models import select  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import beta_cuda, cnmf_cuda, mu_cuda  # noqa: E402

N, L = 6000, 8
K_CNMF, D_CNMF = 4, 10
REGS = dict(l1_reg_w=0.02, l2_reg_w=0.05, l1_reg_h=0.01, l2_reg_h=0.03)
BETAS = [1.0, 0.0, 1.5, -0.5]
# the unequal layouts hold a range shorter than D - 1 = 9 rows, so the
# range after it reads its lower halo from two ranges
SMS = 132  # an H100 SXM's SMs
CAPTURE = 124_460
# a plan on a card of 8 SMs: 8 blocks of 750 rows, resident, for K4 and K5
GRID8 = beta_cuda.grid_plan(1, N, L, 4, 8).blocks
RANGES = {"C1": 1, "C3": 3, "C16": 16, "grid8": GRID8,
          "unequal": [0, 500, 2600, 2605, 6000]}


def _frame(n=N, l=L, seed=13):
    """A positive 4-synergy envelope with noise, ``(n, l)``."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 25.0, n)[:, None]
    acts = np.abs(np.sin(2 * np.pi * (t * (0.8 + 0.4 * rng.random(4)) + rng.random(4))))
    return acts @ rng.random((4, l)) + 0.05 * rng.random((n, l)) + 0.01


X = _frame()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _n_max_block(l, k, kl):
    """The most rows whose fit fits K4's block entry."""
    n = 1
    while beta_cuda.smem_bytes(2 * n, l, k, kl=kl) <= mu_cuda.SMEM_LIMIT:
        n *= 2
    lo, hi = n, 2 * n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = beta_cuda.smem_bytes(mid, l, k, kl=kl) <= mu_cuda.SMEM_LIMIT
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo


# ---- route -----------------------------------------------------------

BETA_ROUTES = [
    ((200, 8, 4, 1.0), "warp"),
    ((200, 8, 4, 0.0), "warp"),
    ((200, 8, 4, 1.5), "block"),
    ((200, 8, 4, -0.5), "block"),
    ((2000, 8, 4, 1.0), "block"),
    ((_n_max_block(8, 4, True), 8, 4, 1.0), "block"),
    ((_n_max_block(8, 4, True) + 1, 8, 4, 1.0), "cluster"),
    ((_n_max_block(8, 4, False), 8, 4, 0.0), "block"),
    ((_n_max_block(8, 4, False) + 1, 8, 4, 0.0), "cluster"),
    ((2000, 8, 4, 1.5), "cluster"),
    *[((n, 8, k, beta), "cluster") for n in (6000, 20_000, 124_460)
      for k in range(1, 9) for beta in BETAS],
    ((124_460, 8, 16, 1.0), "cluster"),
    ((124_460, 16, 16, 1.5), "cluster"),
    ((20_000, 2000, 16, 1.0), None),
    ((20_000, 2000, 16, 1.5), None),
]


@pytest.mark.parametrize("shape, entry", BETA_ROUTES,
                         ids=[f"{s[0]}x{s[1]}k{s[2]}b{s[3]}" for s, _ in BETA_ROUTES])
def test_beta_route_takes_the_entry_of_the_frame(shape, entry):
    if entry is None:
        with pytest.raises(ValueError, match="impl='torch'"):
            beta_cuda.route(*shape)
    else:
        assert beta_cuda.route(*shape) == entry


# (frame, batch, entry): past the warp entry and within one block, a
# batch takes the grid entry unless it fills the card with 4 waves or
# more of fits that share an SM 4 at a time on the block entry
BETA_BATCH_ROUTES = [
    ((200, 8, 4, 1.5), 16, "cluster"), ((200, 8, 4, 1.5), 1024, "block"),
    ((200, 8, 4, -0.5), 51, "cluster"), ((200, 8, 4, -0.5), 1024, "block"),
    ((200, 8, 6, 0.0), 264, "cluster"), ((200, 8, 6, 0.0), 1024, "block"),
    ((2000, 8, 4, 1.0), 16, "cluster"), ((2000, 8, 4, 1.0), 1024, "cluster"),
    ((_n_max_block(8, 4, True), 8, 4, 1.0), 1024, "cluster"),
    ((200, 8, 4, 1.0), 1024, "warp"), ((200, 8, 4, 0.0), 1, "warp"),
    ((6000, 8, 4, 1.5), 1024, "cluster"),
]


@pytest.mark.parametrize("shape, batch, entry", BETA_BATCH_ROUTES, ids=[
    f"{s[0]}x{s[1]}k{s[2]}b{s[3]}n{b}" for s, b, _ in BETA_BATCH_ROUTES])
def test_beta_route_takes_the_entry_of_the_batch(shape, batch, entry):
    assert beta_cuda.route(*shape, batch=batch, sms=SMS) == entry
    # a frame over one block takes the cluster entry whatever the batch
    assert beta_cuda.route(20_000, *shape[1:], batch=batch, sms=SMS) == "cluster"


def test_the_beta_limits_sit_where_the_shared_memory_puts_them():
    # the block entry: about 2,516 x 8 for KL at rank 4, 1,808 x 8 for the rest
    assert 2500 < _n_max_block(8, 4, True) < 2530
    assert 1800 < _n_max_block(8, 4, False) < 1820
    # the cluster entry: any rows at 8 or 16 channels, ranks 1-16; not when
    # its small state fills a block, and never past rank 16
    for l in (8, 16):
        for k in range(1, 17):
            assert beta_cuda.cluster_smem_bytes(l, k) <= mu_cuda.SMEM_LIMIT
    assert beta_cuda.cluster_smem_bytes(2000, 16, kl=True) > mu_cuda.SMEM_LIMIT
    assert beta_cuda.cluster_smem_bytes(8, 4, kl=True) < beta_cuda.cluster_smem_bytes(8, 4)
    with pytest.raises(ValueError, match="rank"):
        beta_cuda.route(124_460, 8, 17)


CNMF_ROUTES = [
    ((200, 8, 4, 10), "block"),
    ((2822, 8, 4, 10), "block"),
    ((2823, 8, 4, 10), "cluster"),
    ((6000, 8, 4, 10), "cluster"),
    ((20_000, 8, 4, 10), "cluster"),
    ((124_460, 8, 4, 10), "cluster"),
    ((124_460, 8, 8, 10), "cluster"),
    ((124_460, 16, 4, 20), "cluster"),
    ((6000, 8, 4, 1), "cluster"),
    ((5000, 8, 1, 700), "cluster"),
    ((2000, 2000, 16, 1), None),
    ((6000, 8, 4, 400), "cluster"),
    ((6000, 8, 4, 500), None),
    ((6000, 8, 16, 200), None),
]


@pytest.mark.parametrize("shape, entry", CNMF_ROUTES,
                         ids=[f"{s[0]}x{s[1]}k{s[2]}d{s[3]}" for s, _ in CNMF_ROUTES])
def test_cnmf_route_takes_the_entry_of_the_frame(shape, entry):
    if entry is None:
        with pytest.raises(ValueError, match="impl='torch'"):
            cnmf_cuda.route(*shape)
    else:
        assert cnmf_cuda.route(*shape) == entry


def test_the_cnmf_limits_sit_where_the_shared_memory_puts_them():
    assert cnmf_cuda.smem_bytes(2822, 8, 4, 10) <= cnmf_cuda.SMEM_LIMIT
    assert cnmf_cuda.smem_bytes(2823, 8, 4, 10) > cnmf_cuda.SMEM_LIMIT
    # the cluster block's least state grows with K and D, not with T
    assert cnmf_cuda.cluster_smem_bytes(8, 4, 10) < 40 * 1024
    assert cnmf_cuda.cluster_smem_bytes(8, 4, 400) <= cnmf_cuda.SMEM_LIMIT
    assert cnmf_cuda.cluster_smem_bytes(8, 4, 500) > cnmf_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="lags"):
        cnmf_cuda.route(5, 8, 4, 10)


def test_halo_rows_come_from_the_ranges_that_own_them():
    bounds = split_rows(N, RANGES["unequal"])
    # the range after the 5-row one reads 4 rows from range 1 and 5 from range 2
    owners = [(g, q, edge) for g, q, edge, _ in halo_rows(bounds, 3, D_CNMF, N)]
    assert owners == ([(g, 1, "last") for g in range(2596, 2600)]
                      + [(g, 2, "last") for g in range(2600, 2605)])
    # the 5-row range's halo: 9 rows below from range 1, 9 above from range 3
    got = halo_rows(bounds, 2, D_CNMF, N)
    assert [q for _, q, _, _ in got] == [1] * 9 + [3] * 9
    # the first range has no rows below; equal ranges read one neighbour each
    assert [g for g, *_ in halo_rows(split_rows(N, 3), 0, D_CNMF, N)] == list(range(2000, 2009))
    assert {q for _, q, _, _ in halo_rows(split_rows(N, 16), 5, D_CNMF, N)} == {4, 6}


# ---- the plan mirrors -----------------------------------------------

def _old_beta_cluster_bytes(l, k, kl):
    """The least block of the thread-block-cluster design K4's entry
    replaced: H, the Grams' room, two parities of two planes, their sums,
    float64 scratch and two tiles of 128 rows with their weight planes."""
    per_row = 2 * ((l | 1) + (k | 1)) + (1 if kl else 2) * (l | 1)
    return 4 * (8 * k * l + k * k + 103 + 128 * per_row)


def _old_cnmf_cluster_bytes(l, k, d):
    """The least block of the thread-block-cluster design K5's entry
    replaced."""
    lp, h1 = cnmf_cuda._lp(l), d - 1
    items = k * d * (lp // 8)
    slices = min(8, max(1, 256 // items))
    small = (2 * h1 * lp + k * d * lp + 32 * items + 16 * (slices - 1) * items
             + k * (2 * h1 + 3) + 7 * h1 * k + 1 + 2 * 34)
    return 4 * (small + 128 * (2 * lp + k))


@pytest.mark.parametrize("b, n, kl, plan", [
    (1, CAPTURE, True, (132, 943, True)),  # a lone capture on every SM
    (1, CAPTURE, False, (132, 943, True)),
    (4, CAPTURE, True, (33, 3772, True)),  # a sweep's 4 ranks, resident
    (4, CAPTURE, False, (33, 3772, True)),
    (5, CAPTURE, True, (26, 4787, False)),  # 5 at once no longer fit: streamed
    (16, CAPTURE, False, (8, 15_558, False)),
    (1, 20_000, True, (79, 254, True)),  # at least 256 rows a block
    (4, N, True, (24, 250, True)),  # a subject's 30 cycles, ranks 1-4
    (140, N, False, (1, N, False)),  # more fits than SMs: one block a fit, streamed
], ids=lambda v: str(v) if not isinstance(v, tuple) else "-")
def test_beta_grid_plan_spreads_a_fit_over_the_card(b, n, kl, plan):
    got = beta_cuda.grid_plan(b, n, L, 4, SMS, kl)
    assert (got.blocks, got.rows, got.resident) == plan
    small = beta_cuda.grid_small_floats(L, 4, kl)
    assert got.smem == 4 * (small + got.tile * 12) <= mu_cuda.SMEM_LIMIT
    if not got.resident:
        assert mu_cuda.CLUSTER_MIN_TILE <= got.tile < got.rows
        assert got.smem + 4 * 12 > mu_cuda.SMEM_LIMIT


@pytest.mark.parametrize("b, t, k, d, plan", [
    (1, CAPTURE, 4, 10, (132, 943, True)),  # a lone capture, X, Xh and C resident
    (4, CAPTURE, 4, 10, (33, 3772, False)),  # CNMFModel(4, 10)'s restarts: streamed
    (16, CAPTURE, 4, 10, (8, 15_558, False)),
    (2, N, 4, 10, (24, 250, True)),
    (11, 5000, 4, 10, (12, 417, True)),  # a bootstrap of 10 and the full fit
    (1, 5000, 1, 700, (20, 250, True)),  # blocks shorter than D - 1
    (1, 600, 2, 300, (3, 200, True)),
    (140, N, 4, 10, (1, N, False)),  # more fits than SMs: one block a fit
], ids=lambda v: str(v) if not isinstance(v, tuple) else "-")
def test_cnmf_grid_plan_spreads_a_fit_over_the_card(b, t, k, d, plan):
    got = cnmf_cuda.grid_plan(b, t, L, k, d, SMS)
    assert (got.blocks, got.rows, got.resident) == plan
    row = 2 * cnmf_cuda._lp(L) + k
    assert got.smem == 4 * (cnmf_cuda.grid_small_floats(L, k, d) + got.tile * row)
    assert got.smem <= mu_cuda.SMEM_LIMIT
    if not got.resident:
        assert mu_cuda.CLUSTER_MIN_TILE <= got.tile < got.rows
        assert got.smem + 4 * row > mu_cuda.SMEM_LIMIT


def _check_rule(got, b, n, small, row):
    """The grid rule, held case by case: at most SMs // batch blocks and
    256 rows a block where the fit has them; resident at the least block
    count whose rows fit, where that is within SMs // batch; else
    streamed at SMs // batch in tiles as large as fit."""
    room = mu_cuda.SMEM_LIMIT // 4 - small

    def fits(p):
        return -(-n // p) * row <= room

    assert got.blocks * got.rows >= n > (got.blocks - 1) * got.rows
    assert got.smem == 4 * (small + got.tile * row) <= mu_cuda.SMEM_LIMIT
    p_max, p_min = max(1, SMS // b), min(max(1, SMS // b), -(-n // 256))
    if got.resident:
        assert got.tile == got.rows
        assert fits(got.blocks) and p_min <= got.blocks <= p_max
        assert not any(fits(p) for p in range(p_min, got.blocks))
    else:
        assert got.blocks == p_max and not any(fits(p) for p in range(p_min, p_max + 1))
        assert got.tile == room // row


@pytest.mark.parametrize("kl", [True, False], ids=["kl", "other"])
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_beta_grid_plan_rule_at_ranks_and_channels(b, k, l, kl):
    got = beta_cuda.grid_plan(b, CAPTURE, l, k, SMS, kl)
    _check_rule(got, b, CAPTURE, beta_cuda.grid_small_floats(l, k, kl), k + l)
    if b == 1:
        assert got.resident and got.blocks == SMS


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("k, d", [(4, 10), (8, 10), (4, 20), (2, 300)])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_cnmf_grid_plan_rule_at_ranks_and_channels(b, k, d, l):
    got = cnmf_cuda.grid_plan(b, CAPTURE, l, k, d, SMS)
    _check_rule(got, b, CAPTURE, cnmf_cuda.grid_small_floats(l, k, d),
                2 * cnmf_cuda._lp(l) + k)


def test_grid_plans_refuse_only_past_the_least_block():
    # K4: the least block (small state and a 128-row tile) bounds the entry
    for l, k in ((8, 4), (16, 8), (64, 16), (150, 16)):
        for kl in (True, False):
            assert beta_cuda.cluster_smem_bytes(l, k, kl) <= mu_cuda.SMEM_LIMIT
            beta_cuda.grid_plan(16, CAPTURE, l, k, SMS, kl)
    with pytest.raises(ValueError, match="under 128"):
        beta_cuda.grid_plan(16, CAPTURE, 2000, 16, SMS)
    with pytest.raises(ValueError, match="under 128"):
        cnmf_cuda.grid_plan(16, CAPTURE, 8, 4, 500, SMS)
    # the redesign refuses nothing the cluster design took: wherever that
    # design's least block fit, this one's does
    for l in range(1, 200, 7):
        for k in range(1, 17):
            for kl in (True, False):
                if _old_beta_cluster_bytes(l, k, kl) <= mu_cuda.SMEM_LIMIT:
                    assert beta_cuda.cluster_smem_bytes(l, k, kl) <= mu_cuda.SMEM_LIMIT
    for l in (1, 8, 12, 16, 32):
        for k in (1, 2, 4, 8, 16):
            for d in (1, 2, 10, 50, 100, 200, 300):
                if _old_cnmf_cluster_bytes(l, k, d) <= mu_cuda.SMEM_LIMIT:
                    assert cnmf_cuda.cluster_smem_bytes(l, k, d) <= mu_cuda.SMEM_LIMIT, (l, k, d)


def test_grid_workspaces_hold_counters_slots_edges_and_two_parities():
    plan = beta_cuda.grid_plan(4, CAPTURE, 8, 4, SMS, True)
    # 4 counters, 132 float64 slots, 2 x 132 sets of one 64-entry tile
    assert beta_cuda.grid_nq(8, 4) == 64 and beta_cuda.grid_nq(16, 12) == 64 * 3 * 2
    assert beta_cuda.grid_workspace_floats(plan, 4, 8, 4) == 4 + 2 * 132 + 2 * 132 * 64
    plan = cnmf_cuda.grid_plan(4, CAPTURE, 8, 4, 10, SMS)
    # 4 counters, 132 flags, 132 float64 slots, each fit's two parities of its
    # 33 blocks' first and last 9 rows of C, 2 x 132 sets of 40 items x 16
    assert cnmf_cuda.grid_items(8, 4, 10) == 40
    assert (cnmf_cuda.grid_workspace_floats(plan, 4, 8, 4, 10)
            == 4 + 132 + 2 * 132 + 4 * (4 * 33 * 9 * 4) + 2 * 132 * 640)


# ---- the split mirrors against the JAX package -----------------------

BETA_MODES = {
    "fixed": dict(max_iter=60, tol=0.0),
    "stop": dict(max_iter=400, tol=1e-3),
    "penalized": dict(max_iter=200, tol=3e-4, **REGS),
}


def _beta_start(k=4, seed=5):
    rng = np.random.default_rng(seed + k)
    scale = np.sqrt(X.mean() / k)
    return scale * (rng.random((N, k)) + 0.1), scale * (rng.random((k, L)) + 0.1)


@functools.lru_cache(maxsize=None)
def _jax_beta(beta, mode):
    w0, h0 = _beta_start()
    st = jbeta.fit_mu_beta(jnp.asarray(X), jnp.asarray(w0), jnp.asarray(h0), beta=beta,
                           **BETA_MODES[mode])
    return int(st.n_iter), np.asarray(st.w), np.asarray(st.h)


def _check(got, want, mode):
    n_iter, w, h = want
    assert int(got[0]) == n_iter
    bar = 1e-10 if mode == "fixed" else 1e-8
    assert _rel(got[1], w) < bar and _rel(got[2], h) < bar


@pytest.mark.parametrize("ranges", list(RANGES.values()), ids=list(RANGES))
@pytest.mark.parametrize("mode", list(BETA_MODES))
@pytest.mark.parametrize("beta", BETAS, ids=["kl", "is", "b1.5", "b-0.5"])
def test_beta_split_mirror_matches_jax(beta, mode, ranges):
    w0, h0 = _beta_start()
    st = fit_beta_cluster_plain(*map(torch.as_tensor, (X, w0, h0)), ranges, beta,
                                **BETA_MODES[mode])
    if mode == "fixed":
        assert int(st.n_iter) == 60 and not bool(st.converged)
    _check((st.n_iter, st.w, st.h), _jax_beta(beta, mode), mode)


# the block-range frames that a small batch sends to K4's grid entry: 200
# x 8, one block a fit (P = 1), for beta 1.5 and -0.5 and IS at rank 6
BETA_BLOCK_RANGE = [(1.5, 4), (-0.5, 4), (0.0, 6)]


@functools.lru_cache(maxsize=None)
def _jax_beta_rows(beta, k, mode, n=200):
    w0, h0 = _beta_start(k)
    st = jbeta.fit_mu_beta(jnp.asarray(X[:n]), jnp.asarray(w0[:n]), jnp.asarray(h0),
                           beta=beta, **BETA_MODES[mode])
    return int(st.n_iter), np.asarray(st.w), np.asarray(st.h)


@pytest.mark.parametrize("mode", ["fixed", "stop"])
@pytest.mark.parametrize("beta, k", BETA_BLOCK_RANGE, ids=["b1.5", "b-0.5", "is-k6"])
def test_beta_split_mirror_at_block_range_plans_matches_jax(beta, k, mode):
    plan = beta_cuda.grid_plan(16, 200, L, k, SMS, beta == 1.0)
    assert (plan.blocks, plan.rows, plan.resident) == (1, 200, True)
    assert beta_cuda.route(200, L, k, beta, batch=16, sms=SMS) == "cluster"
    w0, h0 = _beta_start(k)
    st = fit_beta_cluster_plain(*map(torch.as_tensor, (X[:200], w0[:200], h0)),
                                plan.blocks, beta, **BETA_MODES[mode])
    _check((st.n_iter, st.w, st.h), _jax_beta_rows(beta, k, mode), mode)


CNMF_MODES = {
    "fixed": dict(max_iter=40, tol=0.0),
    "stop": dict(max_iter=300, tol=1e-3),
}


@functools.lru_cache(maxsize=None)
def _cnmf_start():
    rng = np.random.default_rng(29)
    scale = np.sqrt(X.mean() / (K_CNMF * D_CNMF))
    return (scale * (rng.random((N, K_CNMF)) + 0.1),
            scale * (rng.random((K_CNMF, D_CNMF, L)) + 0.1))


@functools.lru_cache(maxsize=None)
def _jax_cnmf(mode):
    c0, s0 = _cnmf_start()
    st = jcnmf.fit_cnmf(jnp.asarray(X), jnp.asarray(c0), jnp.asarray(s0), **CNMF_MODES[mode])
    return int(st.n_iter), np.asarray(st.c), np.asarray(st.s)


@pytest.mark.parametrize("ranges", list(RANGES.values()), ids=list(RANGES))
@pytest.mark.parametrize("mode", list(CNMF_MODES))
def test_cnmf_split_mirror_matches_jax(mode, ranges):
    c0, s0 = _cnmf_start()
    st = fit_cnmf_cluster_plain(*map(torch.as_tensor, (X, c0, s0)), ranges,
                                **CNMF_MODES[mode])
    want = _jax_cnmf(mode)
    if mode == "fixed":
        assert int(st.n_iter) == 40
    else:
        assert 40 < want[0] < 300  # the stop, not max_iter, ended it
    _check((st.n_iter, st.c, st.s), want, mode)


SHORT_T, SHORT_K, SHORT_D = 257, 1, 131


@functools.lru_cache(maxsize=None)
def _short_cnmf(mode):
    x = _frame(SHORT_T, seed=17)
    rng = np.random.default_rng(31)
    scale = np.sqrt(x.mean() / (SHORT_K * SHORT_D))
    c0 = scale * (rng.random((SHORT_T, SHORT_K)) + 0.1)
    s0 = scale * (rng.random((SHORT_K, SHORT_D, L)) + 0.1)
    st = jcnmf.fit_cnmf(jnp.asarray(x), jnp.asarray(c0), jnp.asarray(s0), **CNMF_MODES[mode])
    return (x, c0, s0), (int(st.n_iter), np.asarray(st.c), np.asarray(st.s))


@pytest.mark.parametrize("mode", list(CNMF_MODES))
def test_cnmf_split_mirror_with_blocks_shorter_than_the_lags_matches_jax(mode):
    # the plan on a card of 3 SMs: 2 blocks of 129 and 128 rows, each
    # shorter than D - 1 = 130, so each block's halo is all of the other
    plan = cnmf_cuda.grid_plan(1, SHORT_T, L, SHORT_K, SHORT_D, 3)
    assert (plan.blocks, plan.rows) == (2, 129)
    bounds = split_rows(SHORT_T, plan.blocks)
    assert [g for g, *_ in halo_rows(bounds, 1, SHORT_D, SHORT_T)] == list(range(129))
    (x, c0, s0), want = _short_cnmf(mode)
    st = fit_cnmf_cluster_plain(*map(torch.as_tensor, (x, c0, s0)), plan.blocks,
                                **CNMF_MODES[mode])
    _check((st.n_iter, st.c, st.s), want, mode)


# ---- the per-capture model on a frame the card fits on a cluster ------

@pytest.mark.parametrize("loss", ["kullback-leibler", "itakura-saito"])
def test_beta_nmf_model_on_a_cluster_frame_matches_jax(loss):
    assert beta_cuda.route(N, L, 4, 1.0 if loss == "kullback-leibler" else 0.0) == "cluster"
    kw = dict(n_components=4, solver="mu", beta_loss=loss, max_iter=200, tol=1e-4)
    jm = jselect.NMFModel(**kw)
    jw = np.asarray(jm.fit_transform(X))
    tm = select.NMFModel(**kw, device="cpu", dtype=torch.float64)
    tw = tm.fit_transform(X)
    assert tm.n_iter_ == jm.n_iter_
    assert _rel(tw, jw) < 1e-8 and _rel(tm.components_, np.asarray(jm.components_)) < 1e-8
