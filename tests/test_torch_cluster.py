"""PyTorch port: the cluster entries of K1 (MU) and K2 (CD) on the CPU.

A fit whose frame exceeds one block's shared memory is spread over
many blocks of the card: each block owns a range of rows, updates its
rows of W, adds their share of W^T W and W^T X, and every block sums
the blocks' partial Grams in block order before updating H.  The
kernels run only on the card; here

- :func:`route` of K1 and K2 is held to a table of frames (the warp,
  block and cluster entries, and the refusal past the cluster's limit);
- ``mu_cuda.grid_plan``, the mirror of the plan the kernels report, is
  held to the plans of capture-length frames alone and batched, the
  switch from rows resident in shared memory to streamed tiles, and
  ranks 4, 8 and 16 at 8 and 16 channels;
- the plain mirrors of that split (``torch_cluster_split.py``),
  ``fit_mu_cluster_plain`` and ``fit_cd_cluster_plain``, are held in float64 to the JAX package's
  XLA solvers on a 6,000 x 8 matrix (one range, three, sixteen, and
  ranges of unequal length): 200 fixed iterations to 1e-10 relative,
  fits with the stop on to the same iteration count and factors to
  1e-8, with and without sklearn's L1/L2 penalties and, for MU,
  ``inner_iter=2``; and at the splits the plan picks on the card (132
  ranges for a lone fit, 33 for 4 at once, 4 ranges streamed in tiles),
  and for the block-range frames a small batch sends to the grid
  entries (10 ranges for a lone 2,400 x 8 subject, 2 for 5 fits on 10
  SMs, 1 for 225 x 8).
  Summing the Grams range by range changes only the order of float64
  additions (~1e-16 an iteration);
- ``NMFModel`` of the port (CPU, float64) is held to the JAX package's
  on the same 6,000 x 8 frame, which the card fits on a cluster entry.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_cluster_split import (  # noqa: E402
    fit_cd_cluster_plain,
    fit_mu_cluster_plain,
    split_rows,
)

import jax.numpy as jnp  # noqa: E402

from muscle_synergies_tpu.models import hals as jhals  # noqa: E402
from muscle_synergies_tpu.models import mu as jmu  # noqa: E402
from muscle_synergies_tpu.models import select as jselect  # noqa: E402
from muscle_synergies_tpu_torch.models import select  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda  # noqa: E402

N, L = 6000, 8
RANGES = [1, 3, 16, [0, 500, 2600, 2601, 6000]]
REGS = dict(l1_reg_w=0.02, l2_reg_w=0.05, l1_reg_h=0.01, l2_reg_h=0.03)


def _frame(n=N, l=L, seed=13):
    """A non-negative 4-synergy envelope with noise, ``(n, l)``."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 25.0, n)[:, None]
    acts = np.abs(np.sin(2 * np.pi * (t * (0.8 + 0.4 * rng.random(4)) + rng.random(4))))
    return acts @ rng.random((4, l)) + 0.05 * rng.random((n, l))


X = _frame()


def _start(k, seed=5):
    rng = np.random.default_rng(seed + k)
    scale = np.sqrt(X.mean() / k)
    return scale * rng.random((N, k)), scale * rng.random((k, L))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _n_max_block(l, k):
    """The most rows whose fit fits one block (``mu_cuda.smem_bytes``)."""
    per_row = 4 * ((l | 1) + (k | 1))
    return (mu_cuda.SMEM_LIMIT - 4 * (2 * k * l + k * k + 33)) // per_row


# ---- route -----------------------------------------------------------

ROUTES = [
    ((200, 8, 4), "warp"),
    ((2000, 8, 4), "block"),
    ((_n_max_block(8, 4), 8, 4), "block"),
    ((_n_max_block(8, 4) + 1, 8, 4), "cluster"),
    ((_n_max_block(16, 8), 16, 8), "block"),
    ((_n_max_block(16, 8) + 1, 16, 8), "cluster"),
    ((5000, 8, 4), "cluster"),
    ((20_000, 8, 4), "cluster"),
    *[((20_000, 16, k), "cluster") for k in range(1, 9)],
    *[((124_460, 8, k), "cluster") for k in range(1, 9)],
    ((124_460, 8, 16), "cluster"),
    ((2000, 2000, 16), None),
]


@pytest.mark.parametrize("module", [mu_cuda, cd_cuda], ids=["mu", "cd"])
@pytest.mark.parametrize("shape, entry", ROUTES, ids=[f"{s[0]}x{s[1]}k{s[2]}" for s, _ in ROUTES])
def test_route_takes_the_entry_of_the_frame(module, shape, entry):
    if entry is None:
        with pytest.raises(ValueError, match="impl='torch'"):
            module.route(*shape)
    else:
        assert module.route(*shape) == entry


@pytest.mark.parametrize("batch", [1, 4, 51, 1024])
@pytest.mark.parametrize("shape, entry", ROUTES,
                         ids=[f"{s[0]}x{s[1]}k{s[2]}" for s, _ in ROUTES])
def test_k1_routes_a_batch_of_block_range_frames_to_its_grid_entry(shape, entry, batch):
    """Given the batch, K1 sends every frame of the table that K2 keeps on
    its block entry to its grid entry (ranks 1-8: its grid kernel holds
    two blocks a SM and was no slower at any batch measured); the rest
    route as without one."""
    if entry is None:
        with pytest.raises(ValueError, match="impl='torch'"):
            mu_cuda.route(*shape, batch=batch, sms=SMS)
        return
    want = "cluster" if entry == "block" else entry
    assert mu_cuda.route(*shape, batch=batch, sms=SMS) == want


def test_the_block_limit_sits_where_smem_bytes_puts_it():
    for l, k in ((8, 4), (16, 8)):
        n = _n_max_block(l, k)
        assert mu_cuda.smem_bytes(n, l, k) <= mu_cuda.SMEM_LIMIT
        assert mu_cuda.smem_bytes(n + 1, l, k) > mu_cuda.SMEM_LIMIT
    # about 4,140 rows at 8 channels and rank 4, about 2,220 at 16 and 8
    assert 4100 < _n_max_block(8, 4) < 4200 and 2200 < _n_max_block(16, 8) < 2300


def test_the_cluster_limit_is_its_blocks_shared_memory():
    # every frame of 8 or 16 channels at ranks 1-16 takes the cluster entry,
    # whatever its rows; a frame whose H and Grams fill a block does not
    for l in (8, 16):
        for k in range(1, 17):
            assert mu_cuda.cluster_smem_bytes(l, k) <= mu_cuda.SMEM_LIMIT
    assert mu_cuda.cluster_smem_bytes(2000, 16) > mu_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="rank"):
        cd_cuda.route(124_460, 8, 17)


def test_split_rows_cuts_as_the_kernel_does():
    assert split_rows(10, 1) == [0, 10]
    assert split_rows(10, 3) == [0, 4, 8, 10]
    # a block past N owns no rows
    assert split_rows(10, 16) == [0] + list(range(1, 11)) + [10] * 6
    assert split_rows(10, [0, 2, 2, 10]) == [0, 2, 2, 10]
    for bad in ([1, 10], [0, 5], [0, 6, 4, 10]):
        with pytest.raises(ValueError, match="bounds"):
            split_rows(10, bad)
    with pytest.raises(ValueError, match="ranges"):
        split_rows(10, 0)


# ---- the plan mirror -------------------------------------------------

SMS = 132  # an H100 SXM's SMs
CAPTURE = 124_460


def _old_cluster_smem_bytes(l, k):
    """The least block of the thread-block-cluster design these entries
    replaced: H, the Grams, two partial sums, two tiles of 128 rows."""
    return 4 * (4 * k * l + 3 * k * k + 36 + 2 * 128 * ((l | 1) + (k | 1)))


@pytest.mark.parametrize("b, n, plan", [
    (1, CAPTURE, (132, 943, True)),  # a lone capture on every SM
    (4, CAPTURE, (33, 3772, True)),  # 4 at once, a quarter of the card each
    (2, CAPTURE, (66, 1886, True)),
    (5, CAPTURE, (26, 4787, False)),  # 5 at once no longer fit: streamed
    (16, CAPTURE, (8, 15_558, False)),  # phase 22's grid of 4 trials x 4 ranks
    (1, 20_000, (79, 254, True)),  # at least 256 rows a block
    (4, 20_000, (33, 607, True)),
    (51, 6000, (2, 3000, True)),  # a bootstrap's 51 fits
    (140, 6000, (1, 6000, False)),  # more fits than SMs: one block a fit
    (1, 4150, (17, 245, True)),
    # block-range frames: the bootstrap of a 2,400 x 8 subject (51 fits),
    # smaller batches of it, more fits than SMs, and a 225-row frame
    (51, 2400, (2, 1200, True)),
    (16, 2400, (8, 300, True)),
    (1, 2400, (10, 240, True)),
    (1024, 2400, (1, 2400, True)),
    (4, 4000, (16, 250, True)),
    (1, 225, (1, 225, True)),
], ids=lambda v: str(v) if not isinstance(v, tuple) else "-")
def test_grid_plan_spreads_a_fit_over_the_card(b, n, plan):
    got = mu_cuda.grid_plan(b, n, 8, 4, SMS)
    assert (got.blocks, got.rows, got.resident) == plan
    assert got.blocks * b <= SMS or got.blocks == 1
    if got.resident:
        assert got.tile == got.rows
    else:
        # tiles of as many rows as fit, the block's share in shared memory
        assert CLUSTER_MIN_TILE <= got.tile < got.rows
        assert got.smem + 4 * 12 > mu_cuda.SMEM_LIMIT
    assert got.smem == 4 * (mu_cuda.grid_small_floats(8, 4) + got.tile * 12)
    assert got.smem <= mu_cuda.SMEM_LIMIT


CLUSTER_MIN_TILE = mu_cuda.CLUSTER_MIN_TILE


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_grid_plan_rule_at_ranks_and_channels(b, k, l):
    """The rule, held case by case: at most SMs // batch blocks and 256
    rows a block where the fit has them; resident at the least block
    count whose rows fit, where that is within SMs // batch; else
    streamed at SMs // batch in tiles as large as fit."""
    got = mu_cuda.grid_plan(b, CAPTURE, l, k, SMS)
    row, small = k + l, mu_cuda.grid_small_floats(l, k)
    room = mu_cuda.SMEM_LIMIT // 4 - small

    def fits(p):
        return -(-CAPTURE // p) * row <= room

    assert got.blocks * got.rows >= CAPTURE > (got.blocks - 1) * got.rows
    assert got.smem == 4 * (small + got.tile * row) <= mu_cuda.SMEM_LIMIT
    p_max, p_min = SMS // b, min(SMS // b, -(-CAPTURE // 256))
    if got.resident:
        assert fits(got.blocks) and p_min <= got.blocks <= p_max
        # no fewer blocks from p_min up would hold their rows
        assert not any(fits(p) for p in range(p_min, got.blocks))
    else:
        assert got.blocks == p_max and not any(fits(p) for p in range(p_min, p_max + 1))
        assert got.tile == room // row
    # a lone capture-length fit always spreads over the card, resident
    if b == 1:
        assert got.resident and got.blocks == SMS


def test_grid_plan_refuses_only_past_the_least_block():
    # the least block (small state and a 128-row tile) bounds the entry
    for l, k in ((8, 4), (16, 8), (64, 16), (150, 16), (200, 1)):
        assert mu_cuda.cluster_smem_bytes(l, k) <= mu_cuda.SMEM_LIMIT
        mu_cuda.grid_plan(16, CAPTURE, l, k, SMS)
    with pytest.raises(ValueError, match="under 128"):
        mu_cuda.grid_plan(16, CAPTURE, 2000, 16, SMS)
    # the redesign refuses nothing the cluster design took: wherever
    # that design's least block fit, this one's does
    for l in range(1, 300):
        for k in range(1, 17):
            if _old_cluster_smem_bytes(l, k) <= mu_cuda.SMEM_LIMIT:
                assert mu_cuda.cluster_smem_bytes(l, k) <= mu_cuda.SMEM_LIMIT, (l, k)


def test_grid_workspace_holds_counters_slots_and_two_parities():
    plan = mu_cuda.grid_plan(4, CAPTURE, 8, 4, SMS)
    # 4 counters, 132 slots, 2 x 132 partial sets of 64 entries and a scalar
    assert mu_cuda.grid_workspace_floats(plan, 4, 8, 4) == 4 + 132 + 2 * 132 * 68
    assert mu_cuda.grid_nq(8, 4) == 64 and mu_cuda.grid_nq(16, 8) == 2 * 3 * 32


# ---- the split mirrors against the JAX package -----------------------

MODES = {
    "fixed": dict(max_iter=200, tol=0.0),
    "stop": dict(max_iter=1000, tol=1e-4),
    "penalized": dict(max_iter=600, tol=1e-2, **REGS),
}


@functools.lru_cache(maxsize=None)
def _jax_fit(solver, k, mode, inner_iter=1):
    w0, h0 = _start(k)
    args = (jnp.asarray(X), jnp.asarray(w0), jnp.asarray(h0))
    if solver == "mu":
        st = jmu.fit_mu(*args, inner_iter=inner_iter, **MODES[mode])
        return int(st.n_iter), np.asarray(st.w), np.asarray(st.h)
    st = jhals.fit_cd(*args, **MODES[mode])
    return int(st.n_iter), np.asarray(st.w), np.asarray(st.ht).T


def _check(got_n_iter, got_w, got_h, want, mode):
    n_iter, w, h = want
    assert int(got_n_iter) == n_iter
    bar = 1e-10 if mode == "fixed" else 1e-8
    assert _rel(got_w, w) < bar and _rel(got_h, h) < bar


@pytest.mark.parametrize("ranges", RANGES, ids=["C1", "C3", "C16", "unequal"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [2, 4])
def test_mu_split_mirror_matches_jax(k, mode, ranges):
    w0, h0 = _start(k)
    st = fit_mu_cluster_plain(*map(torch.as_tensor, (X, w0, h0)), ranges,
                                      **MODES[mode])
    if mode == "fixed":
        assert int(st.n_iter) == 200 and not bool(st.converged)
    _check(st.n_iter, st.w, st.h, _jax_fit("mu", k, mode), mode)


@pytest.mark.parametrize("ranges", [3, [0, 500, 2600, 2601, 6000]], ids=["C3", "unequal"])
@pytest.mark.parametrize("mode", ["fixed", "penalized"])
def test_mu_split_mirror_matches_jax_with_inner_iterations(mode, ranges):
    w0, h0 = _start(4)
    st = fit_mu_cluster_plain(*map(torch.as_tensor, (X, w0, h0)), ranges,
                                      inner_iter=2, **MODES[mode])
    _check(st.n_iter, st.w, st.h, _jax_fit("mu", 4, mode, inner_iter=2), mode)


@pytest.mark.parametrize("ranges", RANGES, ids=["C1", "C3", "C16", "unequal"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [2, 4])
def test_cd_split_mirror_matches_jax(k, mode, ranges):
    w0, h0 = _start(k)
    st = fit_cd_cluster_plain(*map(torch.as_tensor, (X, w0, h0)), ranges,
                                      **MODES[mode])
    if mode == "fixed":
        assert int(st.n_iter) == 200
    _check(st.n_iter, st.w, st.ht.T, _jax_fit("cd", k, mode), mode)


# the splits the card's plan takes: a lone capture-length fit (132
# ranges), 4 at once (33), and 4 ranges streamed in tiles of 700 rows
GRID_SPLITS = {"lone": dict(ranges=132), "four": dict(ranges=33),
               "streamed": dict(ranges=4, tile=700)}
GRID_MODES = [("mu", m) for m in ("fixed", "stop", "penalized", "inner2")] + [
    ("cd", m) for m in ("fixed", "stop", "penalized")]


@pytest.mark.parametrize("split", list(GRID_SPLITS))
@pytest.mark.parametrize("solver, mode", GRID_MODES,
                         ids=[f"{s}-{m}" for s, m in GRID_MODES])
def test_split_mirrors_at_the_grid_plans_splits_match_jax(solver, mode, split):
    assert mu_cuda.grid_plan(1, CAPTURE, 8, 4, SMS).blocks == 132
    assert mu_cuda.grid_plan(4, CAPTURE, 8, 4, SMS).blocks == 33
    w0, h0 = _start(4)
    inner = dict(inner_iter=2) if mode == "inner2" else {}
    kw = MODES["fixed" if mode == "inner2" else mode]
    mirror = fit_mu_cluster_plain if solver == "mu" else fit_cd_cluster_plain
    st = mirror(*map(torch.as_tensor, (X, w0, h0)), **GRID_SPLITS[split], **kw, **inner)
    h = st.h if solver == "mu" else st.ht.T
    want = _jax_fit(solver, 4, "fixed" if mode == "inner2" else mode, **inner)
    _check(st.n_iter, st.w, h, want, "fixed" if mode in ("fixed", "inner2") else mode)


@pytest.mark.parametrize("solver", ["mu", "cd"])
def test_split_mirrors_stop_each_fit_on_its_own(solver):
    """A batch of fits (the card's batch of clusters): each stops where
    its own single fit stops, and zero-padded components stay 0."""
    fits = []
    for k in (2, 4):
        w0, h0 = _start(k)
        fits.append((np.pad(w0, ((0, 0), (0, 4 - k))), np.pad(h0, ((0, 4 - k), (0, 0)))))
    xs = torch.as_tensor(np.stack([X, X]))
    w0 = torch.as_tensor(np.stack([f[0] for f in fits]))
    h0 = torch.as_tensor(np.stack([f[1] for f in fits]))
    mirror = fit_mu_cluster_plain if solver == "mu" else fit_cd_cluster_plain
    st = mirror(xs, w0, h0, 3, max_iter=1000, tol=1e-4)
    h = st.h if solver == "mu" else st.ht.transpose(-1, -2)
    assert (st.w[0, :, 2:] == 0).all() and (h[0, 2:] == 0).all()
    for i, k in enumerate((2, 4)):
        _check(st.n_iter[i], st.w[i, :, :k], h[i, :k], _jax_fit(solver, k, "stop"), "stop")


# the block-range plans: a 2,400 x 8 subject, 5 fits on a card of 10 SMs
# (the emulated card's plan, 2 ranges of 1,200 rows; the bootstrap's 51
# fits on 132 SMs take the same), 16 fits (8 ranges); a 225 x 8 frame (1)
BLOCK_RANGE_PLANS = {"2400-p2": (5, 2400, 10), "2400-p8": (16, 2400, SMS),
                     "225-p1": (4, 225, SMS)}


@functools.lru_cache(maxsize=None)
def _jax_fit_rows(n, mode, solver="mu"):
    w0, h0 = _start(4)
    args = (jnp.asarray(X[:n]), jnp.asarray(w0[:n]), jnp.asarray(h0))
    if solver == "cd":
        st = jhals.fit_cd(*args, **MODES[mode])
        return int(st.n_iter), np.asarray(st.w), np.asarray(st.ht).T
    st = jmu.fit_mu(*args, **MODES[mode])
    return int(st.n_iter), np.asarray(st.w), np.asarray(st.h)


@pytest.mark.parametrize("mode", ["fixed", "stop"])
@pytest.mark.parametrize("case", list(BLOCK_RANGE_PLANS))
def test_mu_split_mirror_at_block_range_plans_matches_jax(case, mode):
    b, n, sms = BLOCK_RANGE_PLANS[case]
    plan = mu_cuda.grid_plan(b, n, L, 4, sms)
    assert plan.blocks == int(case.split("-p")[1]) and plan.resident
    assert plan == mu_cuda.grid_plan(51, n, L, 4, SMS) or case != "2400-p2"
    w0, h0 = _start(4)
    st = fit_mu_cluster_plain(*map(torch.as_tensor, (X[:n], w0[:n], h0)), plan.blocks,
                              **MODES[mode])
    _check(st.n_iter, st.w, st.h, _jax_fit_rows(n, mode), mode)


# K2's block-range plans, which a small batch now takes: a lone 2,400 x 8
# subject over 10 ranges of 240 rows, 5 fits on a card of 10 SMs (2
# ranges of 1,200 rows each), and a 225 x 8 frame on one range
CD_BLOCK_RANGE_PLANS = {"2400-p10": (1, 2400, SMS), "2400-p2": (5, 2400, 10),
                        "225-p1": (1, 225, SMS)}


@pytest.mark.parametrize("mode", ["fixed", "stop"])
@pytest.mark.parametrize("case", list(CD_BLOCK_RANGE_PLANS))
def test_cd_split_mirror_at_block_range_plans_matches_jax(case, mode):
    b, n, sms = CD_BLOCK_RANGE_PLANS[case]
    assert cd_cuda.route(n, L, 4, batch=b, sms=sms) == "cluster"
    plan = mu_cuda.grid_plan(b, n, L, 4, sms)
    assert plan.blocks == int(case.split("-p")[1]) and plan.resident
    w0, h0 = _start(4)
    st = fit_cd_cluster_plain(*map(torch.as_tensor, (X[:n], w0[:n], h0)), plan.blocks,
                              **MODES[mode])
    _check(st.n_iter, st.w, st.ht.T, _jax_fit_rows(n, mode, "cd"), mode)


# ---- the per-capture model on a frame the card fits on a cluster ------

@pytest.mark.parametrize("kw", [dict(n_components=4), dict(n_components=4, solver="mu"),
                                dict(n_components=2, solver="mu", alpha_W=0.01)],
                         ids=["cd", "mu", "mu-penalized"])
def test_nmf_model_on_a_cluster_frame_matches_jax(kw):
    assert cd_cuda.route(N, L, kw["n_components"]) == "cluster"
    fit = dict(max_iter=400, tol=1e-4)
    jm = jselect.NMFModel(**kw, **fit)
    jw = np.asarray(jm.fit_transform(X))
    tm = select.NMFModel(**kw, **fit, device="cpu", dtype=torch.float64)
    tw = tm.fit_transform(X)
    assert tm.n_iter_ == jm.n_iter_
    assert _rel(tw, jw) < 1e-8 and _rel(tm.components_, np.asarray(jm.components_)) < 1e-8
    assert abs(tm.reconstruction_err_ - float(jm.reconstruction_err_)) < (
        1e-8 * float(jm.reconstruction_err_))
