"""PyTorch port: NMF initialization and the batched CD/MU solvers vs JAX.

The port's plain solvers are the CUDA kernels' references; here they
are held, in float64, to the JAX package's Pallas kernels run in
interpret mode (as ``tests/test_kernels.py`` runs them) and to its XLA
solvers.  Tolerances: fixed-iteration iterates 1e-10 relative, fits
1e-8 on the factors with equal iteration counts, inits 1e-10 (the two
LAPACK SVDs agree to ~1e-14 after the shared sign convention).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from muscle_synergies_tpu.models import batch as jbatch  # noqa: E402
from muscle_synergies_tpu.models import hals as jhals  # noqa: E402
from muscle_synergies_tpu.models import init as jinit  # noqa: E402
from muscle_synergies_tpu.models import mu as jmu  # noqa: E402
from muscle_synergies_tpu.models.kernels import (  # noqa: E402
    cd_iterations_pallas,
    fit_cd_pallas,
    fit_mu_pallas,
    mu_iterations_pallas,
)
from muscle_synergies_tpu_torch import convert  # noqa: E402
from muscle_synergies_tpu_torch.models import batch as tbatch  # noqa: E402
from muscle_synergies_tpu_torch.models import hals as thals  # noqa: E402
from muscle_synergies_tpu_torch.models import init as tinit  # noqa: E402
from muscle_synergies_tpu_torch.models import mu as tmu  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda  # noqa: E402

RNG = np.random.default_rng(31)
B, N, L, K = 4, 40, 8, 4
X = RNG.random((B, N, L))
W0 = RNG.random((B, N, K))
H0 = RNG.random((B, K, L))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("variant", ["nndsvd", "nndsvda"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_nndsvd_matches_jax(variant, k):
    jw, jh = jax.vmap(lambda a: jinit.nndsvd(a, k, variant=variant))(jnp.asarray(X))
    tw, th = tinit.nndsvd(torch.as_tensor(X), k, variant=variant)
    assert tw.shape == (B, N, k) and th.shape == (B, k, L)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-10)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-10)


def test_initialize_nmf_default_matches_jax_single_and_batch():
    jw, jh = jinit.initialize_nmf(jnp.asarray(X[0]), 3)
    tw, th = tinit.initialize_nmf(torch.as_tensor(X[0]), 3)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-10)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-10)
    bw, bh = tbatch.init_batch(X, 3)
    np.testing.assert_allclose(bw[0].numpy(), tw.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(bh[0].numpy(), th.numpy(), rtol=0, atol=1e-13)


def test_random_inits_come_from_the_generator():
    x = torch.as_tensor(X[0])
    a = tinit.initialize_nmf(x, 9, seed=3)  # k > min(N, L): sklearn picks random
    b = tinit.initialize_nmf(x, 9, generator=torch.Generator().manual_seed(3))
    assert a[0].shape == b[0].shape == (N, 9) and a[1].shape == b[1].shape == (9, L)
    # seed= draws what the JAX package draws; generator= draws from it
    jw, jh = jinit.initialize_nmf(jnp.asarray(X[0]), 9, seed=3)
    np.testing.assert_allclose(a[0].numpy(), np.asarray(jw), rtol=1e-12, atol=0)
    np.testing.assert_allclose(a[1].numpy(), np.asarray(jh), rtol=1e-12, atol=0)
    g = torch.Generator().manual_seed(3)  # h's draw, then w's
    nh, nw = torch.randn((9, L), generator=g, dtype=x.dtype), torch.randn(
        (N, 9), generator=g, dtype=x.dtype)
    avg = (x.mean() / 9).sqrt()
    assert torch.equal(b[0], (avg * nw).abs()) and torch.equal(b[1], (avg * nh).abs())
    assert not torch.equal(a[0], b[0])
    assert (a[0] >= 0).all() and (a[1] >= 0).all() and (b[0] >= 0).all()
    w, h = tinit.nndsvd(x, 4, variant="nndsvdar", seed=1)
    plain_w, _ = tinit.nndsvd(x, 4, variant="nndsvd")
    assert (w > 0).all() and torch.equal(w[plain_w > 0], plain_w[plain_w > 0])


def test_init_errors():
    x = torch.as_tensor(X[0])
    with pytest.raises(ValueError, match="n_components"):
        tinit.initialize_nmf(x, 9, init="nndsvda")
    with pytest.raises(ValueError, match="Invalid init"):
        tinit.initialize_nmf(x, 2, init="svd")
    with pytest.raises(ValueError, match="svd_method"):
        tinit.initialize_nmf(x, 2, svd_method="lanczos")


def test_mask_zeroes_padded_rows():
    trials = [X[0], X[1][:30]]
    padded, mask = tbatch.pad_and_stack(trials)
    w, _ = tbatch.init_batch(padded, 2, mask=mask)
    assert (w[1, 30:] == 0).all()


@pytest.mark.parametrize("inner_iter", [1, 3])
def test_mu_iterations_match_pallas_kernel(inner_iter):
    jw, jh = mu_iterations_pallas(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0),
                                  20, block_b=B, interpret=True, inner_iter=inner_iter)
    tw, th = tbatch.mu_iterations_batch(*_t(X, W0, H0), 20, inner_iter=inner_iter)
    assert _rel(tw, jw) < 1e-10 and _rel(th, jh) < 1e-10


def test_cd_iterations_match_pallas_kernel():
    jw, jh = cd_iterations_pallas(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0),
                                  20, block_b=B, interpret=True)
    tw, th = tbatch.cd_iterations_batch(*_t(X, W0, H0), 20)
    assert _rel(tw, jw) < 1e-10 and _rel(th, jh) < 1e-10


def test_fit_mu_batch_matches_pallas_kernel():
    jw, jh, jn, jerr, jconv = fit_mu_pallas(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0), max_iter=300,
        tol=1e-4, block_b=B, interpret=True)
    st = tbatch.fit_mu_batch(*_t(X, W0, H0), max_iter=300, tol=1e-4)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(jconv))
    assert _rel(st.w, jw) < 1e-8 and _rel(st.h, jh) < 1e-8
    assert _rel(st.previous_error, jerr) < 1e-10


def test_fit_cd_batch_matches_pallas_kernel():
    jw, jh, jn, jviol, jconv = fit_cd_pallas(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0), max_iter=300,
        tol=1e-4, block_b=B, interpret=True)
    st = tbatch.fit_cd_batch(*_t(X, W0, H0), max_iter=300, tol=1e-4)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(jconv))
    assert _rel(st.w, jw) < 1e-8
    assert _rel(convert.h_from_ht(st.ht), jh) < 1e-8
    assert _rel(st.violation_init, jviol) < 1e-10


@pytest.mark.parametrize("solver", ["mu", "cd"])
def test_penalized_fits_match_jax_xla(solver):
    regs = dict(l1_reg_w=0.05, l2_reg_w=0.1, l1_reg_h=0.2, l2_reg_h=0.3)
    args = (jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0))
    if solver == "mu":
        js = jbatch.fit_mu_batch(*args, max_iter=200, tol=1e-4, **regs)
        ts = tbatch.fit_mu_batch(*_t(X, W0, H0), max_iter=200, tol=1e-4,
                                 impl="auto", **regs)
        ps = mu_cuda.fit_mu_plain(*_t(X, W0, H0), max_iter=200, tol=1e-4, **regs)
        th, jh = ts.h, js.h
    else:
        js = jbatch.fit_cd_batch(*args, max_iter=200, tol=1e-4, **regs)
        ts = tbatch.fit_cd_batch(*_t(X, W0, H0), max_iter=200, tol=1e-4,
                                 impl="auto", **regs)
        ps = cd_cuda.fit_cd_plain(*_t(X, W0, H0), max_iter=200, tol=1e-4, **regs)
        th, jh = ts.ht, js.ht
    np.testing.assert_array_equal(ts.n_iter.numpy(), np.asarray(js.n_iter))
    assert _rel(ts.w, js.w) < 1e-8 and _rel(th, jh) < 1e-8
    # the kernel's plain version takes the penalties the kernel takes
    assert all(torch.equal(a, b) for a, b in zip(ps, ts))


def test_single_problem_solvers_match_jax():
    x, w, h = X[0], W0[0], H0[0]
    js = jmu.fit_mu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), max_iter=150)
    ts = tmu.fit_mu(*_t(x, w, h), max_iter=150)
    assert int(ts.n_iter) == int(js.n_iter) and ts.w.shape == (N, K)
    assert _rel(ts.w, js.w) < 1e-8
    assert abs(float(tmu.frobenius_error(*_t(x, w, h)))
               - float(jmu.frobenius_error(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(h)))) < 1e-12
    js = jhals.fit_cd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), max_iter=150)
    ts = thals.fit_cd(*_t(x, w, h), max_iter=150)
    assert int(ts.n_iter) == int(js.n_iter) and ts.ht.shape == (L, K)
    assert _rel(ts.ht, js.ht) < 1e-8
    jw, jv = jhals.cd_pass(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h.T), 0.1, 0.2)
    tw, tv = thals.cd_pass(*_t(x, w, h.T), 0.1, 0.2)
    assert _rel(tw, jw) < 1e-12 and abs(float(tv) - float(jv)) < 1e-10 * float(jv)


@pytest.mark.parametrize("solver", ["mu", "cd"])
def test_zero_padded_rank_components_stay_zero(solver):
    w0, h0 = W0.copy(), H0.copy()
    w0[..., 2:] = 0.0
    h0[:, 2:] = 0.0
    fit = tbatch.fit_mu_batch if solver == "mu" else tbatch.fit_cd_batch
    st = fit(*_t(X, w0, h0), max_iter=100, tol=1e-4)
    h = st.h if solver == "mu" else convert.h_from_ht(st.ht)
    assert (st.w[..., 2:] == 0).all() and (h[:, 2:] == 0).all()
    ref = fit(*_t(X, w0[..., :2], h0[:, :2]), max_iter=100, tol=1e-4)
    np.testing.assert_array_equal(st.n_iter.numpy(), ref.n_iter.numpy())
    assert _rel(st.w[..., :2], ref.w) < 1e-12


def test_tol_zero_runs_to_max_iter():
    st = tbatch.fit_mu_batch(*_t(X, W0, H0), max_iter=37, tol=0.0)
    assert (st.n_iter == 37).all() and not st.converged.any()
    st = tbatch.fit_cd_batch(*_t(X, W0, H0), max_iter=37, tol=0.0)
    assert (st.n_iter == 37).all()


def test_vaf_batch_matches_jax():
    jo, jp = jbatch.vaf_batch(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0))
    to, tp = tbatch.vaf_batch(*_t(X, W0, H0))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-12)


def test_kernel_wrappers_plain_versions_and_refusals():
    x, w, h = _t(X, W0, H0)
    pw, ph = mu_cuda.mu_iterations_plain(x, w, h, 5)
    bw, bh = tbatch.mu_iterations_batch(x, w, h, 5, impl="auto")
    assert torch.equal(pw, bw) and torch.equal(ph, bh)
    st = cd_cuda.fit_cd_plain(x, w, h, max_iter=20)
    assert torch.equal(st.w, tbatch.fit_cd_batch(x, w, h, max_iter=20).w)
    with pytest.raises(ValueError, match="CUDA"):
        tbatch.fit_mu_batch(x, w, h, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        cd_cuda.fit_cd_cuda(x, w, h)
    with pytest.raises(ValueError, match="CUDA"):
        tbatch.fit_cd_batch(x, w, h, impl="cuda", l1_reg_w=0.1)
    with pytest.raises(ValueError, match="impl"):
        tbatch.cd_iterations_batch(x, w, h, 2, impl="pallas")


def test_kernel_shape_bounds():
    assert mu_cuda.smem_bytes(200, 8, 4) == 4 * (200 * (9 + 5) + 64 + 16 + 33)
    assert mu_cuda.smem_bytes(200, 8, 4) < 48 * 1024
    assert mu_cuda.smem_bytes(4000, 64, 16) > mu_cuda.SMEM_LIMIT


@pytest.mark.parametrize("k", range(1, 9))
def test_cd_kernel_takes_the_warp_entry_at_200x8(k):
    """Every rank of rank_sweep_batch over 1-8 on a time-normalised frame
    fits K2's warp entry (csrc/cd_nmf.cu CD_WARP_NMAX/LMAX/KMAX)."""
    assert cd_cuda.route(200, 8, k) == "warp"


def test_cd_kernel_routes_around_the_warp_limits():
    n, l, k = cd_cuda.WARP_NMAX, cd_cuda.WARP_LMAX, cd_cuda.WARP_KMAX
    assert (n, l, k) == (224, 16, 8)
    assert cd_cuda.route(n, l, k) == "warp"
    assert cd_cuda.route(n + 1, 8, 4) == "block"
    assert cd_cuda.route(200, l + 1, 4) == "block"
    assert cd_cuda.route(200, 8, k + 1) == "block"
    assert cd_cuda.route(2000, 8, 4) == "block"
    # over one block's shared memory: the cluster entry, up to its own limit
    assert cd_cuda.route(20_000, 8, 4) == "cluster"
    with pytest.raises(ValueError, match="impl='torch'"):
        cd_cuda.route(2000, 2000, 16)
    with pytest.raises(ValueError, match="rank"):
        cd_cuda.route(200, 8, 17)


@pytest.mark.parametrize("k", range(1, 9))
def test_mu_kernel_takes_the_warp_entry_at_200x8(k):
    """Every rank of a 1-8 sweep on a time-normalised frame fits K1's warp
    entry (csrc/nmf_common.cuh NMF_WARP_NMAX/LMAX/KMAX)."""
    assert mu_cuda.route(200, 8, k) == "warp"


@pytest.mark.parametrize("n, l, k, entry", [
    (224, 16, 8, "warp"), (225, 8, 4, "block"), (200, 17, 4, "block"),
    (200, 8, 9, "block"), (2000, 8, 4, "block"),
])
def test_mu_kernel_routes_around_the_warp_limits(n, l, k, entry):
    assert (mu_cuda.WARP_NMAX, mu_cuda.WARP_LMAX, mu_cuda.WARP_KMAX) == (224, 16, 8)
    assert (cd_cuda.WARP_NMAX, cd_cuda.WARP_LMAX, cd_cuda.WARP_KMAX) == (224, 16, 8)
    assert mu_cuda.route(n, l, k) == entry


SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("n, l, k, batch, entry", [
    (225, 8, 4, 1, "cluster"), (225, 8, 4, 1024, "cluster"),
    (2000, 8, 4, 16, "cluster"), (2400, 8, 4, 51, "cluster"),
    (2400, 8, 4, 1024, "cluster"), (4000, 8, 4, 4, "cluster"),
    (200, 17, 4, 1024, "cluster"), (224, 16, 8, 4, "warp"), (200, 8, 9, 16, "cluster"),
    (200, 8, 9, 396, "cluster"), (200, 8, 9, 397, "block"), (200, 16, 12, 768, "block"),
    (20_000, 8, 4, 1024, "cluster"),
])
def test_mu_kernel_routes_block_range_frames_by_batch(n, l, k, batch, entry):
    """Past the warp limits and within one block, a batch takes K1's grid
    entry, except at rank 9-16 (its grid kernel holds one block a SM)
    where the grid entry would take 4 or more waves of the card's SMs;
    K2's route takes no batch and keeps its block entry."""
    assert mu_cuda.route(n, l, k, batch=batch, sms=SMS) == entry
    assert cd_cuda.route(n, l, k) == mu_cuda.route(n, l, k)


# K2's route by batch on 132 SMs: (frame, rank) -> the entry at batches
# 1, 4 and 16, and at 528 and 4,096 (4 waves or more of the grid entry's
# one block a SM).  Past the warp limits a batch takes the grid entry,
# but at ranks 9-10 in a batch of 4 waves or more of frames whose
# block-entry fits share an SM 4 at a time (2,400 x 8 does not: 135 KB)
K2_BATCH_ROUTES = {
    ((225, 8), 4): ("cluster", "cluster"), ((225, 8), 8): ("cluster", "cluster"),
    ((225, 8), 9): ("cluster", "block"), ((225, 8), 10): ("cluster", "block"),
    ((225, 8), 11): ("cluster", "cluster"), ((225, 8), 12): ("cluster", "cluster"),
    ((2400, 8), 4): ("cluster", "cluster"), ((2400, 8), 8): ("cluster", "cluster"),
    ((2400, 8), 9): ("cluster", "cluster"), ((2400, 8), 12): ("cluster", "cluster"),
    ((200, 16), 4): ("warp", "warp"), ((200, 16), 8): ("warp", "warp"),
    ((200, 16), 9): ("cluster", "block"), ((200, 16), 10): ("cluster", "block"),
    ((200, 16), 11): ("cluster", "cluster"), ((200, 16), 12): ("cluster", "cluster"),
}


@pytest.mark.parametrize("batch", [1, 4, 16, 528, 4096])
@pytest.mark.parametrize("frame, k", list(K2_BATCH_ROUTES),
                         ids=[f"{n}x{l}k{k}" for (n, l), k in K2_BATCH_ROUTES])
def test_cd_kernel_routes_block_range_frames_by_batch(frame, k, batch):
    """Given the batch and the card's SMs, K2 takes its grid entry for the
    frames past its warp limits, and keeps its block entry only where K1's
    rule (``mu_cuda.block_keeps``) and its ranks (``mu_cuda.BLOCK_KMIN`` to
    ``cd_cuda.BLOCK_KMAX``) say; left out, the batch gives the answers of
    a route without one: the block entry for every frame within one
    block."""
    n, l = frame
    small, large = K2_BATCH_ROUTES[frame, k]
    assert cd_cuda.route(n, l, k, batch=batch, sms=SMS) == (small if batch < 397 else large)
    assert cd_cuda.route(n, l, k) == ("warp" if small == "warp" else "block")


def test_cd_kernel_route_needs_the_sms_for_a_batch():
    with pytest.raises(ValueError, match="sms"):
        cd_cuda.route(2400, 8, 4, batch=1)
    # a subject's 2,400 x 8 at rank 4 in a batch of 1 or 4 spans several SMs
    for batch in (1, 4):
        assert cd_cuda.route(2400, 8, 4, batch=batch, sms=SMS) == "cluster"
    assert cd_cuda.route(20_000, 8, 4, batch=4096, sms=SMS) == "cluster"


def test_mu_kernel_route_needs_the_sms_for_a_batch():
    with pytest.raises(ValueError, match="sms"):
        mu_cuda.route(2000, 8, 4, batch=16)
    # the rule: 4 waves of fits, 4 fits' shared memory on one SM
    assert mu_cuda.block_keeps(397, SMS, 26_000)
    assert not mu_cuda.block_keeps(396, SMS, 26_000)
    assert not mu_cuda.block_keeps(1024, SMS, 60_000)


def test_mu_kernel_route_refuses_over_one_block():
    # a fit over one block's shared memory takes the cluster entry; one
    # whose H and Grams alone fill a cluster block is refused
    assert mu_cuda.route(20_000, 8, 4) == "cluster"
    with pytest.raises(ValueError, match="impl='torch'"):
        mu_cuda.route(2000, 2000, 16)
    with pytest.raises(ValueError, match="rank"):
        mu_cuda.route(200, 8, 17)


def pad_frames(x, w0, h0, n=224, l=8, k=4):
    """Zero-pad X, W and H to ``n`` rows, ``l`` columns and rank ``k``,
    as the warp entries pad a fit inside their registers."""
    b, n0, l0 = x.shape
    k0 = w0.shape[-1]
    xp, wp, hp = np.zeros((b, n, l)), np.zeros((b, n, k)), np.zeros((b, k, l))
    xp[:, :n0, :l0], wp[:, :n0, :k0], hp[:, :k0, :l0] = x, w0, h0
    return xp, wp, hp


def test_padded_mu_fit_matches_the_unpadded_jax_fit():
    """The premise of K1's warp entry: a 200 x 6 rank-2 fit zero-padded
    to 224 x 8 at rank 4 runs the same MU iterations, stops at the same
    iteration and keeps its padding exactly 0."""
    rng = np.random.default_rng(71)
    x, w0, h0 = rng.random((2, 200, 6)), rng.random((2, 200, 2)), rng.random((2, 2, 6))
    js = jbatch.fit_mu_batch(jnp.asarray(x), jnp.asarray(w0), jnp.asarray(h0),
                             max_iter=200, tol=1e-4)
    st = tbatch.fit_mu_batch(*_t(*pad_frames(x, w0, h0)), max_iter=200, tol=1e-4)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(js.n_iter))
    assert _rel(st.w[:, :200, :2], js.w) < 1e-10 and _rel(st.h[:, :2, :6], js.h) < 1e-10
    assert _rel(st.previous_error, js.previous_error) < 1e-10
    assert (st.w[:, 200:] == 0).all() and (st.w[..., 2:] == 0).all()
    assert (st.h[:, 2:] == 0).all() and (st.h[..., 6:] == 0).all()
