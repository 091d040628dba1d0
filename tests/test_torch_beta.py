"""PyTorch port: the beta-divergence MU path against the JAX package.

The port's plain versions are the beta kernel's references; here they
are held, in float64, to the JAX package's XLA solvers and to its
Pallas kernel run in interpret mode.  Tolerances: the divergence 1e-12
relative (the same sums in another order), iterates 1e-10 relative
(the kernel special-cases some powers that the port leaves to
``pow``), fits 1e-8 on the factors with equal iteration counts, and
the dataset slice 1e-8 on VAF and 1e-6 on the factors (as the
Frobenius slice in ``test_torch_dataset.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.models import batch as jbatch  # noqa: E402
from muscle_synergies_tpu.models import beta as jbeta  # noqa: E402
from muscle_synergies_tpu.models.kernels import beta_mu_iterations_pallas  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import convert  # noqa: E402
from muscle_synergies_tpu_torch.models import batch as tbatch  # noqa: E402
from muscle_synergies_tpu_torch.models import beta as tbeta  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import beta_cuda  # noqa: E402

from test_torch_dataset import FS, TRIALS  # noqa: E402
from test_torch_nmf import pad_frames  # noqa: E402

RNG = np.random.default_rng(53)
B, N, L, K = 4, 24, 4, 2
X = RNG.random((B, N, L)) + 0.05  # strictly positive: safe for beta <= 0
W0 = RNG.random((B, N, K)) + 0.1
H0 = RNG.random((B, K, L)) + 0.1
X_ZEROS = np.where(RNG.random((B, N, L)) < 0.2, 0.0, X)  # the mask path


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("square_root", [True, False])
@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0, 1.5, 3.0])
def test_beta_divergence_matches_jax(beta, square_root):
    for x in (X, X_ZEROS):
        ref = [float(jbeta.beta_divergence(jnp.asarray(x[b]), jnp.asarray(W0[b]),
                                           jnp.asarray(H0[b]), beta,
                                           square_root=square_root))
               for b in range(B)]
        got = tbeta.beta_divergence(*_t(x, W0, H0), beta, square_root=square_root)
        assert got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)
        one = tbeta.beta_divergence(*_t(x[0], W0[0], H0[0]), beta,
                                    square_root=square_root)
        assert one.ndim == 0 and abs(float(one) - ref[0]) <= 1e-12 * abs(ref[0])


# one beta per branch of the kernel's _num_den_weights and _damp
@pytest.mark.parametrize("beta", [1.0, 0.0, 0.5, -0.5, 1.5, 3.0])
def test_mu_update_beta_matches_pallas_kernel_and_xla(beta):
    jw, jh = beta_mu_iterations_pallas(jnp.asarray(X), jnp.asarray(W0),
                                       jnp.asarray(H0), 6, beta=beta,
                                       block_b=B, interpret=True)
    xw, xh = jnp.asarray(W0), jnp.asarray(H0)
    for _ in range(6):
        pairs = [jbeta.mu_update_beta(jnp.asarray(X[b]), xw[b], xh[b], beta)
                 for b in range(B)]
        xw = jnp.stack([p[0] for p in pairs])
        xh = jnp.stack([p[1] for p in pairs])
    tw, th = tbatch.beta_mu_iterations_batch(*_t(X, W0, H0), 6, beta=beta)
    assert _rel(tw, jw) < 1e-10 and _rel(th, jh) < 1e-10
    assert _rel(tw, xw) < 1e-10 and _rel(th, xh) < 1e-10


@pytest.mark.parametrize("max_iter", [200, 155])  # 155: a tail chunk
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_fit_mu_beta_batch_matches_jax(beta, max_iter):
    js = jbatch.fit_mu_beta_batch(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0),
                                  beta=beta, max_iter=max_iter, tol=1e-5,
                                  impl="xla")
    ts = tbatch.fit_mu_beta_batch(*_t(X, W0, H0), beta=beta, max_iter=max_iter,
                                  tol=1e-5)
    np.testing.assert_array_equal(ts.n_iter.numpy(), np.asarray(js.n_iter))
    np.testing.assert_array_equal(ts.converged.numpy(), np.asarray(js.converged))
    assert _rel(ts.w, js.w) < 1e-8 and _rel(ts.h, js.h) < 1e-8
    assert _rel(ts.previous_error, js.previous_error) < 1e-10
    conv = convert.beta_state(js)
    assert isinstance(conv, tbeta.BetaState) and conv.converged.dtype == torch.bool
    np.testing.assert_array_equal(conv.n_iter.numpy(), ts.n_iter.numpy())
    if max_iter == 155:
        assert (ts.n_iter[~ts.converged] == 155).all()


def test_penalized_single_problem_fit_matches_jax():
    regs = dict(l1_reg_w=0.05, l2_reg_w=0.1, l1_reg_h=0.2, l2_reg_h=0.3)
    js = jbeta.fit_mu_beta(jnp.asarray(X[0]), jnp.asarray(W0[0]), jnp.asarray(H0[0]),
                           beta=1.5, max_iter=120, tol=1e-5, **regs)
    ts = tbeta.fit_mu_beta(*_t(X[0], W0[0], H0[0]), beta=1.5, max_iter=120,
                           tol=1e-5, **regs)
    assert int(ts.n_iter) == int(js.n_iter) and ts.w.shape == (N, K)
    assert _rel(ts.w, js.w) < 1e-8 and _rel(ts.h, js.h) < 1e-8


# one case per kernel kind: KL, Itakura-Saito, and beta at run time
@pytest.mark.parametrize("beta", [1.0, 0.0, 1.5])
def test_penalized_batch_fits_match_jax(beta):
    regs = dict(l1_reg_w=0.05, l2_reg_w=0.1, l1_reg_h=0.2, l2_reg_h=0.3)
    js = jbatch.fit_mu_beta_batch(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0),
                                  beta=beta, max_iter=150, tol=1e-5, impl="xla",
                                  **regs)
    ts = tbatch.fit_mu_beta_batch(*_t(X, W0, H0), beta=beta, max_iter=150,
                                  tol=1e-5, impl="auto", **regs)
    np.testing.assert_array_equal(ts.n_iter.numpy(), np.asarray(js.n_iter))
    np.testing.assert_array_equal(ts.converged.numpy(), np.asarray(js.converged))
    assert _rel(ts.w, js.w) < 1e-8 and _rel(ts.h, js.h) < 1e-8
    # the kernel's plain version takes the penalties the kernel takes
    ps = beta_cuda.fit_beta_plain(*_t(X, W0, H0), beta=beta, max_iter=150,
                                  tol=1e-5, **regs)
    assert all(torch.equal(a, b) for a, b in zip(ps, ts))


def test_zero_padded_rank_components_stay_zero():
    w0, h0 = W0.copy(), H0.copy()
    w0[..., 1:] = 0.0
    h0[:, 1:] = 0.0
    for beta in (1.0, 0.0, 1.5):
        st = tbatch.fit_mu_beta_batch(*_t(X, w0, h0), beta=beta, max_iter=60)
        assert (st.w[..., 1:] == 0).all() and (st.h[:, 1:] == 0).all()
        ref = tbatch.fit_mu_beta_batch(*_t(X, w0[..., :1], h0[:, :1]), beta=beta,
                                       max_iter=60)
        np.testing.assert_array_equal(st.n_iter.numpy(), ref.n_iter.numpy())
        assert _rel(st.w[..., :1], ref.w) < 1e-12


@pytest.fixture(scope="module")
def kl_slice():
    kw = dict(ranks=(1, 2, 3), solver="mu", beta_loss="kullback-leibler",
              max_iter=500, tol=1e-4)
    jres = mst.analyze_dataset(TRIALS, FS, **kw)
    tres = mt.analyze_dataset(TRIALS, FS, device="cpu", dtype=torch.float64, **kw)
    return jres, tres


def test_kl_slice_vaf_and_factors_match_jax(kl_slice):
    jres, tres = kl_slice
    assert tres.w.shape == jres.w.shape == (3, 6, 200, 3)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.vaf_per_channel, jres.vaf_per_channel,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.w, jres.w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.h, jres.h, rtol=0, atol=1e-6)


def test_kl_slice_iterations_and_convergence_match_jax(kl_slice):
    jres, tres = kl_slice
    np.testing.assert_array_equal(tres.n_iter, jres.n_iter)
    np.testing.assert_array_equal(tres.converged, jres.converged)
    assert (tres.n_iter > 0).all()


def test_float_beta_slice_matches_jax():
    kw = dict(ranks=(2,), solver="mu", beta_loss=1.5, max_iter=300, tol=1e-4)
    jres = mst.analyze_dataset(TRIALS[:3], FS, **kw)
    tres = mt.analyze_dataset(TRIALS[:3], FS, device="cpu", **kw)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tres.n_iter, jres.n_iter)


def test_beta_refusals():
    with pytest.raises(ValueError, match="requires solver='mu'"):
        mt.analyze_dataset(TRIALS[:2], FS, solver="cd",
                           beta_loss="kullback-leibler", device="cpu")
    with pytest.raises(ValueError, match="inner_iter"):
        mt.analyze_dataset(TRIALS[:2], FS, solver="mu", inner_iter=2,
                           beta_loss="kullback-leibler", device="cpu")
    with pytest.raises(ValueError, match="Invalid beta_loss"):
        mt.analyze_dataset(TRIALS[:2], FS, solver="mu", beta_loss="hinge",
                           device="cpu")
    silent = [t.copy() for t in TRIALS[:2]]
    silent[1][:, 3] = 0.0  # a silent channel: exact zeros after preprocessing
    for loss in ("itakura-saito", -0.5):
        with pytest.raises(ValueError, match="beta_loss <= 0 and X contains zeros"):
            mt.analyze_dataset(silent, FS, solver="mu", beta_loss=loss,
                               device="cpu")
    jres = mst.analyze_dataset(silent, FS, ranks=(2,), solver="mu",
                               beta_loss="kullback-leibler", max_iter=100)
    tres = mt.analyze_dataset(silent, FS, ranks=(2,), solver="mu",
                              beta_loss="kullback-leibler", max_iter=100,
                              device="cpu")
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)


def test_kernel_wrapper_plain_versions_and_refusals():
    x, w, h = _t(X, W0, H0)
    pw, ph = beta_cuda.beta_iterations_plain(x, w, h, 4, beta=0.5)
    bw, bh = tbatch.beta_mu_iterations_batch(x, w, h, 4, beta=0.5, impl="auto")
    assert torch.equal(pw, bw) and torch.equal(ph, bh)
    st = beta_cuda.fit_beta_plain(x, w, h, beta=0.0, max_iter=30)
    assert torch.equal(st.w, tbatch.fit_mu_beta_batch(x, w, h, beta=0.0,
                                                      max_iter=30).w)
    with pytest.raises(ValueError, match="CUDA"):
        tbatch.fit_mu_beta_batch(x, w, h, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        beta_cuda.beta_iterations_cuda(x, w, h, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tbatch.fit_mu_beta_batch(x, w, h, impl="cuda", l1_reg_w=0.1)
    with pytest.raises(ValueError, match="impl"):
        tbatch.beta_mu_iterations_batch(x, w, h, 2, impl="pallas")
    # csrc/beta_nmf.cu's layout: the MU block plus two weight planes,
    # W^T (weights), and 33 doubles at an 8-byte boundary
    assert beta_cuda.smem_bytes(200, 8, 4) == 4 * (2913 + 2 * 200 * 9 + 64 + 1 + 66)
    assert beta_cuda.smem_bytes(200, 8, 4) < 48 * 1024
    assert beta_cuda.smem_bytes(2000, 64, 16) > 227 * 1024


def test_beta_loss_names():
    assert tbeta.beta_loss_to_float("itakura-saito") == 0.0
    assert tbeta.beta_loss_to_float(2) == 2.0
    assert [tbeta._gamma(b) for b in (0.0, 1.5, 3.0)] == [0.5, 1.0, 0.5]
    assert tbeta.F64_EPS == jbeta.F64_EPS


@pytest.mark.parametrize("k", range(1, 9))
def test_beta_kernel_takes_the_warp_entry_at_200x8(k):
    """Every rank of a 1-8 KL sweep on a time-normalised frame fits K4's
    warp entry, Itakura-Saito ranks 1-4; a run-time beta keeps the block
    entry."""
    assert beta_cuda.route(200, 8, k) == "warp"
    is_entry = "warp" if k <= beta_cuda.IS_WARP_KMAX else "block"
    assert beta_cuda.route(200, 8, k, beta=0.0) == is_entry
    assert beta_cuda.route(200, 8, k, beta=1.5) == "block"


@pytest.mark.parametrize("n, l, k, beta, entry", [
    (224, 16, 8, 1.0, "warp"), (225, 8, 4, 1.0, "block"), (200, 17, 4, 1.0, "block"),
    (200, 8, 9, 1.0, "block"), (2000, 8, 4, 1.0, "block"), (200, 8, 4, -0.5, "block"),
    (224, 8, 4, 0.0, "warp"), (200, 9, 4, 0.0, "block"), (200, 8, 5, 0.0, "block"),
    (200, 8, 4, 1.5, "block"),
])
def test_beta_kernel_routes_around_the_warp_limits(n, l, k, beta, entry):
    """Above the warp limits (for IS, above 8 columns or rank 4), for a
    run-time beta, and for beta < 0 (where a padded entry's weight
    0 * eps^(beta - 2) would overflow to NaN), the block entry."""
    assert (beta_cuda.IS_WARP_LMAX, beta_cuda.IS_WARP_KMAX) == (8, 4)
    assert beta_cuda.route(n, l, k, beta) == entry


SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("n, l, k, beta, batch, entry", [
    (200, 8, 4, 1.5, 16, "cluster"), (200, 8, 4, 1.5, 264, "cluster"),
    (200, 8, 4, 1.5, 396, "cluster"), (200, 8, 4, 1.5, 397, "block"),
    (200, 8, 4, 1.5, 1024, "block"), (200, 8, 4, -0.5, 16, "cluster"),
    (200, 8, 4, -0.5, 1024, "block"), (200, 8, 6, 0.0, 132, "cluster"),
    (200, 8, 6, 0.0, 528, "block"), (300, 8, 4, 1.0, 1024, "block"),
    (300, 8, 4, 1.0, 4, "cluster"), (600, 8, 4, 1.5, 1024, "cluster"),
    (2000, 8, 4, 1.0, 4, "cluster"), (2000, 8, 4, 1.0, 1024, "cluster"),
    (200, 8, 4, 1.0, 1024, "warp"), (2000, 8, 4, 1.5, 1024, "cluster"),
])
def test_beta_kernel_routes_block_range_frames_by_batch(n, l, k, beta, batch, entry):
    """Past the warp limits and within one block, a batch takes K4's grid
    entry unless it would take 4 or more waves of the card's SMs there
    (one block a SM) and 4 of its fits share one SM on the block entry."""
    assert beta_cuda.route(n, l, k, beta, batch=batch, sms=SMS) == entry


def test_beta_kernel_route_refuses_over_one_block():
    """Over one block's shared memory a fit takes K4's cluster entry; only
    a frame whose small state fills a cluster block is refused (the whole
    table: tests/test_torch_cluster_beta_cnmf.py)."""
    assert beta_cuda.route(20_000, 8, 4) == "cluster"
    # KL's block entry stores no denominator plane: 2,000 x 8 fits one
    # block for KL, not for the kinds that need both weight planes
    assert beta_cuda.smem_bytes(2000, 8, 4, kl=True) <= 227 * 1024
    assert beta_cuda.route(2000, 8, 4, beta=1.0) == "block"
    assert beta_cuda.route(2000, 8, 4, beta=1.5) == "cluster"
    with pytest.raises(ValueError, match="impl='torch'"):
        beta_cuda.route(20_000, 2000, 16, beta=1.5)
    with pytest.raises(ValueError, match="rank"):
        beta_cuda.route(200, 8, 17)


PAD_RNG = np.random.default_rng(73)
PAD_X = PAD_RNG.random((2, 200, 6)) + 0.05
PAD_W0 = PAD_RNG.random((2, 200, 2)) + 0.1
PAD_H0 = PAD_RNG.random((2, 2, 6)) + 0.1


# KL, the kind of K4's warp entry on the main path, and run-time betas > 0,
# whose padding is exact too (they run on the block entry; IS is below)
@pytest.mark.parametrize("beta", [1.0, 0.5, 1.5, 3.0])
def test_padded_beta_fit_matches_the_unpadded_jax_fit(beta):
    """The premise of K4's warp entry: a 200 x 6 rank-2 fit zero-padded
    to 224 x 8 at rank 4 runs the same iterations, stops at the same
    iteration and keeps its padding exactly 0."""
    js = jbatch.fit_mu_beta_batch(jnp.asarray(PAD_X), jnp.asarray(PAD_W0),
                                  jnp.asarray(PAD_H0), beta=beta, max_iter=200,
                                  tol=1e-4)
    st = tbatch.fit_mu_beta_batch(*_t(*pad_frames(PAD_X, PAD_W0, PAD_H0)), beta=beta,
                                  max_iter=200, tol=1e-4)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(js.n_iter))
    assert _rel(st.w[:, :200, :2], js.w) < 1e-10 and _rel(st.h[:, :2, :6], js.h) < 1e-10
    assert (st.w[:, 200:] == 0).all() and (st.w[..., 2:] == 0).all()
    assert (st.h[:, 2:] == 0).all() and (st.h[..., 6:] == 0).all()


def test_padded_is_iterations_match_and_its_divergence_needs_the_mask():
    """Itakura-Saito: the padded updates are exact (fixed iterations match
    the unpadded JAX fit), but sklearn's IS constant counts every entry,
    so the padded frame's divergence falls short of the real one by the
    count of padded entries; K4's warp entry sums only real entries."""
    js = jbatch.fit_mu_beta_batch(jnp.asarray(PAD_X), jnp.asarray(PAD_W0),
                                  jnp.asarray(PAD_H0), beta=0.0, max_iter=60, tol=0.0)
    padded = _t(*pad_frames(PAD_X, PAD_W0, PAD_H0))
    st = tbatch.fit_mu_beta_batch(*padded, beta=0.0, max_iter=60, tol=0.0)
    assert (st.n_iter == 60).all()
    assert _rel(st.w[:, :200, :2], js.w) < 1e-10 and _rel(st.h[:, :2, :6], js.h) < 1e-10
    assert (st.w[:, 200:] == 0).all() and (st.h[:, 2:] == 0).all()
    real = tbeta.beta_divergence(*_t(PAD_X, PAD_W0, PAD_H0), 0.0, square_root=False)
    pad = tbeta.beta_divergence(*padded, 0.0, square_root=False)
    n_pad = 224 * 8 - 200 * 6
    np.testing.assert_allclose((real - pad).numpy(), n_pad, rtol=1e-10)
