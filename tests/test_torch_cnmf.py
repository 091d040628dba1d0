"""PyTorch port: convolutive NMF and the time-varying slice against JAX.

The port's plain versions are the convolutive kernel's references;
here they are held, in float64, to the JAX package's XLA solver and to
its Pallas kernel run in interpret mode.  Tolerances: iterates 1e-10
relative (the same contractions summed in another order), fits 1e-8 on
the factors with equal iteration counts and flags, the restart init bit
for bit, and the dataset slice 1e-8 on VAF and 1e-6 on the factors (as
the Frobenius slice in ``test_torch_dataset.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import no_leftover_group  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.models import cnmf as jcnmf  # noqa: E402
from muscle_synergies_tpu.models.kernels.cnmf_pallas import cnmf_iterations_pallas  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import convert  # noqa: E402
from muscle_synergies_tpu_torch.models import cnmf as tcnmf  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda  # noqa: E402

from test_torch_dataset import FS, TRIALS  # noqa: E402

B, T, L, K, D = 4, 40, 4, 2, 3


def _problem(seed=61):
    """Data from a known convolutive model plus noise, and a scaled init."""
    rng = np.random.default_rng(seed)
    c = rng.random((B, T, K)) ** 3
    s = rng.random((B, K, D, L))
    x = np.stack([np.asarray(jcnmf.cnmf_reconstruct(jnp.asarray(c[b]), jnp.asarray(s[b])))
                  for b in range(B)]) + 0.05 * rng.random((B, T, L))
    c0, s0 = jcnmf.init_cnmf(x, K, D, seed=seed)
    return x, c0, s0


X, C0, S0 = _problem()


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_reconstruct_and_shifts_match_jax():
    ref = [np.asarray(jcnmf.cnmf_reconstruct(jnp.asarray(C0[b]), jnp.asarray(S0[b])))
           for b in range(B)]
    got = tcnmf.cnmf_reconstruct(*_t(C0, S0))
    assert got.shape == (B, T, L)
    assert _rel(got, np.stack(ref)) < 1e-12
    c = torch.as_tensor(C0[0])
    for d in (0, 2, T):
        np.testing.assert_array_equal(tcnmf._shift_down(c, d).numpy(),
                                      np.asarray(jcnmf._shift_down(jnp.asarray(C0[0]), d)))
        np.testing.assert_array_equal(tcnmf._shift_up(c, d).numpy(),
                                      np.asarray(jcnmf._shift_up(jnp.asarray(C0[0]), d)))


def test_cnmf_update_matches_pallas_kernel_and_xla():
    jc, js = cnmf_iterations_pallas(jnp.asarray(X), jnp.asarray(C0), jnp.asarray(S0),
                                    5, block_b=B, interpret=True)
    xc, xs = jcnmf.cnmf_iterations_batch(jnp.asarray(X), jnp.asarray(C0),
                                         jnp.asarray(S0), 5)
    tc, ts = tcnmf.cnmf_iterations_batch(*_t(X, C0, S0), 5)
    assert _rel(tc, jc) < 1e-10 and _rel(ts, js) < 1e-10
    assert _rel(tc, xc) < 1e-10 and _rel(ts, xs) < 1e-10
    pc, ps = cnmf_cuda.cnmf_iterations_plain(*_t(X, C0, S0), 5)
    assert torch.equal(pc, tc) and torch.equal(ps, ts)


# max_iter 95 at tol 1e-7: no fit converges, and the count overshoots to
# 100; max_iter 60 with checks every 7 overshoots to 63
@pytest.mark.parametrize("max_iter, tol, check_every",
                         [(1000, 1e-4, 10), (95, 1e-7, 10), (60, 1e-9, 7)])
def test_fit_cnmf_batch_matches_jax(max_iter, tol, check_every):
    js = jcnmf.fit_cnmf_batch(jnp.asarray(X), jnp.asarray(C0), jnp.asarray(S0),
                              max_iter=max_iter, tol=tol,
                              check_every=check_every, impl="xla")
    ts = tcnmf.fit_cnmf_batch(*_t(X, C0, S0), max_iter=max_iter, tol=tol,
                              check_every=check_every)
    np.testing.assert_array_equal(ts.n_iter.numpy(), np.asarray(js.n_iter))
    np.testing.assert_array_equal(ts.converged.numpy(), np.asarray(js.converged))
    assert _rel(ts.c, js.c) < 1e-8 and _rel(ts.s, js.s) < 1e-8
    assert _rel(ts.previous_error, js.previous_error) < 1e-10
    if max_iter < 100:
        overshoot = -(-max_iter // check_every) * check_every
        assert (ts.n_iter == overshoot).all() and not ts.converged.any()
    else:
        assert ts.converged.all() and (ts.n_iter < max_iter).all()
    conv = convert.cnmf_state(js)
    assert isinstance(conv, tcnmf.CNMFState) and conv.s.shape == (B, K, D, L)
    np.testing.assert_array_equal(conv.n_iter.numpy(), ts.n_iter.numpy())


def test_single_problem_fit_matches_jax():
    js = jcnmf.fit_cnmf(jnp.asarray(X[1]), jnp.asarray(C0[1]), jnp.asarray(S0[1]),
                        max_iter=200, tol=1e-5)
    ts = tcnmf.fit_cnmf(*_t(X[1], C0[1], S0[1]), max_iter=200, tol=1e-5)
    assert int(ts.n_iter) == int(js.n_iter) and ts.c.shape == (T, K)
    assert _rel(ts.c, js.c) < 1e-8 and _rel(ts.s, js.s) < 1e-8


def test_init_cnmf_matches_jax_bit_for_bit():
    for x in (X, X[0], X.astype(np.float32)):
        jc, js = jcnmf.init_cnmf(x, 3, 5, seed=7)
        tc, ts = tcnmf.init_cnmf(x, 3, 5, seed=7)
        assert tc.dtype == jc.dtype == x.dtype
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts, js)


def test_normalize_synergies_matches_jax():
    s = S0.copy()
    s[1, 0] = 0.0  # a zero synergy stays as it is
    jc, js = jcnmf.normalize_synergies(jnp.asarray(C0), jnp.asarray(s))
    tc, ts = tcnmf.normalize_synergies(*_t(C0, s))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-12, atol=0)
    jc1, js1 = jcnmf.normalize_synergies(jnp.asarray(C0[0]), jnp.asarray(s[0]))
    tc1, ts1 = tcnmf.normalize_synergies(*_t(C0[0], s[0]))
    np.testing.assert_allclose(tc1.numpy(), np.asarray(jc1), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), rtol=1e-12, atol=0)


TV = dict(n_synergies=2, n_lags=5, n_inits=2, max_iter=500, tol=1e-4)


@pytest.fixture(scope="module")
def tv_slice():
    jres = mst.analyze_dataset_time_varying(TRIALS, FS, **TV)
    tres = mt.analyze_dataset_time_varying(TRIALS, FS, device="cpu",
                                           dtype=torch.float64, **TV)
    return jres, tres


def test_time_varying_slice_vaf_and_factors_match_jax(tv_slice):
    jres, tres = tv_slice
    assert tres.c.shape == jres.c.shape == (6, 200, 2)
    assert tres.s.shape == jres.s.shape == (6, 2, 5, 8)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.vaf_per_channel, jres.vaf_per_channel,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.c, jres.c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.s, jres.s, rtol=0, atol=1e-6)


def test_time_varying_slice_restarts_and_stops_match_jax(tv_slice):
    jres, tres = tv_slice
    np.testing.assert_array_equal(np.argmin(tres.restart_errors, axis=1),
                                  np.argmin(jres.restart_errors, axis=1))
    np.testing.assert_allclose(tres.restart_errors, jres.restart_errors,
                               rtol=1e-8, atol=0)
    np.testing.assert_array_equal(tres.n_iter, jres.n_iter)
    np.testing.assert_array_equal(tres.converged, jres.converged)
    assert tres.n_lags == 5


def test_time_varying_tables_match_jax():
    mapping = {"s1": TRIALS[:2], "s2": TRIALS[2:3]}
    kw = dict(n_synergies=2, n_lags=4, n_inits=2, max_iter=200, tol=1e-4)
    jres = mst.analyze_dataset_time_varying(mapping, FS, **kw)
    tres = mt.analyze_dataset_time_varying(mapping, FS, device="cpu", **kw)
    assert tres.subjects == jres.subjects == ["s1", "s1", "s2"]
    np.testing.assert_allclose(tres.subject_table().to_numpy(),
                               jres.subject_table().to_numpy(), rtol=0, atol=1e-8)
    assert list(tres.vaf_table().index) == list(jres.vaf_table().index)
    np.testing.assert_allclose(tres.synergies(1)[0].to_numpy(),
                               jres.synergies(1)[0].to_numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.activations(2).to_numpy(),
                               jres.activations(2).to_numpy(), rtol=0, atol=1e-6)
    one, jone = tres.to_trial_result(0), jres.to_trial_result(0)
    assert isinstance(one, tcnmf.TimeVaryingSynergyResult)
    assert one.n_iter == jone.n_iter and abs(one.vaf - jone.vaf) < 1e-8
    assert list(one.vaf_per_muscle.index) == list(jone.vaf_per_muscle.index)
    unlabeled = mt.analyze_dataset_time_varying(TRIALS[:1], FS, device="cpu", **kw)
    with pytest.raises(ValueError, match="subject"):
        unlabeled.subject_table()


def test_time_varying_refusals():
    kw = dict(n_synergies=2, n_lags=5, device="cpu")
    # a mesh without the (data, time) axes is refused with a warning, and
    # the fit runs locally
    mesh = mt.parallel.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.warns(UserWarning, match=r"lacks the \['time'\] axis"):
        mt.analyze_dataset_time_varying(TRIALS[:2], FS, mesh=mesh, max_iter=10, **kw)
    with pytest.raises(ValueError, match="n_lags"):
        mt.analyze_dataset_time_varying(TRIALS[:2], FS, n_synergies=2, n_lags=201,
                                        device="cpu")
    with pytest.raises(ValueError, match="n_synergies"):
        mt.analyze_dataset_time_varying(TRIALS[:2], FS, n_synergies=0, n_lags=5,
                                        device="cpu")
    with pytest.raises(ValueError, match="n_inits"):
        mt.analyze_dataset_time_varying(TRIALS[:2], FS, n_inits=0, **kw)
    res = mt.analyze_dataset_time_varying(TRIALS[:1], FS, max_iter=20, **kw)
    assert res.c.shape == (1, 200, 2)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.analyze_dataset(TRIALS[:2], FS, ranks=(1,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.preprocess_trials(TRIALS[:2], FS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.analyze_dataset_time_varying(TRIALS[:2], FS, n_synergies=2, n_lags=5)


def test_kernel_wrapper_refusals_and_bounds():
    x, c, s = _t(X, C0, S0)
    with pytest.raises(ValueError, match="CUDA"):
        tcnmf.fit_cnmf_batch(x, c, s, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        cnmf_cuda.cnmf_iterations_cuda(x, c, s, 2)
    with pytest.raises(ValueError, match="impl"):
        tcnmf.cnmf_iterations_batch(x, c, s, 2, impl="pallas")
    st = cnmf_cuda.fit_cnmf_plain(x, c, s, max_iter=30)
    assert torch.equal(st.c, tcnmf.fit_cnmf_batch(x, c, s, max_iter=30).c)
    # csrc/cnmf.cu's layout: X and X^ (T, 8), C^T (4, T), S (4, 10, 8),
    # the S update's partial sums of 2 of its 3 time slices (16 floats
    # per lag pair), 33 doubles
    assert cnmf_cuda.smem_bytes(200, 8, 4, 10) == 4 * (3200 + 800 + 320 + 1280 + 66)
    # at most 28 KB: 8 blocks of the time-varying path on one SM
    assert cnmf_cuda.smem_bytes(200, 8, 4, 10) <= 227 * 1024 // 8
    assert cnmf_cuda.smem_bytes(4000, 16, 8, 20) > 227 * 1024


@pytest.mark.parametrize("shape, floats", [
    ((200, 16, 8, 200), 2 * 200 * 16 + 1600 + 1600 * 16),  # one time slice
    ((37, 1, 1, 1), 2 * 37 * 8 + 40 + 8 + 16 * 3),  # L padded to 8, C^T to 4
    ((200, 12, 2, 16), 2 * 200 * 16 + 400 + 32 * 16 + 16 * 3 * 32),
])
def test_kernel_shared_memory_layout(shape, floats):
    """cnmf_cuda.smem_bytes mirrors csrc/cnmf.cu's cnmf_smem_floats."""
    assert cnmf_cuda.smem_bytes(*shape) == 4 * (floats + 66)


def test_kernel_refusal_threshold():
    """The wrapper refuses a fit over one block's 227 KB: at L = 8, K = 4,
    D = 10 the longest trial is 2,822 samples."""
    assert cnmf_cuda.smem_bytes(2822, 8, 4, 10) <= cnmf_cuda.SMEM_LIMIT
    assert cnmf_cuda.smem_bytes(2823, 8, 4, 10) > cnmf_cuda.SMEM_LIMIT
