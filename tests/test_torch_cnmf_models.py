"""PyTorch port: the convolutive model surface against the JAX package.

Held in float64 on the CPU to ``muscle_synergies_tpu.models.cnmf``:

- the solvers take the JAX package's parameters in its order
  (``update_c``/``update_s`` before ``precision`` and ``impl``), so a
  positional call binds the same arguments, and a frozen factor comes
  back bit for bit; the kernel route refuses a frozen factor before any
  launch, as the JAX package's Pallas route does;
- :func:`tvaf`, :func:`cnmf_transform` (its default activations drawn as
  the JAX package draws them), :func:`find_time_varying_synergies` and
  :class:`CNMFModel`: iteration counts equal, factors within 1e-8
  relative (1e-6 absolute after normalization), VAF within 1e-8, the
  finder's DataFrames equal, and the refusals raising what the JAX
  package raises.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.models import cnmf as jcnmf  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch.models import cnmf as tcnmf  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda  # noqa: E402

B, T, L, K, D = 3, 40, 5, 2, 4
CPU = dict(device="cpu")


def _problem(seed=80):
    """Data from a known convolutive model plus noise (NumPy: this runs
    when every test worker imports the file), and the JAX init."""
    rng = np.random.default_rng(seed)
    c = rng.random((B, T, K)) ** 3
    s = rng.random((B, K, D, L))
    x = 0.05 * rng.random((B, T, L))
    for d in range(D):  # X[t] += sum_k C[t - d, k] S[k, d]
        x[:, d:] += np.einsum("btk,bkl->btl", c[:, :T - d], s[:, :, d])
    c0, s0 = jcnmf.init_cnmf(x, K, D, seed=seed)
    return x, c0, s0


X, C0, S0 = _problem()
FRAME = pd.DataFrame(X[0], columns=[f"m{i}" for i in range(L)],
                     index=pd.RangeIndex(100, 100 + T))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("update_c, update_s", [(True, False), (False, True)])
def test_positional_calls_bind_the_jax_parameters(update_c, update_s):
    """``cnmf_update(x, c, s, update_c, update_s)`` and the fits with the
    JAX package's positional order: a frozen factor is returned bit for
    bit and the other matches the JAX package's."""
    jc, js = jcnmf.cnmf_update(jnp.asarray(X[0]), jnp.asarray(C0[0]), jnp.asarray(S0[0]),
                               update_c, update_s)
    tc, ts = tcnmf.cnmf_update(*_t(X[0], C0[0], S0[0]), update_c, update_s)
    assert _rel(tc, jc) < 1e-12 and _rel(ts, js) < 1e-12
    frozen, given = (tc, C0[0]) if not update_c else (ts, S0[0])
    np.testing.assert_array_equal(frozen.numpy(), given)

    js = jcnmf.fit_cnmf(jnp.asarray(X[1]), jnp.asarray(C0[1]), jnp.asarray(S0[1]),
                        100, 1e-4, 10, update_c, update_s)
    ts = tcnmf.fit_cnmf(*_t(X[1], C0[1], S0[1]), 100, 1e-4, 10, update_c, update_s)
    assert int(ts.n_iter) == int(js.n_iter) and bool(ts.converged) == bool(js.converged)
    assert _rel(ts.c, js.c) < 1e-8 and _rel(ts.s, js.s) < 1e-8

    jb = jcnmf.fit_cnmf_batch(X, C0, S0, 100, 1e-4, 10, update_c, update_s, "xla")
    tb = tcnmf.fit_cnmf_batch(*_t(X, C0, S0), 100, 1e-4, 10, update_c, update_s, "torch")
    np.testing.assert_array_equal(tb.n_iter.numpy(), np.asarray(jb.n_iter))
    assert _rel(tb.c, jb.c) < 1e-8 and _rel(tb.s, jb.s) < 1e-8
    frozen, given = (tb.c, C0) if not update_c else (tb.s, S0)
    np.testing.assert_array_equal(frozen.numpy(), given)


def test_frozen_activation_iterations_match_jax():
    jc, js = jcnmf.cnmf_iterations_batch(jnp.asarray(X), jnp.asarray(C0), jnp.asarray(S0),
                                         5, False, "xla")
    tc, ts = tcnmf.cnmf_iterations_batch(*_t(X, C0, S0), 5, False, "torch")
    np.testing.assert_array_equal(tc.numpy(), C0)
    assert _rel(ts, js) < 1e-10
    pc, ps = cnmf_cuda.cnmf_iterations_plain(*_t(X, C0, S0), 5)
    fc, fs = tcnmf.cnmf_iterations_batch(*_t(X, C0, S0), 5)
    assert torch.equal(pc, fc) and torch.equal(ps, fs)


def test_both_factors_frozen_is_refused():
    with pytest.raises(ValueError, match="cannot both be False"):
        jcnmf.fit_cnmf(jnp.asarray(X[0]), jnp.asarray(C0[0]), jnp.asarray(S0[0]),
                       update_c=False, update_s=False)
    with pytest.raises(ValueError, match="cannot both be False"):
        tcnmf.fit_cnmf(*_t(X[0], C0[0], S0[0]), update_c=False, update_s=False)


@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_kernel_route_refuses_frozen_factors_before_any_launch(impl, monkeypatch):
    """K5 always updates both factors: on its route a frozen factor
    raises, naming impl='torch', before anything reaches the card (the
    wrapper's entry points are replaced by failures here)."""
    def never(*args, **kwargs):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(cnmf_cuda, "fit_cnmf_cuda", never)
    monkeypatch.setattr(cnmf_cuda, "cnmf_iterations_cuda", never)
    x, c, s = _t(X, C0, S0)
    if impl == "auto":  # what 'auto' resolves to for a CUDA float32 batch
        monkeypatch.setattr(tcnmf, "resolve_impl", lambda impl_, xs: "cuda")
    for frozen in (dict(update_c=False), dict(update_s=False)):
        with pytest.raises(ValueError, match="impl='torch'"):
            tcnmf.fit_cnmf_batch(x, c, s, max_iter=20, impl=impl, **frozen)
    with pytest.raises(ValueError, match="impl='torch'"):
        tcnmf.cnmf_iterations_batch(x, c, s, 2, update_c=False, impl=impl)


def test_tvaf_matches_jax():
    got = tcnmf.tvaf(*_t(X, C0, S0))
    want = jcnmf.tvaf(jnp.asarray(X), jnp.asarray(C0), jnp.asarray(S0))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    one = tcnmf.tvaf(*_t(X[0], C0[0], S0[0]))
    np.testing.assert_allclose(float(one), float(np.asarray(want)[0]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True])
def test_transform_draws_and_solves_as_jax(batched):
    """The default activations are the JAX package's draws (one for a
    2-D x, ``fold_in(key, b)`` per trial) at init_cnmf's scale; then the
    fit with S frozen stops where the JAX package's stops."""
    x = X if batched else X[0]
    s = S0[0]
    stop = dict(max_iter=FIND["max_iter"], tol=FIND["tol"])  # the model's stop
    jst = jcnmf.cnmf_transform(jnp.asarray(x), jnp.asarray(s), seed=4, **stop)
    tst = tcnmf.cnmf_transform(*_t(x, s), seed=4, **stop)
    np.testing.assert_array_equal(tst.n_iter.numpy(), np.asarray(jst.n_iter))
    assert _rel(tst.c, jst.c) < 1e-8
    np.testing.assert_array_equal(tst.s.numpy(), np.broadcast_to(s, tst.s.shape))
    j0 = jcnmf._init_c_on_device(jnp.asarray(x), K, D, 4)
    t0 = tcnmf._init_c(torch.as_tensor(x), K, D, 4)
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=1e-14, atol=0)


def test_transform_takes_c0_and_a_generator():
    c0 = C0[:, :, :K]
    jst = jcnmf.cnmf_transform(jnp.asarray(X), jnp.asarray(S0), c0=jnp.asarray(c0),
                               max_iter=60)
    tst = tcnmf.cnmf_transform(*_t(X, S0), c0=torch.as_tensor(c0), max_iter=60)
    np.testing.assert_array_equal(tst.n_iter.numpy(), np.asarray(jst.n_iter))
    assert _rel(tst.c, jst.c) < 1e-8
    g = tcnmf._init_c(torch.as_tensor(X), K, D, 0, torch.Generator().manual_seed(1))
    again = tcnmf._init_c(torch.as_tensor(X), K, D, 0, torch.Generator().manual_seed(1))
    assert torch.equal(g, again) and not torch.equal(g, tcnmf._init_c(torch.as_tensor(X),
                                                                       K, D, 0))


FIND = dict(max_iter=120, tol=1e-5, n_inits=3, seed=2)


@pytest.fixture(scope="module")
def found():
    jres = jcnmf.find_time_varying_synergies(FRAME, K, D, **FIND)
    tres = tcnmf.find_time_varying_synergies(FRAME, K, D, dtype=torch.float64, **CPU,
                                             **FIND)
    return jres, tres


def test_finder_matches_jax(found):
    jres, tres = found
    assert tres.n_iter == jres.n_iter
    np.testing.assert_allclose(tres.restart_errors, jres.restart_errors, rtol=1e-8)
    assert abs(tres.vaf - jres.vaf) < 1e-8
    pd.testing.assert_series_equal(tres.vaf_per_muscle, jres.vaf_per_muscle, rtol=0,
                                   atol=1e-8)
    pd.testing.assert_frame_equal(tres.activations, jres.activations, rtol=0, atol=1e-6)
    assert list(tres.synergies) == list(jres.synergies)
    for k in jres.synergies:
        pd.testing.assert_frame_equal(tres.synergies[k], jres.synergies[k], rtol=0,
                                      atol=1e-6)
    assert mt.find_time_varying_synergies is tcnmf.find_time_varying_synergies
    plain = tcnmf.find_time_varying_synergies(X[0], K, D, **CPU, **FIND)
    assert list(plain.activations.index) == list(range(T))
    np.testing.assert_array_equal(plain.activations.to_numpy(),
                                  tres.activations.to_numpy())


def test_model_fits_transforms_and_inverts_as_jax(found):
    jres, tres = found
    kw = dict(max_iter=FIND["max_iter"], tol=FIND["tol"], n_inits=FIND["n_inits"],
              random_state=FIND["seed"])
    jm, tm = jcnmf.CNMFModel(K, D, **kw), tcnmf.CNMFModel(K, D, **CPU, **kw)
    jc, tc = jm.fit_transform(FRAME), tm.fit_transform(FRAME)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.synergies_, jm.synergies_, rtol=0, atol=1e-6)
    assert tm.n_iter_ == jm.n_iter_ and tm.n_components_ == K and tm.n_lags_ == D
    assert abs(tm.reconstruction_err_ - jm.reconstruction_err_) < 1e-8
    np.testing.assert_array_equal(tm.synergies_, np.stack(
        [tres.synergies[k].to_numpy() for k in range(K)]))
    np.testing.assert_allclose(tm.transform(X[::-1]), jm.transform(X[::-1]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tm.transform(X[2]), jm.transform(X[2]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.inverse_transform(tc), jm.inverse_transform(jc),
                               rtol=0, atol=1e-6)
    wrapped = tcnmf.CNMFModel.from_result(tres, D, **CPU, **kw)
    np.testing.assert_array_equal(wrapped.synergies_, tm.synergies_)
    assert wrapped.n_iter_ == tm.n_iter_
    assert tm.fit(FRAME) is tm


def test_model_refusals(tmp_path):
    model = tcnmf.CNMFModel(K, D, **CPU)
    with pytest.raises(ValueError, match="not fitted yet"):
        model.transform(X[0])
    with pytest.raises(ValueError, match="not fitted yet"):
        model.inverse_transform(C0[0])
    with pytest.raises(ValueError, match="not fitted yet"):
        model.save(tmp_path / "model.npz")
    with pytest.raises(FileNotFoundError):
        tcnmf.CNMFModel.load(tmp_path / "model.npz")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcnmf.CNMFModel(K, D).fit_transform(X[0])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcnmf.find_time_varying_synergies(FRAME, K, D)


def _bad_frames():
    neg, nan = X[0].copy(), X[0].copy()
    neg[3, 1], nan[2, 2] = -1.0, np.nan
    return {
        "3-D": (X, K, D, {}), "empty": (np.zeros((0, L)), K, D, {}),
        "NaN": (nan, K, D, {}), "negative": (neg, K, D, {}),
        "rank 0": (X[0], 0, D, {}), "lags 0": (X[0], K, 0, {}),
        "lags > T": (X[0], K, T + 1, {}), "n_inits 0": (X[0], K, D, dict(n_inits=0)),
    }


@pytest.mark.parametrize("case", list(_bad_frames()))
def test_finder_refuses_what_jax_refuses(case):
    x, k, d, kw = _bad_frames()[case]
    with pytest.raises(ValueError) as jerr:
        jcnmf.find_time_varying_synergies(x, k, d, max_iter=10, **kw)
    with pytest.raises(ValueError) as terr:
        tcnmf.find_time_varying_synergies(x, k, d, max_iter=10, **CPU, **kw)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as merr:
        tcnmf.CNMFModel(k, d, max_iter=10, **CPU, **kw).fit(x)
    assert str(merr.value) == str(jerr.value)


def test_top_level_exports_match_jax():
    for name in ("find_time_varying_synergies", "TimeVaryingSynergyResult"):
        assert hasattr(mst, name) and hasattr(mt, name)
