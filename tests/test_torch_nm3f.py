"""PyTorch port: space-by-time NM3F and its dataset path against JAX.

Held in float64 on the CPU to ``muscle_synergies_tpu.models.nm3f`` and
``analyze_dataset_space_by_time``: every update and product within
1e-12 relative, the fits' stopping iterations equal (batched restarts
each stopping on its own, the frozen-side fits, the tail chunk of a
``max_iter`` that is no multiple of ``check_every``, the transform),
factors within 1e-8 relative (1e-6 absolute after normalization), VAF
within 1e-8, the inits bit for bit, the finders' DataFrames equal, the
refusals raising what the JAX package raises, and the dataset path's
tables with subjects.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import no_leftover_group  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.models import nm3f as jn  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch.models import nm3f as tn  # noqa: E402

B, T, L, P, Q = 8, 30, 6, 3, 2
CPU = dict(device="cpu")
FIT = dict(max_iter=300, tol=1e-5, n_inits=3, seed=1)


def _stack(seed=90):
    """Trials from a known space-by-time model plus noise."""
    rng = np.random.default_rng(seed)
    w = np.abs(np.sin(np.linspace(0, 3, T)[:, None] * (1 + np.arange(P))[None, :]))
    a = rng.random((B, P, Q))
    s = rng.random((Q, L))
    return np.einsum("tp,bpq,ql->btl", w, a, s) + 0.05 * rng.random((B, T, L))


XS = _stack()
W0, A0, S0 = jn.init_nm3f(XS, P, Q, seed=3)
NAMES = [f"m{i}" for i in range(L)]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_reconstruct_update_and_vaf_match_jax():
    rec = tn.nm3f_reconstruct(*_t(W0, A0, S0))
    assert rec.shape == (B, T, L)
    assert _rel(rec, jn.nm3f_reconstruct(jnp.asarray(W0), jnp.asarray(A0),
                                         jnp.asarray(S0))) < 1e-12
    one = tn.nm3f_reconstruct(*_t(W0, A0[0], S0))
    assert _rel(one, jn.nm3f_reconstruct(jnp.asarray(W0), jnp.asarray(A0[0]),
                                         jnp.asarray(S0))) < 1e-12
    update = jax.jit(jn.nm3f_update, static_argnums=(4, 5))  # one program a pair
    for uw, us in ((True, True), (False, True), (True, False), (False, False)):
        jw, ja, js = update(jnp.asarray(XS), jnp.asarray(W0), jnp.asarray(A0),
                            jnp.asarray(S0), uw, us)
        tw, ta, ts = tn.nm3f_update(*_t(XS, W0, A0, S0), uw, us)
        assert _rel(tw, jw) < 1e-12 and _rel(ta, ja) < 1e-12 and _rel(ts, js) < 1e-12
        if not uw:
            np.testing.assert_array_equal(tw.numpy(), W0)
        if not us:
            np.testing.assert_array_equal(ts.numpy(), S0)
    np.testing.assert_allclose(
        tn.sbt_vaf(*_t(XS, W0, A0, S0)).numpy(),
        np.asarray(jn.sbt_vaf(jnp.asarray(XS), jnp.asarray(W0), jnp.asarray(A0),
                              jnp.asarray(S0))), rtol=0, atol=1e-12)
    jw, ja, js = jn.normalize_modules(jnp.asarray(W0), jnp.asarray(A0), jnp.asarray(S0))
    tw, ta, ts = tn.normalize_modules(*_t(W0, A0, S0))
    for got, want in ((tw, jw), (ta, ja), (ts, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=0)


def test_init_is_the_jax_draw_bit_for_bit():
    for xs in (XS, XS.astype(np.float32), torch.as_tensor(XS)):
        mine = tn.init_nm3f(xs, P, Q, seed=3)
        ref = jn.init_nm3f(np.asarray(xs), P, Q, seed=3)
        for got, want in zip(mine, ref):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_iter, tol", [(200, 1e-6), (73, 1e-9)])
def test_fit_stops_where_jax_stops(max_iter, tol):
    """Including the tail chunk: 73 iterations run 7 chunks of 10 and
    one of 3, which cannot stop the fit by convergence."""
    kw = dict(max_iter=max_iter, tol=tol)
    js = jn.fit_nm3f(jnp.asarray(XS), jnp.asarray(W0), jnp.asarray(A0), jnp.asarray(S0),
                     **kw)
    ts = tn.fit_nm3f(*_t(XS, W0, A0, S0), **kw)
    assert int(ts.n_iter) == int(js.n_iter) and bool(ts.converged) == bool(js.converged)
    for got, want in zip(ts[:3], js[:3]):
        assert _rel(got, want) < 1e-8
    assert abs(float(ts.previous_error) - float(js.previous_error)) < 1e-8
    if max_iter == 73:
        assert int(ts.n_iter) == 73 and not bool(ts.converged)


def test_batched_restarts_stop_each_on_its_own():
    """Restarts stacked on a leading axis against the JAX package's
    vmapped fits: each restart's count, error and factors equal, with
    restarts that stop at different iterations."""
    inits = [jn.init_nm3f(XS, P, Q, seed=r) for r in range(4)]
    w0, a0, s0 = (np.stack(f) for f in zip(*inits))
    kw = dict(max_iter=250, tol=1e-3)
    js = jax.vmap(lambda w, a, s: jn.fit_nm3f(jnp.asarray(XS), w, a, s, **kw))(
        jnp.asarray(w0), jnp.asarray(a0), jnp.asarray(s0))
    ts = tn._fit_restarts(torch.as_tensor(XS), *_t(w0, a0, s0), kw["max_iter"],
                          kw["tol"], 10, True, True, None)
    np.testing.assert_array_equal(ts.n_iter.numpy(), np.asarray(js.n_iter))
    assert len(set(ts.n_iter.tolist())) > 1  # they do stop apart
    np.testing.assert_array_equal(ts.converged.numpy(), np.asarray(js.converged))
    np.testing.assert_allclose(ts.previous_error.numpy(), np.asarray(js.previous_error),
                               rtol=1e-10)
    for got, want in zip(ts[:3], js[:3]):
        assert _rel(got, want) < 1e-8


@pytest.mark.parametrize("batched", [False, True])
def test_transform_draws_and_solves_as_jax(batched):
    w, s = np.abs(W0), np.abs(S0)
    x = XS if batched else XS[0]
    stop = dict(max_iter=FIT["max_iter"], tol=FIT["tol"])  # the model's stop
    js = jn.nm3f_transform(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), seed=5,
                           **stop)
    ts = tn.nm3f_transform(*_t(x, w, s), seed=5, **stop)
    assert int(ts.n_iter) == int(js.n_iter)
    assert ts.a.shape == ((B, P, Q) if batched else (P, Q))
    assert _rel(ts.a, js.a) < 1e-8
    np.testing.assert_array_equal(ts.w.numpy(), w)
    np.testing.assert_array_equal(ts.s.numpy(), s)
    # one (P, Q) start for every trial, and a start of the wrong batch
    js = jn.nm3f_transform(jnp.asarray(XS), jnp.asarray(w), jnp.asarray(s),
                           a0=jnp.asarray(A0[0]), **stop)
    ts = tn.nm3f_transform(*_t(XS, w, s), a0=torch.as_tensor(A0[0]), **stop)
    assert int(ts.n_iter) == int(js.n_iter) and _rel(ts.a, js.a) < 1e-8
    with pytest.raises(ValueError, match="a0 has batch 2 but x has 8 trials"):
        tn.nm3f_transform(*_t(XS, w, s), a0=torch.as_tensor(A0[:2]))
    g = tn.nm3f_transform(*_t(XS, w, s), max_iter=10,
                          generator=torch.Generator().manual_seed(0))
    assert not torch.equal(g.a, tn.nm3f_transform(*_t(XS, w, s), max_iter=10).a)


@pytest.fixture(scope="module")
def space_by_time():
    frames = [pd.DataFrame(x, columns=NAMES) for x in XS]
    jres = jn.find_space_by_time_synergies(frames, P, Q, **FIT)
    tres = tn.find_space_by_time_synergies(frames, P, Q, **CPU, **FIT)
    return jres, tres


def test_finder_matches_jax(space_by_time):
    jres, tres = space_by_time
    assert tres.n_iter == jres.n_iter
    np.testing.assert_allclose(tres.restart_errors, jres.restart_errors, rtol=1e-8)
    assert abs(tres.vaf - jres.vaf) < 1e-8
    np.testing.assert_allclose(tres.vaf_per_trial, jres.vaf_per_trial, rtol=0, atol=1e-8)
    pd.testing.assert_frame_equal(tres.temporal_modules, jres.temporal_modules,
                                  rtol=0, atol=1e-6)
    pd.testing.assert_frame_equal(tres.spatial_modules, jres.spatial_modules,
                                  rtol=0, atol=1e-6)
    assert list(tres.spatial_modules.columns) == NAMES
    np.testing.assert_allclose(tres.coefficients, jres.coefficients, rtol=0, atol=1e-6)
    assert mt.find_space_by_time_synergies is tn.find_space_by_time_synergies


def test_model_fits_transforms_and_inverts_as_jax(space_by_time):
    jres, tres = space_by_time
    kw = dict(max_iter=FIT["max_iter"], tol=FIT["tol"], n_inits=FIT["n_inits"],
              random_state=FIT["seed"])
    jm, tm = jn.NM3FModel(P, Q, **kw), tn.NM3FModel(P, Q, **CPU, **kw)
    ja, ta = jm.fit_transform(XS), tm.fit_transform(XS)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.temporal_modules_, jm.temporal_modules_, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tm.spatial_modules_, jm.spatial_modules_, rtol=0,
                               atol=1e-6)
    assert (tm.n_iter_, tm.n_temporal_, tm.n_spatial_) == (jm.n_iter_, P, Q)
    assert abs(tm.vaf_ - jm.vaf_) < 1e-8
    assert abs(tm.reconstruction_err_ - jm.reconstruction_err_) < 1e-8
    new = XS[::-1] * 0.5
    np.testing.assert_allclose(tm.transform(new), jm.transform(new), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.transform(new[0]), jm.transform(new[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tm.inverse_transform(ta), jm.inverse_transform(ja),
                               rtol=0, atol=1e-6)
    wrapped = tn.NM3FModel.from_result(tres, **CPU, **kw)
    np.testing.assert_array_equal(wrapped.temporal_modules_,
                                  tres.temporal_modules.to_numpy())
    assert wrapped.vaf_ == tres.vaf and wrapped.n_iter_ == tres.n_iter
    assert tm.fit(XS) is tm


def test_model_refusals(tmp_path):
    model = tn.NM3FModel(P, Q, **CPU)
    with pytest.raises(ValueError, match="not fitted yet"):
        model.transform(XS)
    model.fit(XS[:, :20])
    with pytest.raises(ValueError, match="trials have 30 samples but the fitted "
                                         "temporal modules expect 20"):
        model.transform(XS)
    with pytest.raises(ValueError, match="expected"):
        model.transform(XS[0, :, 0])
    with pytest.raises(ValueError, match="not fitted yet"):
        tn.NM3FModel(P, Q, **CPU).save(tmp_path / "model.npz")
    with pytest.raises(FileNotFoundError):
        tn.NM3FModel.load(tmp_path / "model.npz")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tn.NM3FModel(P, Q).fit(XS)
    mesh = mt.parallel.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.warns(UserWarning, match="falling back to the local"):
        tn.find_space_by_time_synergies(XS, P, Q, mesh=mesh, max_iter=10, **CPU)


@pytest.fixture(scope="module")
def frozen_sides():
    kw = dict(max_iter=200, tol=1e-5, n_inits=2, seed=4)
    return (jn.find_temporal_synergies(XS, P, **kw),
            tn.find_temporal_synergies(XS, P, **CPU, **kw),
            jn.find_shared_spatial_synergies(XS, Q, **kw),
            tn.find_shared_spatial_synergies(XS, Q, **CPU, **kw))


def test_temporal_and_shared_spatial_finders_match_jax(frozen_sides):
    jt, tt, js, ts = frozen_sides
    assert tt.n_iter == jt.n_iter and ts.n_iter == js.n_iter
    for mine, ref in ((tt, jt), (ts, js)):
        np.testing.assert_allclose(mine.restart_errors, ref.restart_errors, rtol=1e-8)
        assert abs(mine.vaf - ref.vaf) < 1e-8
        np.testing.assert_allclose(mine.vaf_per_trial, ref.vaf_per_trial, rtol=0,
                                   atol=1e-8)
    pd.testing.assert_frame_equal(tt.temporal_modules, jt.temporal_modules, rtol=0,
                                  atol=1e-6)
    np.testing.assert_allclose(tt.weights, jt.weights, rtol=0, atol=1e-6)
    pd.testing.assert_frame_equal(ts.spatial_modules, js.spatial_modules, rtol=0,
                                  atol=1e-6)
    np.testing.assert_allclose(ts.activations, js.activations, rtol=0, atol=1e-6)


def test_models_from_the_frozen_side_results_match_jax(frozen_sides):
    jt, tt, js, ts = frozen_sides
    new = XS[:3] * 1.5
    for wrap, mine, ref in (("from_temporal_result", tt, jt),
                            ("from_shared_spatial_result", ts, js)):
        jm = getattr(jn.NM3FModel, wrap)(ref, max_iter=100)
        tm = getattr(tn.NM3FModel, wrap)(mine, max_iter=100, **CPU)
        assert (tm.n_temporal_, tm.n_spatial_) == (jm.n_temporal_, jm.n_spatial_)
        np.testing.assert_allclose(tm.temporal_modules_, jm.temporal_modules_, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tm.spatial_modules_, jm.spatial_modules_, rtol=0,
                                   atol=1e-6)
        assert tm.n_iter_ == jm.n_iter_ and abs(tm.vaf_ - jm.vaf_) < 1e-8
        np.testing.assert_allclose(tm.transform(new), jm.transform(new), rtol=0,
                                   atol=1e-6)


def _bad_stacks():
    neg, nan = XS.copy(), XS.copy()
    neg[1, 2, 3], nan[0, 1, 1] = -1.0, np.nan
    return {"2-D": (XS[0], {}), "empty": (np.zeros((0, T, L)), {}), "NaN": (nan, {}),
            "negative": (neg, {}), "P 0": (XS, dict(n_temporal=0)),
            "P > T": (XS, dict(n_temporal=T + 1)), "Q 0": (XS, dict(n_spatial=0)),
            "Q > L": (XS, dict(n_spatial=L + 1)), "n_inits 0": (XS, dict(n_inits=0))}


# each finder with the module counts it takes
FINDERS = {"find_space_by_time_synergies": ("n_temporal", "n_spatial"),
           "find_temporal_synergies": ("n_temporal",),
           "find_shared_spatial_synergies": ("n_spatial",)}


@pytest.mark.parametrize("case", list(_bad_stacks()))
def test_finders_refuse_what_jax_refuses(case):
    xs, kw = _bad_stacks()[case]
    counts = dict(n_temporal=P, n_spatial=Q)
    for name, takes in FINDERS.items():
        if any(k in counts and k not in takes for k in kw):
            continue  # a count this finder does not take
        args = [kw.get(k, counts[k]) for k in takes]
        extra = {k: v for k, v in kw.items() if k not in counts}
        with pytest.raises(ValueError) as jerr:
            getattr(jn, name)(xs, *args, max_iter=10, **extra)
        with pytest.raises(ValueError) as terr:
            getattr(tn, name)(xs, *args, max_iter=10, **CPU, **extra)
        assert str(terr.value) == str(jerr.value), name
    if "n_spatial" not in kw and "n_temporal" not in kw:
        with pytest.raises(ValueError) as jerr:
            jn.NM3FModel(P, Q, max_iter=10, **kw).fit(xs)
        with pytest.raises(ValueError) as merr:
            tn.NM3FModel(P, Q, max_iter=10, **CPU, **kw).fit(xs)
        assert str(merr.value) == str(jerr.value)


def test_float32_stacks_solve_in_float32_and_ints_in_float64():
    res = tn.find_space_by_time_synergies(XS.astype(np.float32), P, Q, max_iter=20,
                                          n_inits=1, **CPU)
    assert res.coefficients.dtype == np.float32
    res = tn.find_space_by_time_synergies((XS * 10).astype(np.int64), P, Q, max_iter=20,
                                          n_inits=1, **CPU)
    assert res.coefficients.dtype == np.float64


# equal lengths: the JAX package compiles its ragged-trial preprocess
# for seconds, and the port's ragged path is held in test_torch_dataset
TRIALS = [np.random.default_rng(91 + i).standard_normal((400, 4)) for i in range(4)]
SUBJECTS = ["s1", "s1", "s2", "s2"]
DS = dict(n_temporal=2, n_spatial=2, max_iter=300, n_inits=2, seed=3)


@pytest.fixture(scope="module")
def dataset():
    frames = [pd.DataFrame(np.abs(x), columns=list("abcd")) for x in TRIALS]
    jres = mst.analyze_dataset_space_by_time(frames, 1000.0, subjects=SUBJECTS, **DS)
    tres = mt.analyze_dataset_space_by_time(frames, 1000.0, subjects=SUBJECTS,
                                            dtype=torch.float64, **CPU, **DS)
    return jres, tres


def test_dataset_path_matches_jax(dataset):
    jres, tres = dataset
    assert (tres.n_temporal, tres.n_spatial, tres.n_iter) == (2, 2, jres.n_iter)
    assert abs(tres.vaf_overall - jres.vaf_overall) < 1e-8
    np.testing.assert_allclose(tres.vaf_per_trial, jres.vaf_per_trial, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.vaf_per_channel, jres.vaf_per_channel, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tres.restart_errors, jres.restart_errors, rtol=1e-8)
    np.testing.assert_allclose(tres.coefficients, jres.coefficients, rtol=0, atol=1e-6)
    pd.testing.assert_frame_equal(tres.temporal_modules, jres.temporal_modules, rtol=0,
                                  atol=1e-6)
    pd.testing.assert_frame_equal(tres.spatial_modules, jres.spatial_modules, rtol=0,
                                  atol=1e-6)
    assert tres.channel_names == jres.channel_names == list("abcd")
    assert tres.subjects == SUBJECTS


def test_dataset_tables_match_jax(dataset):
    jres, tres = dataset
    pd.testing.assert_series_equal(tres.vaf_table(), jres.vaf_table(), rtol=0, atol=1e-8)
    for stat in ("mean", "min"):
        pd.testing.assert_series_equal(tres.subject_table(stat), jres.subject_table(stat),
                                       rtol=0, atol=1e-8)
    jr, tr = jres.to_result(), tres.to_result()
    assert isinstance(tr, tn.SpaceByTimeResult) and tr.n_iter == jr.n_iter
    pd.testing.assert_frame_equal(tr.spatial_modules, jr.spatial_modules, rtol=0,
                                  atol=1e-6)
    model = tn.NM3FModel.from_result(tres, **CPU)
    assert model.vaf_ == tres.vaf_overall
    bare = mt.SpaceByTimeDatasetResult(*(getattr(tres, f) for f in (
        "n_temporal", "n_spatial", "temporal_modules", "spatial_modules", "coefficients",
        "vaf_overall", "vaf_per_trial", "vaf_per_channel", "n_iter", "restart_errors")))
    with pytest.raises(ValueError, match="no subject labels"):
        bare.subject_table()
    assert list(bare.spatial_modules.columns) == [0, 1, 2, 3]


def test_dataset_path_takes_a_subject_mapping_and_refuses_a_mesh():
    mapping = {"s1": [np.abs(t) for t in TRIALS[:2]], "s2": [np.abs(t) for t in TRIALS[2:]]}
    res = mt.analyze_dataset_space_by_time(mapping, 1000.0, dtype=torch.float64, **CPU,
                                           **DS)
    assert res.subjects == SUBJECTS and res.coefficients.shape == (4, 2, 2)
    # a mesh without the (data, time) axes is refused with a warning
    mesh = mt.parallel.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.warns(UserWarning, match=r"lacks the \['time'\] axis"):
        mt.analyze_dataset_space_by_time(TRIALS, 1000.0, mesh=mesh, **CPU, **DS)
