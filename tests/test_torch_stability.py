"""PyTorch port: synergy stability, held-out rank selection and matching.

Held in float64 on the CPU to ``muscle_synergies_tpu.models.stability``
on the same seeded inputs: every bootstrap's similarities within 1e-10
and its reference components within 1e-8 relative (the reference fit
rides as row 0 of the resamples' batch and must be the JAX package's
single-problem fit); the masked fits' iteration counts and convergence
flags equal and factors within 1e-8 relative, at a ``max_iter`` that is
no multiple of ``check_every`` (each loop's own tail rule) and for the
MU one at ``tol=0``; every cross-validation's held-out errors within
1e-10 and its choice equal; match pairs, cluster labels and membership
exactly equal.  Also: padded ranks and modules stay exactly zero,
``_resample_plan`` chunks give the unchunked result, every ``mesh=``
path on a one-process mesh gives the local result (ROADMAP item 8b;
four processes in ``test_torch_parallel_dataset``), the JAX package's
``ValueError`` texts, and
``DatasetResult.cluster_subjects`` without pandas.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import no_leftover_group  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.models import stability as js  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch.models import stability as ts  # noqa: E402

N, L, K = 120, 6, 3  # the flat and convolutive matrices
KC, D = 2, 5  # synergies and lags of the convolutive model
B, T, P, Q = 8, 30, 3, 2  # the space-by-time stack
CPU = dict(device="cpu")
BOOT = dict(n_boot=5, max_iter=200, tol=1e-6)
TV = dict(n_boot=4, max_iter=100, tol=1e-5)
SBT = dict(n_boot=4, max_iter=85, tol=1e-6)
CV = dict(n_repeats=3, max_iter=85, tol=1e-6)


def _matrix(seed=0):
    rng = np.random.default_rng(seed)
    w, h = rng.random((N, K)), rng.random((K, L))
    return w @ h + 0.05 * rng.random((N, L))


def _stack(seed=1):
    rng = np.random.default_rng(seed)
    w = np.abs(np.sin(np.linspace(0, 3, T)[:, None] * (1 + np.arange(P))[None, :]))
    a, s = rng.random((B, P, Q)), rng.random((Q, L))
    return np.einsum("tp,bpq,ql->btl", w, a, s) + 0.05 * rng.random((B, T, L))


X, XS = _matrix(), _stack()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# ---- helpers -------------------------------------------------------------

def test_host_helpers_are_the_jax_packages():
    rng = np.random.default_rng(2)
    a, b = rng.random((4, 7)), rng.random((4, 7))
    b[1] = 0.0  # a zero component
    np.testing.assert_array_equal(ts._match_components(a, b), js._match_components(a, b))
    pa, pb = rng.random((D, L)), rng.random((D, L))
    for shift in (0, 1, 2):
        assert ts._best_shift(pa, pb, shift) == js._best_shift(pa, pb, shift)
        assert ts._shifted_cosine(pa, pb, shift) == js._shifted_cosine(pa, pb, shift)
    sa, sb = rng.random((3, D, L)), rng.random((3, D, L))
    np.testing.assert_array_equal(ts._match_time_varying(sa, sb, 2),
                                  js._match_time_varying(sa, sb, 2))
    for sh in (-2, 0, 3):
        np.testing.assert_array_equal(ts._shift_pattern(pa, sh), js._shift_pattern(pa, sh))
    got = ts._block_bootstrap_indices(N, 20, 6, np.random.default_rng(3))
    np.testing.assert_array_equal(
        got, js._block_bootstrap_indices(N, 20, 6, np.random.default_rng(3)))


# ---- flat MU: bootstrap and CV ----------------------------------------------

@pytest.mark.parametrize("init", [None, "random"])
def test_bootstrap_synergies_matches_jax(init):
    want = js.bootstrap_synergies(X, K, init=init, **BOOT)
    got = ts.bootstrap_synergies(X, K, init=init, **CPU, **BOOT)
    assert got.similarities.shape == (BOOT["n_boot"], K)
    np.testing.assert_allclose(got.similarities, want.similarities, rtol=0, atol=1e-10)
    assert _rel(got.reference_components, want.reference_components) < 1e-8
    np.testing.assert_allclose(got.mean, want.mean, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.std, want.std, rtol=0, atol=1e-10)


def test_bootstrap_reference_is_the_single_problem_fit():
    """Row 0 of the batch is the JAX package's lone ``fit_mu`` of the
    full matrix, from the same init."""
    from muscle_synergies_tpu.models import init as jinit
    from muscle_synergies_tpu.models import mu as jmu

    w0, h0 = jinit.initialize_nmf(jnp.asarray(X), K, seed=0)
    ref = jmu.fit_mu(jnp.asarray(X), w0, h0, max_iter=BOOT["max_iter"], tol=BOOT["tol"])
    got = ts.bootstrap_synergies(X, K, **CPU, **BOOT)
    assert _rel(got.reference_components, ref.h) < 1e-8


def test_resample_plan_chunks_give_the_unchunked_result():
    whole = ts.bootstrap_synergies(X, K, **CPU, **BOOT)
    idx = np.random.default_rng(0).integers(0, N, size=(BOOT["n_boot"], N))
    parts = [ts.bootstrap_synergies(X, K, _resample_plan=(idx[a:b], a), **CPU, **BOOT)
             for a, b in ((0, 2), (2, 5))]
    np.testing.assert_allclose(np.concatenate([p.similarities for p in parts]),
                               whole.similarities, rtol=0, atol=1e-12)
    tv = ts.bootstrap_time_varying_synergies(X, KC, D, **CPU, **TV)
    idx = js._block_bootstrap_indices(N, min(max(4 * D, 16), N), TV["n_boot"],
                                      np.random.default_rng(0))
    parts = [ts.bootstrap_time_varying_synergies(X, KC, D, _resample_plan=(idx[a:b], a),
                                                 **CPU, **TV)
             for a, b in ((0, 1), (1, 4))]
    np.testing.assert_allclose(np.concatenate([p.similarities for p in parts]),
                               tv.similarities, rtol=0, atol=1e-12)
    sbt = ts.bootstrap_space_by_time(XS, P, Q, **CPU, **SBT)
    idx = np.random.default_rng(0).integers(0, B, size=(SBT["n_boot"], B))
    parts = [ts.bootstrap_space_by_time(XS, P, Q, _resample_plan=(idx[a:b], a), **CPU,
                                        **SBT) for a, b in ((0, 3), (3, 4))]
    for i in range(2):
        np.testing.assert_allclose(np.concatenate([p[i].similarities for p in parts]),
                                   sbt[i].similarities, rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_iter, tol", [(85, 1e-6), (200, 1e-3), (85, 0.0)])
def test_fit_mu_masked_stops_where_jax_stops(max_iter, tol):
    """85 runs 8 chunks of 10 and one of 5, which cannot stop the fit;
    at 1e-3 the fit converges; ``tol=0`` keeps the initial error."""
    rng = np.random.default_rng(4)
    mask = (rng.random((N, L)) >= 0.1).astype(float)
    w0, h0 = rng.random((N, K)), rng.random((K, L))
    kw = dict(max_iter=max_iter, tol=tol)
    want = js.fit_mu_masked(*(jnp.asarray(a) for a in (X, mask, w0, h0)), **kw)
    got = ts.fit_mu_masked(*_t(X, mask, w0, h0), **kw)
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    assert _rel(got.w, want.w) < 1e-8 and _rel(got.h, want.h) < 1e-8
    assert abs(float(got.previous_error) - float(want.previous_error)) < 1e-8
    if max_iter == 85 and not bool(got.converged):
        assert int(got.n_iter) == 85


def test_cv_rank_selection_matches_jax():
    want = js.cv_rank_selection(X, (1, 2, 3, 4), **CV)
    got = ts.cv_rank_selection(X, (1, 2, 3, 4), **CPU, **CV)
    assert got.ranks == want.ranks and got.best_rank == want.best_rank
    np.testing.assert_allclose(got.test_error, want.test_error, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.mean_test_error, want.mean_test_error, rtol=0,
                               atol=1e-10)


def test_padded_components_stay_exactly_zero():
    rng = np.random.default_rng(5)
    mask = torch.as_tensor((rng.random((2, N, L)) >= 0.1).astype(float))
    w0 = torch.as_tensor(rng.random((2, N, 4)))
    h0 = torch.as_tensor(rng.random((2, 4, L)))
    w0[0, :, 2:], h0[0, 2:] = 0.0, 0.0  # rank 2 padded to 4
    fit = ts.fit_mu_masked(torch.as_tensor(X).expand(2, N, L), mask, w0, h0,
                           max_iter=85, tol=1e-6)
    assert bool((fit.w[0, :, 2:] == 0).all()) and bool((fit.h[0, 2:] == 0).all())
    assert bool((fit.w[1] > 0).any(dim=0).all())
    c0, s0 = rng.random((N, 3)), rng.random((3, D, L))
    c0[:, 2], s0[2] = 0.0, 0.0
    fit = ts.fit_cnmf_masked(*_t(X, mask[0], c0, s0), max_iter=30)
    assert bool((fit.c[:, 2] == 0).all()) and bool((fit.s[2] == 0).all())
    w0, a0, s0 = rng.random((T, 3)), rng.random((B, 3, 3)), rng.random((3, L))
    w0[:, 2], a0[:, 2], a0[:, :, 2], s0[2] = 0.0, 0.0, 0.0, 0.0
    m = (rng.random(XS.shape) >= 0.1).astype(float)
    fit = ts.fit_nm3f_masked(*_t(XS, m, w0, a0, s0), max_iter=30)
    assert bool((fit.w[:, 2] == 0).all()) and bool((fit.s[2] == 0).all())
    assert bool((fit.a[:, 2] == 0).all()) and bool((fit.a[:, :, 2] == 0).all())


# ---- convolutive: bootstrap and CV -------------------------------------------

def test_bootstrap_time_varying_matches_jax():
    want = js.bootstrap_time_varying_synergies(X, KC, D, **TV)
    got = ts.bootstrap_time_varying_synergies(X, KC, D, **CPU, **TV)
    assert got.similarities.shape == (TV["n_boot"], KC)
    np.testing.assert_allclose(got.similarities, want.similarities, rtol=0, atol=1e-10)
    assert _rel(got.reference_synergies, want.reference_synergies) < 1e-8
    np.testing.assert_allclose(got.mean, want.mean, rtol=0, atol=1e-10)


@pytest.mark.parametrize("max_iter, tol", [(85, 1e-5), (200, 1e-3)])
def test_fit_cnmf_masked_stops_where_jax_stops(max_iter, tol):
    """Whole chunks only: ``max_iter=85`` runs 90 iterations."""
    rng = np.random.default_rng(6)
    mask = (rng.random((N, L)) >= 0.1).astype(float)
    c0, s0 = rng.random((N, KC)), rng.random((KC, D, L))
    kw = dict(max_iter=max_iter, tol=tol)
    want = js.fit_cnmf_masked(*(jnp.asarray(a) for a in (X, mask, c0, s0)), **kw)
    got = ts.fit_cnmf_masked(*_t(X, mask, c0, s0), **kw)
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    assert _rel(got.c, want.c) < 1e-8 and _rel(got.s, want.s) < 1e-8
    if max_iter == 85 and not bool(got.converged):
        assert int(got.n_iter) == 90


def test_cv_time_varying_rank_selection_matches_jax():
    kw = dict(n_repeats=2, max_iter=85, tol=1e-5)
    want = js.cv_time_varying_rank_selection(X, (1, 2, 3), D, **kw)
    got = ts.cv_time_varying_rank_selection(X, (1, 2, 3), D, **CPU, **kw)
    assert got.ranks == want.ranks and got.best_rank == want.best_rank
    np.testing.assert_allclose(got.test_error, want.test_error, rtol=0, atol=1e-10)


# ---- space-by-time and the shared-factor forms --------------------------------

def test_bootstrap_space_by_time_matches_jax():
    want = js.bootstrap_space_by_time(XS, P, Q, **SBT)
    got = ts.bootstrap_space_by_time(XS, P, Q, **CPU, **SBT)
    for g, w, shape in zip(got, want, ((P, T), (Q, L))):
        assert g.reference_components.shape == shape
        np.testing.assert_allclose(g.similarities, w.similarities, rtol=0, atol=1e-10)
        assert _rel(g.reference_components, w.reference_components) < 1e-8


@pytest.mark.parametrize("update_w, update_s, max_iter, tol",
                         [(True, True, 85, 1e-6), (True, False, 85, 1e-6),
                          (False, True, 200, 1e-4)])
def test_fit_nm3f_masked_stops_where_jax_stops(update_w, update_s, max_iter, tol):
    """A tail chunk of 5 at ``max_iter=85``, a converging fit, and the
    frozen sides."""
    rng = np.random.default_rng(7)
    mask = (rng.random(XS.shape) >= 0.1).astype(float)
    w0, a0, s0 = rng.random((T, P)), rng.random((B, P, Q)), rng.random((Q, L))
    kw = dict(max_iter=max_iter, tol=tol, update_w=update_w, update_s=update_s)
    want = js.fit_nm3f_masked(*(jnp.asarray(a) for a in (XS, mask, w0, a0, s0)), **kw)
    got = ts.fit_nm3f_masked(*_t(XS, mask, w0, a0, s0), **kw)
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) < 1e-8
    if not update_w:
        np.testing.assert_array_equal(got.w.numpy(), w0)
    if not update_s:
        np.testing.assert_array_equal(got.s.numpy(), s0)


def test_cv_space_by_time_selection_matches_jax():
    kw = dict(n_repeats=2, max_iter=85, tol=1e-6)
    pairs = [(2, 2), (3, 2), (3, 1)]
    want = js.cv_space_by_time_selection(XS, pairs, **kw)
    got = ts.cv_space_by_time_selection(XS, pairs, **CPU, **kw)
    assert got.pairs == want.pairs and got.best == want.best
    np.testing.assert_allclose(got.test_error, want.test_error, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.mean_test_error, want.mean_test_error, rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("name", ["cv_temporal_selection", "cv_shared_spatial_selection"])
def test_shared_factor_cv_matches_jax(name):
    kw = dict(n_repeats=2, max_iter=85, tol=1e-6)
    want = getattr(js, name)(XS, (1, 2, 3), **kw)
    got = getattr(ts, name)(XS, (1, 2, 3), **CPU, **kw)
    assert got.ranks == want.ranks and got.best_rank == want.best_rank
    np.testing.assert_allclose(got.test_error, want.test_error, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["bootstrap_temporal_synergies",
                                  "bootstrap_shared_spatial_synergies"])
def test_shared_factor_bootstrap_matches_jax(name):
    want = getattr(js, name)(XS, 2, **SBT)
    got = getattr(ts, name)(XS, 2, **CPU, **SBT)
    np.testing.assert_allclose(got.similarities, want.similarities, rtol=0, atol=1e-10)
    assert _rel(got.reference_components, want.reference_components) < 1e-8
    idx = np.random.default_rng(0).integers(0, B, size=(SBT["n_boot"], B))
    parts = [getattr(ts, name)(XS, 2, _resample_plan=(idx[a:b], a), **CPU, **SBT)
             for a, b in ((0, 2), (2, 4))]
    np.testing.assert_allclose(np.concatenate([p.similarities for p in parts]),
                               got.similarities, rtol=0, atol=1e-12)


# ---- matching and clustering ----------------------------------------------------

def _sets(seed=8):
    rng = np.random.default_rng(seed)
    base = rng.random((4, L))
    return [np.abs(base[rng.permutation(4)[:k]] + 0.1 * rng.random((k, L)))
            for k in (4, 3, 4)]


def _tv_sets(seed=9):
    rng = np.random.default_rng(seed)
    base = rng.random((3, D, L))
    return [np.abs(np.roll(base[rng.permutation(3)], s, axis=1)
                   + 0.1 * rng.random((3, D, L))) for s in (0, 1, 2)]


@pytest.mark.parametrize("kind", ["spatial", "rectangular", "time-varying", "shift-1"])
def test_match_synergies_matches_jax(kind):
    sets = _sets() if kind in ("spatial", "rectangular") else _tv_sets()
    a, b = (sets[0], sets[1]) if kind == "rectangular" else (sets[0], sets[2])
    kw = dict(max_shift=1) if kind == "shift-1" else {}
    want = js.match_synergies(a, b, **kw)
    got = ts.match_synergies(torch.as_tensor(a), b, **kw)
    assert got.pairs == want.pairs
    np.testing.assert_allclose(got.similarities, want.similarities, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.similarity_matrix, want.similarity_matrix, rtol=0,
                               atol=1e-12)
    assert abs(got.mean - want.mean) < 1e-12


@pytest.mark.parametrize("kind, n_clusters", [("spatial", None), ("spatial", 2),
                                              ("time-varying", None),
                                              ("time-varying", 5)])
def test_cluster_synergies_matches_jax(kind, n_clusters):
    sets = _sets() if kind == "spatial" else _tv_sets()
    want = js.cluster_synergies(sets, n_clusters=n_clusters)
    got = ts.cluster_synergies(sets, n_clusters=n_clusters)
    assert len(got.labels) == len(want.labels)
    for g, w in zip(got.labels, want.labels):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.membership, want.membership)
    np.testing.assert_array_equal(got.set_index, want.set_index)
    np.testing.assert_allclose(got.consensus, want.consensus, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.similarity_matrix, want.similarity_matrix, rtol=0,
                               atol=1e-12)
    assert got.n_clusters == want.n_clusters
    np.testing.assert_array_equal(got.coverage, want.coverage)
    np.testing.assert_array_equal(got.shared, want.shared)


def test_cluster_subjects_matches_jax():
    rng = np.random.default_rng(10)
    trials = [rng.random((400, 4)) for _ in range(6)]
    subjects = ["s1", "s2", "s1", "s3", "s2", "s3"]
    res = mt.analyze_dataset(trials, 1000.0, ranks=(2, 3), subjects=subjects,
                             max_iter=50, **CPU)
    ref = mst.DatasetResult(res.ranks, res.w, res.h, res.vaf_overall,
                            res.vaf_per_channel, res.n_iter, res.converged,
                            subjects=subjects)
    for rank, n_clusters in ((2, None), (3, 2)):
        got = res.cluster_subjects(rank, n_clusters=n_clusters)
        want = ref.cluster_subjects(rank, n_clusters=n_clusters)
        for g, w in zip(got.labels, want.labels):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.membership, want.membership)
        np.testing.assert_allclose(got.consensus, want.consensus, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.subject_components(3, "s2").to_numpy(),
                               ref.subject_components(3, "s2").to_numpy(), rtol=0,
                               atol=0)
    flat = mt.analyze_dataset(trials, 1000.0, ranks=(2,), max_iter=20, **CPU)
    with pytest.raises(ValueError, match="no subject labels"):
        flat.cluster_subjects(2)


# ---- refusals -----------------------------------------------------------------

REFUSALS = [
    ("bootstrap_time_varying_synergies", lambda m: m.bootstrap_time_varying_synergies(
        X, KC, D, block_len=3, **({} if m is js else CPU)), "block_len must be in"),
    ("bootstrap_temporal_synergies", lambda m: m.bootstrap_temporal_synergies(
        XS, T + 1, **({} if m is js else CPU)), "module count 31 outside"),
    ("cv_shared_spatial_selection", lambda m: m.cv_shared_spatial_selection(
        XS, (1, L + 1), **({} if m is js else CPU)), "candidate module count 7 outside"),
    ("match_synergies shapes", lambda m: m.match_synergies(
        np.ones((3, L)), np.ones((3, L + 1))), "synergy shapes differ"),
    ("match_synergies kinds", lambda m: m.match_synergies(
        np.ones((3, L)), np.ones((3, D, L))), "expected two"),
    ("match_synergies max_shift", lambda m: m.match_synergies(
        np.ones((3, L)), np.ones((3, L)), max_shift=1), "max_shift applies"),
    ("cluster_synergies one set", lambda m: m.cluster_synergies(
        [np.ones((3, L))]), "at least two"),
    ("cluster_synergies shapes", lambda m: m.cluster_synergies(
        [np.ones((3, L)), np.ones((2, L + 1))]), "synergy shapes differ"),
    ("cluster_synergies n_clusters", lambda m: m.cluster_synergies(
        [np.ones((3, L)), np.ones((2, L))], n_clusters=6), "n_clusters=6 out of range"),
    ("cluster_synergies max_shift", lambda m: m.cluster_synergies(
        [np.ones((3, L)), np.ones((2, L))], max_shift=1), "max_shift applies"),
]


@pytest.mark.parametrize("call", [r[1] for r in REFUSALS], ids=[r[0] for r in REFUSALS])
def test_refusals_raise_the_jax_packages_text(call):
    with pytest.raises(ValueError) as want:
        call(js)
    with pytest.raises(ValueError) as got:
        call(ts)
    assert str(got.value) == str(want.value)


SMALL = dict(max_iter=20, **CPU)
MESHED = [
    lambda m: ts.bootstrap_synergies(X, K, n_boot=2, mesh=m, **SMALL),
    lambda m: ts.cv_rank_selection(X, (1, 2), n_repeats=1, mesh=m, **SMALL),
    lambda m: ts.bootstrap_time_varying_synergies(X, KC, D, n_boot=2, mesh=m, **SMALL),
    lambda m: ts.cv_time_varying_rank_selection(X, (1, 2), D, n_repeats=1, mesh=m,
                                                **SMALL),
    lambda m: ts.bootstrap_space_by_time(XS, P, Q, n_boot=2, mesh=m, **SMALL),
    lambda m: ts.cv_space_by_time_selection(XS, [(2, 2)], n_repeats=1, mesh=m, **SMALL),
    lambda m: ts.cv_temporal_selection(XS, (1, 2), n_repeats=1, mesh=m, **SMALL),
    lambda m: ts.cv_shared_spatial_selection(XS, (1, 2), n_repeats=1, mesh=m, **SMALL),
    lambda m: ts.bootstrap_temporal_synergies(XS, 2, n_boot=2, mesh=m, **SMALL),
    lambda m: ts.bootstrap_shared_spatial_synergies(XS, 2, n_boot=2, mesh=m, **SMALL),
]


def test_mesh_is_refused_naming_item_8():
    """Every ``mesh=`` path (ROADMAP item 8b): on a one-process
    ``(data, time)`` mesh each gives the local result; a mesh without
    those axes is refused with a warning and the call runs locally
    (four processes against the JAX package: ``test_torch_parallel_dataset``)."""
    mesh = mt.parallel.make_mesh((1, 1), device="cpu")
    other = mt.parallel.make_mesh((1, 1), ("data", "model"), device="cpu")

    def arrays(res):
        parts = res if isinstance(res, tuple) and not hasattr(res, "_fields") else (res,)
        return [np.asarray(getattr(r, f), dtype=float) for r in parts
                for f in ("similarities", "test_error") if hasattr(r, f)]

    for call in MESHED:
        local = arrays(call(None))
        for got, want in zip(arrays(call(mesh)), local):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        with pytest.warns(UserWarning, match=r"lacks the \['time'\] axis"):
            for got, want in zip(arrays(call(other)), local):
                np.testing.assert_array_equal(got, want)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.bootstrap_synergies(X, K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.cv_space_by_time_selection(XS, [(2, 2)])
