"""PyTorch port: every ``mesh=`` path, ``sharding=`` and the ``orbax``
store against the JAX package.

One pool of 4 gloo processes serves the file (see ``test_torch_parallel``);
each meshed entry point runs SPMD there, every rank on the same trials,
and the JAX package's meshed entry point runs in this process on the
virtual CPU mesh of the same shape.  Float64 on both sides.  Bars:
preprocessed trials within 1e-10 x max|y|; factors and VAF of
fixed-iteration fits within 1e-8 relative, with ``n_iter`` and
``converged`` equal; bootstrap similarities and held-out errors within
1e-8.  A mesh that does not divide, or lacks the ``(data, time)`` axes,
warns with the JAX package's words and falls back to the local path.
"""


import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import MESH, MeshPool, no_leftover_group  # noqa: E402,F401

from muscle_synergies_tpu import dataset as jm  # noqa: E402
from muscle_synergies_tpu.io import batch as jbatch  # noqa: E402
import muscle_synergies_tpu_torch as tm  # noqa: E402
from muscle_synergies_tpu.models import stability as jstab  # noqa: E402
from muscle_synergies_tpu.utils.config import FilterSpec as JFilterSpec  # noqa: E402
from muscle_synergies_tpu.utils.config import PipelineConfig as JPipelineConfig  # noqa: E402
from muscle_synergies_tpu.utils import checkpoint as jckpt  # noqa: E402
from muscle_synergies_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

DT = ("data", "time")
FS = 1000.0


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4)
    yield p
    p.close()


def _jmesh(shape, names=DT):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape), names)


def _trials(seed, b=3, n=403, l=3, ragged=False):
    rng = np.random.default_rng(seed)
    lens = [n - 7 * i if ragged else n for i in range(b)]
    return [np.abs(rng.standard_normal((m, l))) + 0.1 for m in lens]


def _configs(reduce_to=40, **kw):
    """The same pipeline in both packages."""
    jspec = JFilterSpec(**kw.pop("envelope", {}))
    tspec = tm.FilterSpec(**{f: getattr(jspec, f) for f in
                             ("order", "critical_freqs", "filter_type", "band_type",
                              "cheby_param", "zero_lag")})
    return (JPipelineConfig(envelope=jspec, reduce_to=reduce_to, **kw),
            tm.PipelineConfig(envelope=tspec, reduce_to=reduce_to, **kw))


def _close(got, want, rtol):
    want = np.asarray(want, dtype=float)
    got = np.asarray(got, dtype=float)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _same_on_every_rank(outs):
    for other in outs[1:]:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), outs[0], other)
    return outs[0]


@pytest.mark.parametrize("case", ["zero-phase", "causal", "rms", "rms-ragged",
                                  "zero-phase-ragged"])
def test_preprocess_trials_on_a_time_sharded_mesh(pool, case):
    kw = {"causal": dict(envelope=dict(zero_lag=False)), "rms": dict(use_rms=True, rms_window_s=0.05),
          "rms-ragged": dict(use_rms=True, rms_window_s=0.02)}.get(case, {})
    jcfg, tcfg = _configs(**kw)
    trials = _trials(1, ragged=case.endswith("ragged"))
    got = _same_on_every_rank(pool.call("dataset.preprocess_trials", trials, FS, tcfg,
                                        mesh=MESH, device="cpu",
                                        on=((1, 4), DT)))
    want = jm.preprocess_trials(trials, FS, jcfg, mesh=_jmesh((1, 4)))
    _close(got, want, 1e-10)


RESULT = ("w", "h", "vaf_overall", "vaf_per_channel")


# CD from NNDSVD at rank 1 starts at its optimum: its violations are
# rounding noise, and so would be its stopping iteration; CD sweeps 2, 3
@pytest.mark.parametrize("solver, loss, tol, ranks", [
    ("mu", "frobenius", 0.0, (1, 2, 3)), ("cd", "frobenius", 1e-4, (2, 3)),
    ("mu", "kullback-leibler", 1e-4, (1, 2, 3))])
def test_analyze_dataset_on_a_mesh(pool, solver, loss, tol, ranks):
    jcfg, tcfg = _configs()
    trials = _trials(2)
    kw = dict(ranks=ranks, solver=solver, beta_loss=loss, max_iter=60, tol=tol)
    got = _same_on_every_rank(pool.call("dataset.analyze_dataset", trials, FS,
                                        config=tcfg, mesh=MESH, device="cpu",
                                        on=((2, 2), DT), **kw))
    want = jm.analyze_dataset(trials, FS, config=jcfg, mesh=_jmesh((2, 2)), **kw)
    for f in RESULT:
        _close(got[f], getattr(want, f), 1e-8)
    for f in ("n_iter", "converged"):
        np.testing.assert_array_equal(got[f], getattr(want, f))


def test_a_mesh_that_does_not_divide_warns_and_falls_back(pool):
    jcfg, tcfg = _configs(reduce_to=41)
    trials = _trials(3)
    kw = dict(ranks=(1, 2), max_iter=40, tol=0.0)
    with pytest.warns(UserWarning) as jwarn:
        want = jm.analyze_dataset(trials, FS, config=jcfg, mesh=_jmesh((2, 2)), **kw)
    got = pool.call("pool.with_warnings", "dataset.analyze_dataset", trials, FS,
                    config=tcfg, mesh=MESH, device="cpu", on=((2, 2), DT), **kw)
    for rank_out in got:
        out, messages = rank_out
        assert [str(w.message) for w in jwarn] == messages
        _close(out["vaf_overall"], want.vaf_overall, 1e-8)


def test_a_mesh_without_the_time_axis_falls_back():
    _, tcfg = _configs()
    mesh = tm.parallel.make_mesh((1, 1), ("data", "model"), device="cpu")
    trials = _trials(4)
    with pytest.warns(UserWarning, match=r"lacks the \['time'\] axis"):
        got = tm.analyze_dataset(trials, FS, ranks=(1, 2), config=tcfg, mesh=mesh,
                                 max_iter=30, device="cpu")
    local = tm.analyze_dataset(trials, FS, ranks=(1, 2), config=tcfg, max_iter=30,
                               device="cpu")
    np.testing.assert_array_equal(got.vaf_overall, local.vaf_overall)


def test_a_world_size_one_mesh_gives_the_local_result():
    _, tcfg = _configs()
    mesh = tm.parallel.make_mesh((1, 1), device="cpu")
    trials = _trials(5)
    for solver in ("mu", "cd"):
        kw = dict(ranks=(1, 2), config=tcfg, solver=solver, max_iter=50, device="cpu")
        got = tm.analyze_dataset(trials, FS, mesh=mesh, **kw)
        local = tm.analyze_dataset(trials, FS, **kw)
        _close(got.w, local.w, 1e-12)
        np.testing.assert_array_equal(got.n_iter, local.n_iter)


def test_analyze_dataset_time_varying_on_a_mesh(pool):
    jcfg, tcfg = _configs()
    trials = _trials(6)
    kw = dict(n_synergies=2, n_lags=4, n_inits=3, max_iter=30, tol=1e-4)
    got = _same_on_every_rank(pool.call("dataset.analyze_dataset_time_varying", trials,
                                        FS, config=tcfg, mesh=MESH, device="cpu",
                                        on=((2, 2), DT), **kw))
    want = jm.analyze_dataset_time_varying(trials, FS, config=jcfg, mesh=_jmesh((2, 2)),
                                           **kw)
    for f in ("c", "s", "vaf_overall", "restart_errors"):
        _close(got[f], getattr(want, f), 1e-8)
    np.testing.assert_array_equal(got["n_iter"], want.n_iter)


def test_analyze_dataset_space_by_time_on_a_mesh(pool):
    jcfg, tcfg = _configs()
    trials = _trials(7)  # 3 trials: padded with a zero trial on 2 data shards
    kw = dict(n_temporal=2, n_spatial=2, n_inits=2, max_iter=40, tol=1e-5)
    got = _same_on_every_rank(pool.call("dataset.analyze_dataset_space_by_time", trials,
                                        FS, config=tcfg, mesh=MESH, device="cpu",
                                        on=((2, 2), DT), **kw))
    want = jm.analyze_dataset_space_by_time(trials, FS, config=jcfg,
                                            mesh=_jmesh((2, 2)), **kw)
    _close(got["w"], want.temporal_modules.to_numpy(), 1e-8)
    _close(got["s"], want.spatial_modules.to_numpy(), 1e-8)
    _close(got["coefficients"], want.coefficients, 1e-8)
    _close(got["restart_errors"], want.restart_errors, 1e-8)
    assert got["n_iter"] == want.n_iter


def _stack(seed, b=4, t=40, l=4):
    return np.abs(np.random.default_rng(seed).standard_normal((b, t, l))) + 0.05


STABILITY = [
    ("bootstrap_synergies", lambda: (np.abs(np.random.default_rng(8).standard_normal(
        (48, 5))) + 0.1, 2), dict(n_boot=5, max_iter=60, tol=1e-5), "similarities"),
    ("cv_rank_selection", lambda: (np.abs(np.random.default_rng(9).standard_normal(
        (40, 5))) + 0.1, (1, 2, 3)), dict(n_repeats=2, max_iter=60), "test_error"),
    ("bootstrap_time_varying_synergies", lambda: (np.abs(
        np.random.default_rng(10).standard_normal((48, 4))) + 0.1, 2, 4),
     dict(n_boot=3, max_iter=40, tol=1e-4), "similarities"),
    ("cv_time_varying_rank_selection", lambda: (np.abs(
        np.random.default_rng(11).standard_normal((40, 4))) + 0.1, (1, 2), 4),
     dict(n_repeats=2, max_iter=40), "test_error"),
    ("bootstrap_space_by_time", lambda: (_stack(12), 2, 2),
     dict(n_boot=3, max_iter=40), "similarities"),
    ("cv_space_by_time_selection", lambda: (_stack(13), ((1, 1), (2, 2))),
     dict(n_repeats=2, max_iter=40), "test_error"),
    ("cv_temporal_selection", lambda: (_stack(14), (1, 2)),
     dict(n_repeats=2, max_iter=40), "test_error"),
    ("bootstrap_shared_spatial_synergies", lambda: (_stack(15), 2),
     dict(n_boot=3, max_iter=40), "similarities"),
]


@pytest.mark.parametrize("name, args, kw, field", STABILITY, ids=[s[0] for s in STABILITY])
def test_stability_on_a_mesh(pool, name, args, kw, field):
    args = args()
    got = _same_on_every_rank(pool.call(f"models.stability.{name}", *args, mesh=MESH,
                                        device="cpu", on=((2, 2), DT), **kw))
    want = getattr(jstab, name)(*args, mesh=_jmesh((2, 2)), **kw)
    if isinstance(want, tuple) and not hasattr(want, "_fields"):  # (temporal, spatial)
        for g, w in zip(got, want):
            _close(g[field], getattr(w, field), 1e-8)
        return
    assert np.abs(np.asarray(got[field]) - np.asarray(getattr(want, field))).max() <= 1e-8


@pytest.mark.parametrize("time_sharded", [False, True])
def test_stack_trials_places_the_batch(pool, time_sharded):
    trials = _trials(16, b=4, n=40, ragged=True)
    got = _same_on_every_rank(pool.call("pool.stack_sharded", trials, MESH, time_sharded,
                                        on=((2, 2), DT)))
    want = jbatch.stack_trials(trials)
    np.testing.assert_array_equal(got["data"], np.asarray(want.data))
    np.testing.assert_array_equal(got["mask"], np.asarray(want.mask))
    assert got["local"] == (2, 20 if time_sharded else 40, 3)
    assert got["placements"][0] == ("(Shard(dim=0), Shard(dim=1))" if time_sharded
                                    else "(Shard(dim=0), Replicate())")


def test_device_prefetch_places_each_item(pool):
    items = [np.arange(24.0).reshape(4, 3, 2) + i for i in range(3)]
    got = _same_on_every_rank(pool.call("pool.prefetch_sharded", items, MESH,
                                        on=((2, 2), DT)))
    for g, item in zip(got, items):
        np.testing.assert_array_equal(g["full"], item)
        assert g["local"] == (2, 3, 2)


def test_the_pipelined_path_takes_a_mesh(pool, tmp_path):
    _, tcfg = _configs()
    paths = []
    for i, t in enumerate(_trials(17, b=4)):
        paths.append(str(tmp_path / f"t{i}.npy"))
        np.save(paths[-1], t)
    kw = dict(ranks=(1, 2), config=tcfg, max_iter=40, device="cpu")
    got = _same_on_every_rank(pool.call("dataset.analyze_dataset_pipelined", paths, FS,
                                        chunk_files=4, loader=np.load, mesh=MESH,
                                        on=((2, 2), DT), **kw))
    one_shot = pool.call("dataset.analyze_dataset", [np.load(p) for p in paths], FS,
                         mesh=MESH, on=((2, 2), DT), **kw)[0]
    for f in RESULT + ("n_iter",):
        np.testing.assert_array_equal(got[f], one_shot[f])


def test_the_orbax_store_loads_what_the_jax_store_loads(tmp_path):
    import pandas

    rng = np.random.default_rng(18)
    w, h = rng.random((6, 2)), rng.random((2, 4))
    vaf = pandas.DataFrame([[0.9, 0.8, 0.7, 0.6, 0.5]], columns=list("abcde"))
    meta = {"n_iter": 12, "solver": "mu"}
    for pkg, sub in ((jckpt, "jax"), (tckpt, "torch")):
        pkg.SweepCheckpoint(tmp_path / sub, backend="orbax").save(2, w, h, vaf, meta=meta)
        pkg.GridCheckpoint(tmp_path / sub / "grid", backend="orbax").save(
            "chunk_0", {"sims": w, "idx": np.arange(5)}, meta=meta)
    stores = {sub: (pkg.SweepCheckpoint(tmp_path / sub, backend="orbax"),
                    pkg.GridCheckpoint(tmp_path / sub / "grid", backend="orbax"))
              for pkg, sub in ((jckpt, "jax"), (tckpt, "torch"))}
    (js, jg), (ts, tg) = stores["jax"], stores["torch"]
    assert ts.completed_ranks() == js.completed_ranks() == [2] and ts.has(2)
    assert tg.completed_keys() == jg.completed_keys() == ["chunk_0"]
    mine, theirs = ts.load(2), js.load(2)
    for f in ("w", "h"):
        np.testing.assert_array_equal(mine[f], theirs[f])
    pandas.testing.assert_frame_equal(mine["vaf_values"], theirs["vaf_values"])
    assert mine["meta"] == theirs["meta"]
    mine, theirs = tg.load("chunk_0"), jg.load("chunk_0")
    assert mine["meta"] == theirs["meta"]
    for k in ("sims", "idx"):
        np.testing.assert_array_equal(mine["arrays"][k], theirs["arrays"][k])
    assert not list(tmp_path.glob("torch/*.tmp"))


def test_every_rank_saves_and_one_writes_the_orbax_store(pool, tmp_path):
    arrays = {"sims": np.random.default_rng(19).random((3, 2))}
    outs = pool.call("pool.orbax_roundtrip", str(tmp_path / "store"), arrays, {"k": 1})
    for keys, loaded in outs:
        assert keys == ["chunk_0"] and loaded["meta"] == {"k": 1}
        np.testing.assert_array_equal(loaded["arrays"]["sims"], arrays["sims"])
