"""PyTorch port: checkpoint stores, the resumable rank sweep, profiling.

Held in float64 on the CPU against ``muscle_synergies_tpu.utils``:

- ``SweepCheckpoint`` / ``GridCheckpoint``: round trips, key checks,
  atomic publishing (no ``.tmp.npz`` left), the ``backend="orbax"``
  round trip, and the JAX package's file layout: a directory
  written by either package's ``GridCheckpoint`` (through its checkpointed
  bootstrap) resumes in the other's, to 1e-10;
- ``find_synergies_checkpointed`` against the JAX package's (VAF tables
  within 1e-10), a resumed sweep refitting only the missing ranks, in
  either package's directory;
- ``Timer``, ``annotate`` (its name in ``torch.profiler``'s
  ``key_averages()``), ``solver_report`` against the JAX package's on
  the same state (1e-12), ``debug_nans`` raising and restoring.
"""

import numpy as np
import pandas
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from muscle_synergies_tpu.models import hals as jhals  # noqa: E402
from muscle_synergies_tpu.models import mu as jmu  # noqa: E402
from muscle_synergies_tpu.models import resume as jresume  # noqa: E402
from muscle_synergies_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from muscle_synergies_tpu.utils import profiling as jprofiling  # noqa: E402
from muscle_synergies_tpu_torch import _common  # noqa: E402
from muscle_synergies_tpu_torch.models import hals, mu, resume, select  # noqa: E402
from muscle_synergies_tpu_torch.utils import (  # noqa: E402
    GridCheckpoint,
    SweepCheckpoint,
    Timer,
    annotate,
    debug_nans,
    find_synergies_checkpointed,
    solver_report,
)

RNG = np.random.default_rng(11)
X = RNG.uniform(0.1, 1.0, (40, 6))
MUSCLES = [f"m{i}" for i in range(5)]
EMG = pandas.DataFrame(RNG.uniform(0.1, 1.0, (60, 3)) @ RNG.uniform(0.1, 1.0, (3, 5)),
                       columns=MUSCLES)
CPU = dict(device="cpu")
SWEEP = dict(max_iter=400, tol=1e-6)
BOOT = dict(n_boot=4, chunk_size=2, seed=3, max_iter=40)


# ---- the stores -------------------------------------------------------------

def test_grid_checkpoint_round_trip_and_refusals(tmp_path):
    ckpt = GridCheckpoint(tmp_path)
    arrays = {"a": np.arange(6).reshape(2, 3), "b": np.ones(4)}
    ckpt.save("chunk_0", arrays, meta={"range": [0, 2]})
    assert ckpt.has("chunk_0") and not ckpt.has("chunk_1")
    out = ckpt.load("chunk_0")
    for key, value in arrays.items():
        np.testing.assert_array_equal(out["arrays"][key], value)
    assert out["meta"] == {"range": [0, 2]}
    assert ckpt.completed_keys() == ["chunk_0"]
    with pytest.raises(ValueError, match="key"):
        ckpt.save("../escape", {"a": np.ones(1)})
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save("k", {"meta": np.ones(1)})
    assert list(tmp_path.glob("*.tmp.npz")) == []
    # the JAX package reads the port's file, and the port the JAX package's
    theirs = jcheckpoint.GridCheckpoint(tmp_path).load("chunk_0")
    np.testing.assert_array_equal(theirs["arrays"]["a"], arrays["a"])
    theirs = jcheckpoint.GridCheckpoint(tmp_path)
    theirs.save("jax_key", {"c": np.arange(3.0)}, {"x": 1})
    assert ckpt.load("jax_key")["meta"] == {"x": 1}
    assert ckpt.completed_keys() == ["chunk_0", "jax_key"]


def test_sweep_checkpoint_round_trip_and_refusals(tmp_path):
    ckpt = SweepCheckpoint(tmp_path)
    vaf = pandas.DataFrame([[0.9, 0.8, 0.95]], columns=["All signals", "a", "b"])
    w, h = RNG.random((10, 2)), RNG.random((2, 2))
    ckpt.save(2, w, h, vaf, meta={"n_iter": 7})
    assert ckpt.has(2) and not ckpt.has(3) and ckpt.completed_ranks() == [2]
    out = ckpt.load(2)
    np.testing.assert_array_equal(out["w"], w)
    np.testing.assert_array_equal(out["h"], h)
    pandas.testing.assert_frame_equal(out["vaf_values"], vaf)
    assert out["meta"] == {"n_iter": 7}
    theirs = jcheckpoint.SweepCheckpoint(tmp_path).load(2)
    pandas.testing.assert_frame_equal(theirs["vaf_values"], vaf)
    assert list(tmp_path.glob("*.tmp.npz")) == []
    with pytest.raises(ValueError, match="backend"):
        SweepCheckpoint(tmp_path, backend="zarr")


@pytest.mark.parametrize("store", [SweepCheckpoint, GridCheckpoint])
def test_orbax_backend_names_its_roadmap_item(store, tmp_path):
    """The ``orbax`` backend (ROADMAP item 8b) stores one directory per
    entry, holding the npz store's payload, and loads it back."""
    import pandas

    ckpt = store(tmp_path, backend="orbax")
    w = np.random.default_rng(3).random((5, 2))
    if store is SweepCheckpoint:
        ckpt.save(2, w, w.T, pandas.DataFrame([[0.5, 0.9]], columns=["a", "b"]),
                  meta={"n_iter": 4})
        got = ckpt.load(2)
        assert ckpt.completed_ranks() == [2] and got["meta"] == {"n_iter": 4}
        np.testing.assert_array_equal(got["h"], w.T)
        assert list(got["vaf_values"].columns) == ["a", "b"]
    else:
        ckpt.save("chunk_0", {"w": w}, meta={"n_iter": 4})
        got = ckpt.load("chunk_0")
        assert ckpt.completed_keys() == ["chunk_0"] and got["meta"] == {"n_iter": 4}
        np.testing.assert_array_equal(got["arrays"]["w"], w)
    assert (tmp_path / ("rank_2" if store is SweepCheckpoint else "chunk_0")).is_dir()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_directory_resumes_in_the_other_package(writer, tmp_path):
    """One package runs the job, one chunk is lost, the other resumes:
    one call for the missing chunk, the result the first package's."""
    first = (jresume.bootstrap_synergies_checkpointed(X, 2, tmp_path, **BOOT)
             if writer == "jax" else
             resume.bootstrap_synergies_checkpointed(X, 2, tmp_path, **BOOT, **CPU))
    (tmp_path / "chunk_00002_00004.npz").unlink()
    if writer == "jax":
        calls = []
        original = resume.bootstrap_synergies
        def counted(*args, **kwargs):
            calls.append(1)
            return original(*args, **kwargs)

        resume.bootstrap_synergies = counted
        try:
            out = resume.bootstrap_synergies_checkpointed(X, 2, tmp_path, **BOOT, **CPU)
        finally:
            resume.bootstrap_synergies = original
        assert len(calls) == 1
    else:
        out = jresume.bootstrap_synergies_checkpointed(X, 2, tmp_path, **BOOT)
    np.testing.assert_allclose(out.similarities, first.similarities, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.reference_components, first.reference_components,
                               rtol=0, atol=1e-10)


# ---- the resumable rank sweep ----------------------------------------------

def test_find_synergies_checkpointed_matches_the_jax_package(tmp_path):
    from muscle_synergies_tpu.utils.checkpoint import (
        find_synergies_checkpointed as j_find,
    )

    got = find_synergies_checkpointed(EMG, 1, 4, tmp_path / "port", **SWEEP, **CPU)
    want = j_find(EMG, 1, 4, tmp_path / "jax", **SWEEP)
    assert list(got.vaf_values.index) == list(want.vaf_values.index) == [1, 2, 3, 4]
    np.testing.assert_allclose(got.vaf_values.to_numpy(), want.vaf_values.to_numpy(),
                               rtol=0, atol=1e-10)
    for k in range(1, 5):
        assert list(got.components[k].columns) == MUSCLES
        np.testing.assert_allclose(got.components[k].to_numpy(),
                                   want.components[k].to_numpy(), rtol=0, atol=1e-8)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_resumed_sweep_refits_only_the_missing_ranks(writer, tmp_path, monkeypatch):
    from muscle_synergies_tpu.utils.checkpoint import (
        find_synergies_checkpointed as j_find,
    )

    if writer == "jax":
        j_find(EMG, 1, 2, tmp_path, **SWEEP)
    else:
        find_synergies_checkpointed(EMG, 1, 2, tmp_path, **SWEEP, **CPU)
    fitted = []
    original = select.NMFModel.fit_transform

    def counted(self, x, *args, **kwargs):
        fitted.append(self.n_components)
        return original(self, x, *args, **kwargs)

    monkeypatch.setattr(select.NMFModel, "fit_transform", counted)
    out = find_synergies_checkpointed(EMG, 1, 4, tmp_path, **SWEEP, **CPU)
    assert fitted == [3, 4]
    assert isinstance(out.model[1], dict) and isinstance(out.model[3], select.NMFModel)
    full = find_synergies_checkpointed(EMG, 1, 4, tmp_path / "fresh", **SWEEP, **CPU)
    np.testing.assert_allclose(out.vaf_values.to_numpy(), full.vaf_values.to_numpy(),
                               rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="invalid number of components"):
        find_synergies_checkpointed(EMG, 3, 2, tmp_path, **CPU)


# ---- profiling ------------------------------------------------------------

def test_timer_and_annotate():
    with Timer("sum") as t:
        sum(range(1000))
    assert t.elapsed is not None and t.elapsed >= 0
    from torch.profiler import profile

    with profile() as prof:
        with annotate("port-scope"):
            (torch.ones(8) * 2).sum()
    assert "port-scope" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("solver", ["mu", "cd"])
@pytest.mark.parametrize("batched", [False, True])
def test_solver_report_matches_the_jax_package(solver, batched):
    rng = np.random.default_rng(3)
    x = rng.random((3, 30, 5)) if batched else rng.random((30, 5))
    w0, h0 = rng.random(x.shape[:-1] + (2,)), rng.random(x.shape[:-2] + (2, 5))
    xt, wt, ht = (torch.as_tensor(a) for a in (x, w0, h0))
    fit = dict(max_iter=35, tol=1e-3)
    state = (mu.fit_mu(xt, wt, ht, **fit) if solver == "mu"
             else hals.fit_cd(xt, wt, ht, **fit))
    jstate = (jmu.MUState if solver == "mu" else jhals.CDState)(
        *(jnp.asarray(_common.to_numpy(f)) for f in state))
    for data in (None, x):
        got = solver_report(state, data)
        jdata = None if data is None else jnp.asarray(data)
        want = jprofiling.solver_report(jstate, jdata)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                       np.asarray(value, dtype=float),
                                       rtol=1e-12, atol=0)
            assert np.shape(got[key]) == np.shape(value), key


def test_debug_nans_raises_and_restores():
    x = torch.tensor([0.0, 1.0])
    nan = torch.tensor([float("nan")])  # made outside the scope
    assert not _common.DEBUG_NANS
    with debug_nans():
        assert _common.DEBUG_NANS
        with pytest.raises(FloatingPointError, match="nan"):
            x / x
        torch.empty(4)  # uninitialised memory is no result
        with debug_nans(False):
            assert torch.isnan(x / x).any()
        assert _common.DEBUG_NANS
        with pytest.raises(FloatingPointError, match="K-test"):
            _common.check_kernel_nans("K-test", nan)
    assert not _common.DEBUG_NANS
    assert torch.isnan(x / x).any()
    _common.check_kernel_nans("K-test", nan)  # off: no check
