"""PyTorch port: the checkpoint/resume functions (``models/resume.py``).

Mirrors ``tests/test_resume.py`` in float64 on the CPU, on seeded
inputs, for all eight checkpointed functions:

1. the chunked or per-candidate run equals the port's one-shot call:
   bootstrap similarities within 1e-10 absolute, CV held-out columns
   within 1e-12 relative (the one-shot grid pads every candidate to the
   grid's largest, which reorders float64 sums);
2. each equals the JAX package's checkpointed function on the same
   arguments, at ``tests/test_torch_stability.py``'s tolerances (1e-10);
3. a job killed after its first chunk restarts from it (the one-shot
   function is not called for restored work); a fully restored job
   refits only the reference (one call); a CV restarts per candidate.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu.models import resume as jresume  # noqa: E402
import muscle_synergies_tpu_torch.models.resume as resume_mod  # noqa: E402
from muscle_synergies_tpu_torch.models import stability as ts  # noqa: E402
from muscle_synergies_tpu_torch.utils.checkpoint import GridCheckpoint  # noqa: E402

RNG = np.random.default_rng(42)
X = RNG.uniform(0.1, 1.0, (40, 6))  # (N, L) spatial problem
XS = RNG.uniform(0.1, 1.0, (6, 20, 4))  # (B, T, L) trial stack
CPU = dict(device="cpu")
BOOT = dict(n_boot=4, chunk_size=2, seed=3)

# name: (positional arguments before the directory, keywords, the one-shot
# function and its positional arguments, the result's compared fields)
CHECKPOINTED = {
    "bootstrap_synergies": ((X, 2), dict(BOOT, max_iter=40), "bootstrap_synergies",
                            (X, 2), ("similarities", "reference_components")),
    "bootstrap_time_varying_synergies": (
        (X[:, :4], 2, 3), dict(BOOT, max_iter=30), "bootstrap_time_varying_synergies",
        (X[:, :4], 2, 3), ("similarities", "reference_synergies")),
    "bootstrap_space_by_time": ((XS, 2, 2), dict(BOOT, max_iter=30),
                                "bootstrap_space_by_time", (XS, 2, 2), ("similarities",)),
    "bootstrap_temporal_synergies": ((XS, 2), dict(BOOT, max_iter=30),
                                     "bootstrap_temporal_synergies", (XS, 2),
                                     ("similarities", "reference_components")),
    "bootstrap_shared_spatial_synergies": ((XS, 2), dict(BOOT, max_iter=30),
                                           "bootstrap_shared_spatial_synergies", (XS, 2),
                                           ("similarities", "reference_components")),
    "cv_rank_selection": ((X, [1, 2, 3]), dict(n_repeats=2, seed=5, max_iter=40),
                          "cv_rank_selection", (X, [1, 2, 3]), ("test_error",)),
    "cv_time_varying_rank_selection": (
        (X[:, :4], [1, 2], 3), dict(n_repeats=2, seed=5, max_iter=30),
        "cv_time_varying_rank_selection", (X[:, :4], [1, 2], 3), ("test_error",)),
    "cv_space_by_time_selection": (
        (XS, [(1, 1), (2, 2)]), dict(n_repeats=2, seed=5, max_iter=30),
        "cv_space_by_time_selection", (XS, [(1, 1), (2, 2)]), ("test_error",)),
}


def _one_shot_kwargs(kwargs):
    return {k: v for k, v in kwargs.items() if k != "chunk_size"}


def _results(out):
    """A checkpointed function's result(s) as a tuple (space-by-time returns a pair)."""
    return out if type(out) is tuple else (out,)


def _hold(got, want, fields, bootstrap_atol, cv_rtol):
    for g, w in zip(_results(got), _results(want)):
        for field in fields:
            a, b = np.asarray(getattr(g, field)), np.asarray(getattr(w, field))
            assert a.shape == b.shape, field
            if field == "test_error":
                np.testing.assert_allclose(a, b, rtol=cv_rtol, atol=0)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=bootstrap_atol)
    for attr in ("best_rank", "best", "ranks", "pairs"):
        if hasattr(got, attr):
            assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("name", list(CHECKPOINTED))
def test_checkpointed_equals_one_shot(name, tmp_path):
    args, kwargs, one_shot, shot_args, fields = CHECKPOINTED[name]
    got = getattr(resume_mod, f"{name}_checkpointed")(*args, tmp_path, **kwargs, **CPU)
    want = getattr(ts, one_shot)(*shot_args, **_one_shot_kwargs(kwargs), **CPU)
    _hold(got, want, fields, 1e-10, 1e-12)
    # a second run restores every unit and gives the same result
    again = getattr(resume_mod, f"{name}_checkpointed")(*args, tmp_path, **kwargs, **CPU)
    _hold(again, got, fields, 0, 0)


@pytest.mark.parametrize("name", list(CHECKPOINTED))
def test_checkpointed_equals_the_jax_packages(name, tmp_path):
    args, kwargs, _, _, fields = CHECKPOINTED[name]
    got = getattr(resume_mod, f"{name}_checkpointed")(*args, tmp_path / "port", **kwargs,
                                                      **CPU)
    want = getattr(jresume, f"{name}_checkpointed")(*args, tmp_path / "jax", **kwargs)
    _hold(got, want, fields, 1e-10, 1e-10)


def _count_calls(monkeypatch, name):
    calls = {"n": 0, "rows": []}
    orig = getattr(resume_mod, name)

    def counted(*args, **kwargs):
        calls["n"] += 1
        plan = kwargs.get("_resample_plan")
        calls["rows"].append(None if plan is None else len(plan[0]))
        return orig(*args, **kwargs)

    monkeypatch.setattr(resume_mod, name, counted)
    return calls


def _crash_after(monkeypatch, name, n_ok):
    calls = {"n": 0}
    orig = getattr(resume_mod, name)

    def flaky(*args, **kwargs):
        if calls["n"] >= n_ok:
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(resume_mod, name, flaky)


def test_kill_and_restart(tmp_path, monkeypatch):
    full = ts.bootstrap_synergies(X, 2, n_boot=4, seed=3, max_iter=40, **CPU)
    _crash_after(monkeypatch, "bootstrap_synergies", 1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path, max_iter=40, **BOOT,
                                                    **CPU)
    assert GridCheckpoint(tmp_path).completed_keys() == ["chunk_00000_00002"]
    assert list(tmp_path.glob("*.tmp.npz")) == []
    monkeypatch.undo()
    calls = _count_calls(monkeypatch, "bootstrap_synergies")
    out = resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path, max_iter=40, **BOOT,
                                                      **CPU)
    assert calls["n"] == 1 and calls["rows"] == [2]  # only the second chunk
    np.testing.assert_allclose(out.similarities, full.similarities, rtol=0, atol=1e-10)


def test_fully_restored_run_refits_only_the_reference(tmp_path, monkeypatch):
    first = resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path, max_iter=40,
                                                        **BOOT, **CPU)
    calls = _count_calls(monkeypatch, "bootstrap_synergies")
    out = resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path, max_iter=40, **BOOT,
                                                      **CPU)
    # one call, the first chunk's batch again, for the reference
    assert calls["n"] == 1 and calls["rows"] == [BOOT["chunk_size"]]
    np.testing.assert_array_equal(out.reference_components, first.reference_components)
    np.testing.assert_array_equal(out.similarities, first.similarities)


def test_space_by_time_restart_skips_completed(tmp_path, monkeypatch):
    kw = dict(BOOT, max_iter=30, **CPU)
    _crash_after(monkeypatch, "bootstrap_space_by_time", 1)
    with pytest.raises(RuntimeError):
        resume_mod.bootstrap_space_by_time_checkpointed(XS, 2, 2, tmp_path, **kw)
    monkeypatch.undo()
    calls = _count_calls(monkeypatch, "bootstrap_space_by_time")
    ck_w, ck_s = resume_mod.bootstrap_space_by_time_checkpointed(XS, 2, 2, tmp_path, **kw)
    assert calls["n"] == 1
    assert ck_w.similarities.shape == (4, 2) and ck_s.similarities.shape == (4, 2)


def test_cv_resumes_per_candidate(tmp_path, monkeypatch):
    kw = dict(n_repeats=2, seed=5, max_iter=40, **CPU)
    resume_mod.cv_rank_selection_checkpointed(X, [2], tmp_path, **kw)
    calls = _count_calls(monkeypatch, "cv_rank_selection")
    ck = resume_mod.cv_rank_selection_checkpointed(X, [1, 2, 3], tmp_path, **kw)
    assert calls["n"] == 2  # ranks 1 and 3 only
    full = ts.cv_rank_selection(X, [1, 2, 3], **kw)
    np.testing.assert_allclose(ck.test_error, full.test_error, rtol=1e-12)
    assert sorted(GridCheckpoint(tmp_path).completed_keys()) == ["rank_1", "rank_2",
                                                                 "rank_3"]


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="chunk_size"):
        resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path, chunk_size=0, **CPU)
    # the orbax store (ROADMAP item 8b) resumes as the npz one does
    kw = dict(n_boot=4, chunk_size=2, max_iter=30, backend="orbax", **CPU)
    first = resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path / "o", **kw)
    again = resume_mod.bootstrap_synergies_checkpointed(X, 2, tmp_path / "o", **kw)
    np.testing.assert_array_equal(first.similarities, again.similarities)
    chunks = sorted(p for p in (tmp_path / "o").iterdir())
    assert len(chunks) == 2 and all((p / "data.npz").is_file() for p in chunks)
    if not torch.cuda.is_available():  # they run on the card by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resume_mod.cv_rank_selection_checkpointed(X, [1], tmp_path / "cv")
