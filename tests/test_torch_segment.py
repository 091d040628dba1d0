"""PyTorch port: gait segmentation and the capture-to-VAF slice.

``transition_indices`` of both packages on seeded random support flags
(and a tail glitch shorter than the debounce window) gives the same
indices or the same error.  On written captures (the port's writer,
loaded by each package's loader), the port's ``Segmenter`` gives the
JAX one's segments, phase orders and ``(frame, subframe)`` slices for
every key, the same error messages, and the same for custom
``n_trechos``/``n_cycles``; ``phase_summary`` equals the JAX table to
1e-12 relative.  The slice: two written captures go through load,
``Segmenter``, the cut gait cycles (stop inclusive) and
``analyze_dataset`` on the CPU in float64 in each package, and agree
to the ragged-trial tolerance of ``tests/test_torch_dataset.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu import segment as jseg  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import segment as tseg  # noqa: E402
from muscle_synergies_tpu_torch import testing as ttesting  # noqa: E402

FS = 2000.0


def _flags(seed, n=400):
    """Seeded support flags: runs of random length, random legs."""
    rng = np.random.default_rng(seed)
    left, right = np.zeros(n), np.zeros(n)
    i = 0
    while i < n:
        run = int(rng.integers(1, 40))
        state = int(rng.integers(0, 4))
        left[i:i + run] = -100.0 if state & 1 else 0.0
        right[i:i + run] = -50.0 if state & 2 else 0.0
        i += run
    return left, right


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as exc:
        return f"ValueError: {exc}"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("num_segments, window", [(0, 10), (6, 5), (40, 10), (3, 1)])
def test_transition_indices_match_jax(seed, num_segments, window):
    left, right = _flags(seed)
    kw = dict(min_phase_size=window, num_segments=num_segments)
    assert _outcome(tseg.transition_indices, left, right, **kw) == _outcome(
        jseg.transition_indices, left, right, **kw)


def test_tail_glitch_shorter_than_the_window_matches_jax():
    left, right = np.full(200, -100.0), np.zeros(200)
    right[-2:] = -50.0  # 2 samples of ringing at the very end
    got = _outcome(tseg.transition_indices, left, right, min_phase_size=10,
                   num_segments=2)
    assert got == _outcome(jseg.transition_indices, left, right, min_phase_size=10,
                           num_segments=2)
    assert got.startswith("ValueError: no phase found")
    right[50:53] = -50.0  # a 3-sample glitch inside single support
    right[100:] = -50.0
    assert tseg.transition_indices(left, right, num_segments=2) == [0, 100]


PROTOCOLS = {"4x2": dict(), "3x3": dict(n_trechos=3, n_cycles=3),
             "2x1": dict(n_trechos=2, n_cycles=1)}


@pytest.fixture(scope="module", params=list(PROTOCOLS))
def captures(request, tmp_path_factory):
    kw = PROTOCOLS[request.param]
    path = tmp_path_factory.mktemp("seg") / "capture.csv"
    ttesting.write_synthetic_capture(str(path), state_len=40, n_markers=2, seed=9, **kw)
    port, ref = mt.load_vicon_file(path), mst.load_vicon_file(path)
    return kw, port, ref, tseg.Segmenter(port, **kw), jseg.Segmenter(ref, **kw)


def _key(k):
    return getattr(k, "name", k)


def test_segments_match_jax(captures):
    kw, _, _, port, ref = captures
    got = {_key(t): {_key(c): [(p.value, s) for p, s in phases.items()]
                     for c, phases in cycles.items()}
           for t, cycles in port.segments.items()}
    want = {_key(t): {_key(c): [(p.value, s) for p, s in phases.items()]
                      for c, phases in cycles.items()}
            for t, cycles in ref.segments.items()}
    assert got == want
    assert len(got) == kw.get("n_trechos", 4)


def test_transitions_sit_on_the_written_state_boundaries(captures):
    kw, port_data, _, _, _ = captures
    n_trechos, n_cycles = kw.get("n_trechos", 4), kw.get("n_cycles", 2)
    left, right = (p.array[:, p.coords.index("Fz")] for p in port_data.forcepl)
    idx = tseg.transition_indices(left, right,
                                  num_segments=n_trechos * (4 * n_cycles + 2))
    assert idx == [40 * k for k in range(n_trechos * (4 * n_cycles + 2))]


def test_every_query_matches_jax(captures):
    kw, _, _, port, ref = captures
    trechos = range(1, kw.get("n_trechos", 4) + 1)
    cycles = range(1, kw.get("n_cycles", 2) + 1)
    for t in trechos:
        assert port.get_times_of(t) == ref.get_times_of(t)
        for i in range(1, 5):
            assert port.ith_phase(t, i).value == ref.ith_phase(t, i).value
        for c in cycles:
            assert port.get_times_of(t, c) == ref.get_times_of(t, c)
            assert port.get_times_of((t, c)) == ref.get_times_of((t, c))
            for phase in ("DAA", "as", "DAE", "BL", 1, 2, 3, 4):
                assert port.get_times_of(t, c, phase) == ref.get_times_of(t, c, phase)
                assert port.get_times_of((t, c, phase)) == ref.get_times_of(
                    (t, c, phase))
    if not kw:  # the reference protocol is keyed by the enums
        assert port.get_times_of(tseg.Trecho.THIRD, tseg.Cycle.SECOND,
                                 tseg.Phase.BL) == ref.get_times_of(
            jseg.Trecho.THIRD, jseg.Cycle.SECOND, jseg.Phase.BL)


BAD_QUERIES = [
    ((9,), {}), ((1, 9), {}), ((0,), {}), ((1, 1, "XX"), {}), ((1,), dict(phase="BL")),
    (((1, 1), 1), {}), (((1,),), {}), (((1, None, "BL"),), {}),
]


@pytest.mark.parametrize("args, kw", BAD_QUERIES)
def test_query_errors_match_jax(captures, args, kw):
    _, _, _, port, ref = captures
    with pytest.raises(Exception) as want:
        ref.get_times_of(*args, **kw)
    with pytest.raises(type(want.value)) as got:
        port.get_times_of(*args, **kw)
    assert str(got.value) == str(want.value)


def test_segmenter_errors_match_jax(captures):
    _, port_data, ref_data, port, ref = captures
    for i in (0, 5):
        with pytest.raises(IndexError) as want:
            ref.ith_phase(1, i)
        with pytest.raises(IndexError) as got:
            port.ith_phase(1, i)
        assert str(got.value) == str(want.value)
    for kw in (dict(n_trechos=0), dict(n_cycles=0)):
        with pytest.raises(ValueError) as want:
            jseg.Segmenter(ref_data, **kw)
        with pytest.raises(ValueError) as got:
            tseg.Segmenter(port_data, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jseg.Segmenter(ref_data, n_trechos=9)
    with pytest.raises(ValueError) as got:
        tseg.Segmenter(port_data, n_trechos=9)
    assert str(got.value) == str(want.value)


def test_phase_summary_and_reactions_match_jax(captures):
    pd = pytest.importorskip("pandas")
    _, port_data, ref_data, port, ref = captures
    pd.testing.assert_frame_equal(tseg.phase_summary(port_data, port),
                                  jseg.phase_summary(ref_data, ref), rtol=1e-12)
    env = pd.DataFrame(np.abs(port_data.emg.array), columns=list(port_data.emg.coords))
    pd.testing.assert_frame_equal(tseg.phase_summary(port_data, port, emg_df=env),
                                  jseg.phase_summary(ref_data, ref, emg_df=env),
                                  rtol=1e-12)
    for a, b in zip(tseg.reactions(port_data), jseg.reactions(ref_data)):
        pd.testing.assert_series_equal(a, b)


def _cycles(data, segmenter):
    """Every gait cycle's EMG, stop inclusive, as ``phase_summary`` cuts."""
    out = []
    for trecho, cycles in segmenter.segments.items():
        for cycle in cycles:
            times = segmenter.get_times_of(trecho, cycle)
            start, stop = data.emg.to_index(times.start), data.emg.to_index(times.stop)
            out.append(data.emg.array[start:stop + 1])
    return out


def test_capture_to_vaf_slice_matches_jax(tmp_path):
    paths = [ttesting.write_synthetic_capture(str(tmp_path / f"c{i}.csv"),
                                              state_len=100 + 20 * i, n_markers=2,
                                              seed=i) for i in range(2)]
    port_trials = [c for d in mt.io.load_vicon_files(paths)
                   for c in _cycles(d, tseg.Segmenter(d))]
    ref_trials = [c for p in paths
                  for c in _cycles(mst.load_vicon_file(p), jseg.Segmenter(
                      mst.load_vicon_file(p)))]
    assert len(port_trials) == 16
    assert sorted({t.shape[0] for t in port_trials}) == [400, 480]
    for a, b in zip(port_trials, ref_trials):
        np.testing.assert_array_equal(a, b)
    kw = dict(ranks=(1, 2), max_iter=200)
    tres = mt.analyze_dataset(port_trials, FS, device="cpu", dtype=torch.float64, **kw)
    jres = mst.analyze_dataset(ref_trials, FS, **kw)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tres.n_iter[1:], jres.n_iter[1:])
    assert tres.channel_names is None


def test_device_data_trials_name_their_channels(tmp_path):
    path = ttesting.write_synthetic_capture(str(tmp_path / "c.csv"), state_len=100,
                                            n_markers=2, seed=3)
    port, ref = mt.load_vicon_file(path), mst.load_vicon_file(path)
    kw = dict(ranks=(1, 2), max_iter=100)
    tres = mt.analyze_dataset([port.emg, port.emg.array[:3000]], FS, device="cpu",
                              dtype=torch.float64, **kw)
    jres = mst.analyze_dataset([ref.emg, ref.emg.array[:3000]], FS, **kw)
    assert tres.channel_names == jres.channel_names == list(ttesting.GAIT_MUSCLES)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    pre = mt.preprocess_trials([port.emg], FS, device="cpu")
    np.testing.assert_array_equal(pre.numpy(), mt.preprocess_trials(
        [port.emg.array], FS, device="cpu").numpy())
    tv = mt.analyze_dataset_time_varying([port.emg], FS, n_synergies=2, n_lags=4,
                                         n_inits=2, max_iter=30, device="cpu")
    assert tv.channel_names == list(ttesting.GAIT_MUSCLES)
