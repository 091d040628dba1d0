"""PyTorch port: moving RMS, its masked batch form and the small EMG helpers.

Each function takes the same float64 inputs (made with numpy from a
seed) as its counterpart in ``muscle_synergies_tpu.ops.emg`` /
``ops.batched``.  Tolerances: on signals of ordinary dynamic range the
RMS envelopes agree to 1e-10 relative: both take windowed sums as
differences of a running sum, which rounds at float64 eps times the
sum so far (1e-11 measured for a one-sample window over 1,000).  The
running sums differ in kind: JAX carries a compensated (hi, lo) pair in
the input's dtype, the port one float64 sum.  So on a quiet tail after
a transient 10^4 times louder,
with float32 input, each is held to the float64 ``np.convolve``
reference at what its sum resolves (port 1e-6, measured 2.7e-7; JAX
1e-5, measured 2.1e-6), and the two to each other at 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu.ops import batched as j_batched  # noqa: E402
from muscle_synergies_tpu.ops import emg as j_emg  # noqa: E402
from muscle_synergies_tpu_torch.models.batch import pad_and_stack  # noqa: E402
from muscle_synergies_tpu_torch.ops import batched, emg  # noqa: E402

RNG = np.random.default_rng(31)
CPU = dict(device="cpu")


def _rel(mine, ref):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


def _reference_rms(x, w):
    return np.stack([np.sqrt(np.convolve(x[:, c] ** 2, np.ones(w) / w, "same"))
                     for c in range(x.shape[1])], axis=1)


@pytest.mark.parametrize("window", [1, 2, 7, 50, 999, 1000])
def test_moving_rms_matches_jax(window):
    x = RNG.standard_normal((1000, 3))
    mine = emg.moving_rms(x, window, **CPU)
    assert _rel(mine, j_emg.moving_rms(x, window)) < 1e-10
    assert _rel(mine, _reference_rms(x, window)) < 1e-10
    # seconds: round(size * fs) samples; 1-D input squeezes
    assert _rel(emg.moving_rms(x[:, 0], 0.025, sampling_frequency=1000.0, **CPU),
                j_emg.moving_rms(x[:, 0], 0.025, sampling_frequency=1000.0)) < 1e-10


def test_quiet_tail_after_a_transient():
    x = np.concatenate([1e2 * RNG.standard_normal((300, 2)),
                        1e-2 * RNG.standard_normal((3000, 2))]).astype(np.float32)
    w = 51
    ref = _reference_rms(x.astype(np.float64), w)
    mine = emg.moving_rms(x, w, **CPU).numpy()
    theirs = np.asarray(j_emg.moving_rms(x, w))
    tail = slice(400, None)  # windows that no longer see the transient
    assert mine.dtype == np.float32 and (mine[tail] > 0).all()
    assert _rel(mine[tail], ref[tail]) < 1e-6
    assert _rel(theirs[tail], ref[tail]) < 1e-5
    assert (np.abs(mine[tail] - theirs[tail]) / ref[tail]).max() < 1e-5


def test_moving_rms_refuses_bad_windows():
    x = RNG.standard_normal((10, 2))
    with pytest.raises(ValueError, match="at least one sample"):
        emg.moving_rms(x, 0.0001, sampling_frequency=100.0, **CPU)
    with pytest.raises(ValueError, match="longer than the signal"):
        emg.moving_rms(x, 11, **CPU)


def test_moving_rms_batch_ragged_and_masked_matches_jax():
    trials = [RNG.standard_normal((n, 4)) for n in (900, 700, 900, 650)]
    jdata, jmask = pad_and_stack(trials)
    assert jdata.shape == (4, 900, 4) and jmask.sum(axis=1).tolist() == [900, 700, 900, 650]
    data, mask = torch.as_tensor(jdata), torch.as_tensor(jmask)
    mine = batched.moving_rms_batch(data, 40, mask)
    assert _rel(mine, j_batched.moving_rms_batch(jdata, 40, jmask)) < 1e-10
    for b, t in enumerate(trials):  # each trial equals its own RMS
        assert _rel(mine[b, : len(t)], j_emg.moving_rms(t, 40)) < 1e-10
        assert (mine[b, len(t):] == 0).all()
    # equal lengths, no mask
    xs = np.stack([t[:600] for t in trials])
    assert _rel(batched.moving_rms_batch(xs, 40, **CPU),
                j_batched.moving_rms_batch(xs, 40)) < 1e-10
    # the masked zero-centring that runs before it on the RMS path
    assert _rel(batched.zero_center_batch(data, mask),
                j_batched.zero_center_batch(jdata, jmask)) < 1e-12


def test_moving_rms_batch_refuses_a_window_longer_than_a_trial():
    jdata, jmask = pad_and_stack([RNG.standard_normal((n, 2)) for n in (80, 50)])
    for mod, data, mask in ((batched, torch.as_tensor(jdata), torch.as_tensor(jmask)),
                            (j_batched, jdata, jmask)):
        with pytest.raises(ValueError, match="shortest trial"):
            mod.moving_rms_batch(data, 60, mask)
    with pytest.raises(ValueError, match="longer than the signal"):
        batched.moving_rms_batch(jdata, 81)
    with pytest.raises(ValueError, match="channel count"):
        pad_and_stack([np.zeros((3, 2)), np.zeros((3, 4))])


def test_subsample_fft_spectrum_and_vaf_match_jax():
    x = RNG.standard_normal((301, 3))
    for every in (None, 1, 4):
        assert np.array_equal(emg.subsample(x, every, **CPU).numpy(),
                              np.asarray(j_emg.subsample(x, every)))
    freqs, ampl = emg.fft_spectrum(x, 1000.0, **CPU)
    jfreqs, jampl = j_emg.fft_spectrum(x, 1000.0)
    np.testing.assert_array_equal(freqs, jfreqs)
    assert _rel(ampl, jampl) < 1e-12
    rec = x + 0.1 * RNG.standard_normal(x.shape)
    overall, per = emg.vaf(x, rec, **CPU)
    joverall, jper = j_emg.vaf(x, rec)
    assert abs(float(overall) - float(joverall)) < 1e-12
    assert _rel(per, jper) < 1e-12
