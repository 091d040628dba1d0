"""PyTorch port: the chunked scans of K3 and K6, and per-trial lengths.

The CUDA kernels run each SOS pass as three phases over time chunks: a
sweep of every chunk from a zero state to its final state ``r_j``, the
entry states ``entry_j = A^Lc entry_{j-1} + r_{j-1}``, and a sweep of
every chunk from its entry state.  ``filter_cuda.chunked_cascade_plain``
mirrors that algebra in float64 and is held here to the sequential
recurrence (``filters._cascade``) within 1e-12 x max|y| (and x max|zf|):
at a 4 Hz cutoff and 2 kHz the chunk power's entries reach 1e5, and its
float64 product with the entry state stands up to 8e-13 from the
sequential pass, which itself stands ~2e-13 from an extended-precision
one.  Against the JAX package's ``sosfilt`` (its blocked associative
scan) and ``cascade_pallas`` (interpret mode) the bars are those of
``tests/test_torch_cascade.py``: 1e-9 x max|y| and 1e-7 x max|zf| for
the scan, 1e-10 for the sequential Pallas kernel.

K3's plain version with ``lengths`` filters each trial of a padded batch
over its own length; it is held to scipy and to the JAX package's
``sosfiltfilt`` on each trial alone (1e-9 x max|y|, as
``tests/test_torch_filters.py``), and the ragged zero-phase
``preprocess_trials`` goes through it once, equal to the JAX package's
per-length batches within ``test_ragged_trials_match_jax``'s 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from scipy import signal as sps  # noqa: E402

from muscle_synergies_tpu.dataset import preprocess_trials as j_preprocess_trials  # noqa: E402
from muscle_synergies_tpu.ops import filters as jf  # noqa: E402
from muscle_synergies_tpu.ops.filter_pallas import cascade_pallas  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch.ops import filter_cuda, filters  # noqa: E402

N = 2000
X = torch.as_tensor(np.abs(np.random.default_rng(31).standard_normal((N, 3))))
DESIGNS = {  # 1, 2, 4 and 2 sections
    "butter2 4Hz@2kHz": sps.butter(2, 4.0, output="sos", fs=2000.0),
    "butter4 4Hz@2kHz": sps.butter(4, 4.0, output="sos", fs=2000.0),
    "butter8 40Hz@1kHz": sps.butter(8, 40.0, output="sos", fs=1000.0),
    "bandpass 20-300Hz@1kHz": sps.butter(2, [20.0, 300.0], btype="bandpass",
                                         output="sos", fs=1000.0),
}
CHUNKS = [1, 7, 64, N - 1, N, N + 1]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _zi(sos, kind):
    sos = filters._normalize_sos(sos)
    if kind == "zero":
        return torch.zeros((len(sos), 2, X.shape[1]), dtype=torch.float64)
    return torch.as_tensor(filters.sosfilt_zi(sos))[:, :, None] * X[0]


@pytest.fixture(scope="module")
def references():
    """Per design and zi: the sequential pass, JAX's scan, the Pallas kernel."""
    out = {}
    for name, sos in DESIGNS.items():
        for kind in ("zero", "given"):
            zi = _zi(sos, kind)
            seq = filters._cascade(filters._normalize_sos(sos), X, zi)
            scan = jf.sosfilt(sos, X.numpy(), zi=zi.numpy(), return_zf=True)
            pallas = np.asarray(cascade_pallas(sos, X.numpy(), zi.numpy(),
                                               interpret=True))
            out[name, kind] = seq, scan, pallas
    return out


@pytest.mark.parametrize("kind", ["zero", "given"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("design", list(DESIGNS))
def test_chunk_algebra_matches_the_sequential_pass_and_jax(references, design, chunk,
                                                           kind):
    sos = DESIGNS[design]
    (y_seq, zf_seq), (y_scan, zf_scan), y_pallas = references[design, kind]
    y, zf = filter_cuda.chunked_cascade_plain(sos, X, _zi(sos, kind), chunk)
    assert y.shape == (N, 3) and zf.shape == (len(sos), 2, 3)
    assert _rel(y, y_seq) < 1e-12 and _rel(zf, zf_seq) < 1e-12
    assert _rel(y, y_scan) < 1e-9 and _rel(zf, zf_scan) < 1e-7
    assert _rel(y, y_pallas) < 1e-10


def test_chunk_power_is_the_state_map_of_a_chunk():
    sos = filters._normalize_sos(DESIGNS["butter4 4Hz@2kHz"])
    z0 = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 2, 1)))
    for chunk in (1, 5, 300):
        # a chunk of zeros from z0 ends at A^chunk z0
        _, zf = filters._cascade(sos, torch.zeros((chunk, 1), dtype=torch.float64), z0)
        want = filter_cuda.chunk_power(sos, chunk) @ z0.reshape(4, 1).numpy()
        assert _rel(zf.reshape(4, 1), want) < 1e-12


SOS = filters.sos_design(4, 4.0, 1000.0)
LENGTHS = [1500, 1100, 37, 1499]  # 37: one more than the default padlen 36


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_per_trial_lengths_filter_each_trial_alone(padtype):
    rng = np.random.default_rng(32)
    trials = [rng.standard_normal((n, 3)) for n in LENGTHS]
    xs = np.zeros((4, 1500, 3))
    for b, t in enumerate(trials):
        xs[b, : len(t)] = t
    padlen = filters.default_padlen(SOS) if padtype else 0
    out = filter_cuda.sosfiltfilt_plain(SOS, torch.as_tensor(xs), padlen, padtype,
                                        lengths=np.array(LENGTHS)).numpy()
    for b, t in enumerate(trials):
        mine = out[b, : len(t)]
        assert _rel(mine, sps.sosfiltfilt(SOS, t, axis=0, padtype=padtype)) < 1e-9
        assert _rel(mine, jf.sosfiltfilt(SOS, t, padtype=padtype)) < 1e-9
        assert not out[b, len(t):].any()
    with pytest.raises(ValueError, match="greater than padlen"):
        filter_cuda.sosfiltfilt_plain(SOS, torch.as_tensor(xs), padlen, padtype,
                                      lengths=np.array([1500, 1100, padlen, 1499]))


def test_ragged_zero_phase_preprocess_is_one_filter_call(monkeypatch):
    rng = np.random.default_rng(33)
    trials = [rng.standard_normal((n, 8)) * np.abs(np.sin(np.arange(n) / 90.0))[:, None]
              for n in (1500, 1100, 1300, 1100)]
    calls = []
    plain = filter_cuda.sosfiltfilt_plain
    monkeypatch.setattr(filter_cuda, "sosfiltfilt_plain",
                        lambda *a: calls.append([int(v) for v in a[4]]) or plain(*a))
    mine = mt.preprocess_trials(trials, 1000.0, device="cpu").numpy()
    # one call for the padded batch, with each trial's own length
    assert calls == [[1500, 1100, 1300, 1100]]
    ref = np.asarray(j_preprocess_trials(trials, 1000.0))
    assert mine.shape == ref.shape == (4, 200, 8)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)
