"""PyTorch port: the pandas-level ``analysis`` API against the JAX package's.

Every function gets the same float64 DataFrames (EMG-like noise made
with numpy from a seed) on both sides, the port on the CPU.  The
transforms agree to 1e-12 relative, apart from the filters: JAX runs
them as a blocked associative scan that sits up to ~1e-10 x max|y|
from scipy, where the port's recurrence sits ~1e-13 from it (see
``tests/test_torch_filters.py`` and ``test_torch_cascade.py``), so
their bar is 1e-9 x max|y|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
pandas = pytest.importorskip("pandas")

from muscle_synergies_tpu import analysis as ja  # noqa: E402
from muscle_synergies_tpu_torch import analysis as ta  # noqa: E402
from muscle_synergies_tpu_torch.models import select  # noqa: E402

CPU = dict(device="cpu")
FS = 1000
RNG = np.random.default_rng(17)
DF = pandas.DataFrame(RNG.standard_normal((1500, 4)) * np.linspace(0.5, 2.0, 1500)[:, None],
                      columns=["ta", "gm", "sol", "vl"])


def _same(mine, ref, bar=1e-12):
    assert list(mine.columns) == list(ref.columns)
    np.testing.assert_allclose(np.asarray(mine.index), np.asarray(ref.index),
                               rtol=0, atol=1e-12)
    m, r = mine.to_numpy(), ref.to_numpy()
    np.testing.assert_allclose(m, r, rtol=0, atol=bar * np.abs(r).max())


@pytest.mark.parametrize("zero_lag, padtype", [(True, "odd"), (True, None),
                                               (False, "odd")])
def test_filters_and_envelopes_match_jax(zero_lag, padtype):
    bar = 1e-9
    kw = dict(critical_freqs=[20.0, 300.0], sampling_frequency=FS, order=2,
              band_type="bandpass", zero_lag=zero_lag, padtype=padtype)
    _same(ta.digital_filter(DF, **kw, **CPU), ja.digital_filter(DF, **kw), bar)
    env = dict(critical_freqs=6.0, sampling_frequency=FS, order=4, zero_lag=zero_lag)
    _same(ta.linear_envelope(DF, **env, **CPU), ja.linear_envelope(DF, **env), bar)
    with pytest.raises(ValueError, match="filter type"):
        ta.digital_filter(DF, 6.0, FS, 4, filter_type="bessel", **CPU)


def test_pointwise_transforms_and_inplace_match_jax():
    _same(ta.zero_center(DF, **CPU), ja.zero_center(DF))
    _same(ta.normalize(DF, **CPU), ja.normalize(DF))
    _same(ta.rms(DF, 25, **CPU), ja.rms(DF, 25), 1e-10)
    _same(ta.rms(DF, 0.05, sampling_frequency=FS, **CPU),
          ja.rms(DF, 0.05, sampling_frequency=FS), 1e-10)
    assert ta.subsample(DF, 3).equals(ja.subsample(DF, 3))
    assert ta.subsample(DF).equals(DF)
    copy = DF.copy()
    out = ta.zero_center(copy, inplace=True, **CPU)
    assert out is copy and abs(copy.to_numpy().mean()) < 1e-12
    assert ta.zero_center(DF, **CPU) is not DF


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_time_normalize_matches_jax(kind):
    _same(ta.time_normalize(DF, 200, kind=kind, **CPU),
          ja.time_normalize(DF, 200, kind=kind))


def test_fft_spectrum_and_vaf_match_jax():
    _same(ta.fft_spectrum(DF, FS, **CPU), ja.fft_spectrum(DF, FS))
    w = np.abs(RNG.standard_normal((1500, 2)))
    h = np.abs(RNG.standard_normal((2, 4)))
    _same(ta.vaf(DF, transformed_signal=w, components=h, **CPU),
          ja.vaf(DF, transformed_signal=w, components=h))
    rec = DF.to_numpy() * 0.9
    _same(ta.vaf(DF, reconstructed_signal=rec, **CPU),
          ja.vaf(DF, reconstructed_signal=rec))


def test_reexports_the_synergy_api():
    assert ta.find_synergies is select.find_synergies
    assert ta.NMFModel is select.NMFModel
    assert ta.SynergyRunResult is select.SynergyRunResult
