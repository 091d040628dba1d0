"""PyTorch port: SOS filter design and zero-phase filtering vs scipy and JAX.

The port's plain ``sosfiltfilt`` (the CUDA kernel's reference) against
``scipy.signal.sosfiltfilt``, the JAX package's scan path and its Pallas
kernel in interpret mode, all in float64.  Tolerance 1e-9 x max|y|: the
JAX scan sits ~1e-10 from scipy at 1500 x 8 (associative-scan
reordering), the sequential recurrences ~1e-13.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from scipy import signal as sps  # noqa: E402

from muscle_synergies_tpu.ops import filters as jf  # noqa: E402
from muscle_synergies_tpu.ops.filter_pallas import sosfiltfilt_pallas  # noqa: E402
from muscle_synergies_tpu_torch.ops import filter_cuda  # noqa: E402
from muscle_synergies_tpu_torch.ops import filters as tf  # noqa: E402

TOL = 1e-9  # x max|y|
RNG = np.random.default_rng(11)
X = RNG.standard_normal((1500, 8))
SOS = tf.sos_design(4, 4.0, 1000.0)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max())


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_sosfiltfilt_matches_scipy_jax_scan_and_pallas(padtype):
    ref = sps.sosfiltfilt(SOS, X, axis=0, padtype=padtype)
    mine = tf.sosfiltfilt(SOS, X, padtype=padtype).numpy()
    scan = np.asarray(jf.sosfiltfilt(SOS, X, padtype=padtype, impl="scan"))
    pallas = np.asarray(sosfiltfilt_pallas(SOS, X, padtype=padtype, interpret=True))
    assert _rel(mine, ref) < TOL
    assert _rel(mine, scan) < TOL
    assert _rel(mine, pallas) < TOL


@pytest.mark.parametrize(
    "design",
    [
        dict(order=2, critical_freqs=[20.0, 300.0], band_type="bandpass"),
        dict(order=4, critical_freqs=50.0, band_type="highpass"),
        dict(order=3, critical_freqs=40.0, filter_type="cheby1", cheby_param=1.0),
    ],
)
def test_other_designs_match_scipy(design):
    sos = tf.sos_design(sampling_frequency=1000.0, **design)
    np.testing.assert_array_equal(sos, jf.sos_design(sampling_frequency=1000.0, **design))
    ref = sps.sosfiltfilt(sos, X[:400], axis=0)
    assert _rel(tf.sosfiltfilt(sos, X[:400]), ref) < TOL


def test_batch_and_1d_inputs():
    xb = RNG.standard_normal((3, 500, 4))
    ref = sps.sosfiltfilt(SOS, xb, axis=1)
    assert _rel(tf.sosfiltfilt(SOS, xb), ref) < TOL
    one = tf.sosfiltfilt(SOS, xb[0, :, 0])
    assert one.shape == (500,)
    assert _rel(one, ref[0, :, 0]) < TOL


def test_explicit_padlen_and_float32():
    ref = sps.sosfiltfilt(SOS, X, axis=0, padlen=64)
    assert _rel(tf.sosfiltfilt(SOS, X, padlen=64), ref) < TOL
    y32 = tf.sosfiltfilt(SOS, X, dtype=torch.float32)
    assert y32.dtype == torch.float32
    # a float32 state accumulates rounding near the 4 Hz poles: measured
    # 1.2e-4 x max|y| here; held to the kernels' 5e-4 filtfilt bar
    assert _rel(y32, sps.sosfiltfilt(SOS, X, axis=0)) < 5e-4


def test_zi_and_padlen_helpers():
    np.testing.assert_allclose(tf.sosfilt_zi(SOS), sps.sosfilt_zi(SOS), rtol=1e-12)
    np.testing.assert_allclose(tf.sosfilt_zi(SOS), jf.sosfilt_zi(SOS), rtol=0, atol=0)
    assert tf.default_padlen(SOS) == jf.default_padlen(SOS) == 15


def test_sosfilt_matches_scipy():
    zi = sps.sosfilt_zi(SOS)[:, :, None] * X[0]
    ref, _ = sps.sosfilt(SOS, X, axis=0, zi=zi)
    assert _rel(tf.sosfilt(SOS, X, zi=zi), ref) < TOL
    assert _rel(tf.sosfilt(SOS, X), sps.sosfilt(SOS, X, axis=0)) < TOL


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_fold_extend_matches_jax_extensions(padtype):
    xb = RNG.standard_normal((2, 50, 3))
    padlen = 9 if padtype else 0
    ext = tf.fold_extend(torch.as_tensor(xb), padlen, padtype).numpy()
    for b in range(2):
        want = jf._EXTENSIONS[padtype](xb[b], padlen) if padtype else xb[b]
        np.testing.assert_array_equal(ext[:, b * 3 : (b + 1) * 3], np.asarray(want))


def test_kernel_plain_version_matches_scipy():
    xb = RNG.standard_normal((2, 300, 3))
    y = filter_cuda.sosfiltfilt_plain(SOS, torch.as_tensor(xb), 15, "odd")
    assert _rel(y, sps.sosfiltfilt(SOS, xb, axis=1)) < TOL


def test_errors_match_scipy_rules():
    with pytest.raises(ValueError, match="padlen"):
        tf.sosfiltfilt(SOS, np.ones((10, 2)))
    with pytest.raises(ValueError, match="padtype"):
        tf.sosfiltfilt(SOS, X, padtype="reflect")
    with pytest.raises(ValueError, match="impl"):
        tf.sosfiltfilt(SOS, X, impl="pallas")
    with pytest.raises(ValueError, match="filter type"):
        tf.sos_design(4, 4.0, 1000.0, filter_type="bessel")


def test_cuda_impl_refuses_cpu_tensors():
    # "auto" takes the plain version on the CPU; an explicit "cuda" raises
    with pytest.raises(ValueError, match="CUDA"):
        tf.sosfiltfilt(SOS, X, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        filter_cuda.sosfiltfilt_cuda(SOS, torch.zeros(1, 100, 2), 15, "odd")
