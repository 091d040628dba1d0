"""PyTorch port: EMG transforms, batched preprocessing and PipelineConfig vs JAX.

Same float64 inputs (NumPy seeds) through the JAX package's functions
and the port's.  Time normalization is held to 1e-12: both packages
build the same grids (``numpy.linspace`` equals ``jnp.linspace``) and
``jnp.interp``'s formula, so only the last ulp of ``arange / (n - 1)``
can differ (XLA multiplies by the folded reciprocal where the divisor
is a constant).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from scipy import signal as sps  # noqa: E402

from muscle_synergies_tpu.ops import batched as jb  # noqa: E402
from muscle_synergies_tpu.ops import emg as je  # noqa: E402
from muscle_synergies_tpu.models.batch import pad_and_stack as j_pad_and_stack  # noqa: E402
from muscle_synergies_tpu.utils.config import PipelineConfig as JConfig  # noqa: E402
from muscle_synergies_tpu_torch.models.batch import pad_and_stack  # noqa: E402
from muscle_synergies_tpu_torch.ops import batched as tb  # noqa: E402
from muscle_synergies_tpu_torch.ops import emg as te  # noqa: E402
from muscle_synergies_tpu_torch.utils.config import PipelineConfig  # noqa: E402

RNG = np.random.default_rng(21)
FS = 1000.0


def _envelopes(b, n, l):
    """Smooth non-negative envelopes, like the pipeline's resampler input."""
    raw = np.abs(RNG.standard_normal((b, n, l)))
    return sps.sosfiltfilt(sps.butter(4, 6.0, fs=FS, output="sos"), raw, axis=1)


@pytest.mark.parametrize("n,reduce_to", [(1500, 200), (37, 200), (200, 7)])
def test_time_normalize_matches_jax(n, reduce_to):
    x = _envelopes(1, n, 5)[0]
    mine = te.time_normalize(x, reduce_to).numpy()
    np.testing.assert_allclose(mine, np.asarray(je.time_normalize(x, reduce_to)),
                               rtol=0, atol=1e-12)
    one = te.time_normalize(x[:, 0], reduce_to)
    assert one.shape == (reduce_to,)


def test_time_normalize_batch_matches_jax_equal_and_ragged():
    xs = _envelopes(3, 1500, 8)
    mine = tb.time_normalize_batch(xs, 200).numpy()
    ref = np.asarray(jb.time_normalize_batch(jnp.asarray(xs), 200))
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-12)
    trials = [xs[0], xs[1][:900], xs[2][:1234]]
    padded, mask = pad_and_stack(trials)
    jpadded, jmask = j_pad_and_stack(trials)
    np.testing.assert_array_equal(padded, jpadded)
    np.testing.assert_array_equal(mask, jmask)
    mine = tb.time_normalize_batch(padded, 200, mask=mask).numpy()
    ref = np.asarray(jb.time_normalize_batch(jnp.asarray(padded), 200, jnp.asarray(mask)))
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-12)
    # a ragged trial resamples exactly like the same trial on its own
    np.testing.assert_allclose(mine[1], te.time_normalize(trials[1], 200).numpy(),
                               rtol=0, atol=1e-12)


def test_zero_center_and_normalize_batch_match_jax():
    trials = [RNG.standard_normal((300, 4)), RNG.standard_normal((250, 4))]
    padded, mask = pad_and_stack(trials)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        np.testing.assert_allclose(
            tb.zero_center_batch(padded, m).numpy(),
            np.asarray(jb.zero_center_batch(jnp.asarray(padded), jm)),
            rtol=0, atol=1e-14)
        np.testing.assert_allclose(
            tb.normalize_batch(np.abs(padded), m).numpy(),
            np.asarray(jb.normalize_batch(jnp.asarray(np.abs(padded)), jm)),
            rtol=0, atol=1e-15)
    dead = np.zeros((50, 2))
    dead[:, 1] = 1.0
    np.testing.assert_array_equal(te.normalize(dead).numpy(), dead)


def test_single_trial_transforms_match_jax():
    x = RNG.standard_normal((1500, 6))
    np.testing.assert_allclose(te.zero_center(x).numpy(),
                               np.asarray(je.zero_center(x)), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(te.rectify(x).numpy(), np.asarray(je.rectify(x)))
    np.testing.assert_allclose(te.normalize(x).numpy(),
                               np.asarray(je.normalize(x)), rtol=0, atol=1e-15)
    env = te.linear_envelope(x, 4.0, FS, 4).numpy()
    ref = np.asarray(je.linear_envelope(x, 4.0, FS, 4))
    assert np.abs(env - ref).max() < 1e-9 * np.abs(ref).max()
    causal = te.digital_filter(x, 10.0, FS, 2, zero_lag=False).numpy()
    ref = np.asarray(je.digital_filter(x, 10.0, FS, 2, zero_lag=False))
    assert np.abs(causal - ref).max() < 1e-9 * np.abs(ref).max()


def test_linear_envelope_batch_matches_jax():
    xs = RNG.standard_normal((4, 1500, 8))
    mine = tb.linear_envelope_batch(xs, 4.0, FS, 4).numpy()
    ref = np.asarray(jb.linear_envelope_batch(jnp.asarray(xs), 4.0, FS, 4))
    assert np.abs(mine - ref).max() < 1e-9 * np.abs(ref).max()


def test_pipeline_preprocess_matches_jax():
    x = RNG.standard_normal((1500, 8))
    mine = PipelineConfig().preprocess(x, FS, device="cpu").numpy()
    ref = np.asarray(JConfig().preprocess(x, FS))
    assert mine.shape == (200, 8)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)


def test_device_and_dtype_arguments():
    x = RNG.standard_normal((300, 3))
    y = te.zero_center(x, device="cpu", dtype=torch.float32)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert te.rectify(torch.as_tensor(x)).dtype == torch.float64
    assert tb.normalize_batch(x[None], dtype=torch.float32).dtype == torch.float32
