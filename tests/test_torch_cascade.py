"""PyTorch port: the causal SOS cascade (``sosfilt``) against the JAX package.

K6's plain version (``filter_cuda.sosfilt_plain``) and the port's
``sosfilt`` take the same float64 inputs as the TPU kernel
``cascade_pallas`` (in interpret mode, as ``tests/test_filter_pallas.py``
runs it) and JAX ``sosfilt(return_zf=True)``.  The port, the Pallas
kernel and scipy run the same transposed direct form II recurrence in
float64, so outputs and final states agree to rounding: the bar is
1e-10 x max|y| (and x max|zf| for the states).  JAX ``sosfilt`` runs a
blocked associative scan whose composed pole powers round: at 4 Hz
against 1-2 kHz it stands up to 3.5e-10 x max|y| and 1e-8 x max|zf|
from scipy, where the port stands within 1.3e-13.  Against it, at
those designs, the bars are 1e-9 and 1e-7.
"""

import numpy as np
import pytest
from scipy import signal as sps

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu.ops import emg as j_emg  # noqa: E402
from muscle_synergies_tpu.ops.filter_pallas import cascade_pallas  # noqa: E402
from muscle_synergies_tpu.ops.filters import sosfilt as j_sosfilt  # noqa: E402
from muscle_synergies_tpu_torch.ops import emg, filter_cuda, filters  # noqa: E402

RNG = np.random.default_rng(23)
BAR = 1e-10
JAX_SCAN_BARS = (1e-9, 1e-7)  # y, zf against JAX sosfilt at low cutoffs


def _close(mine, ref, bar=BAR):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=0, atol=bar * np.abs(ref).max())


def test_sosfilt_matches_pallas_kernel_and_jax():
    x = RNG.standard_normal((3000, 4))
    sos = sps.butter(6, 20.0, output="sos", fs=500.0)
    zi = sps.sosfilt_zi(sos)[:, :, None] * x[0]
    ref_k = np.asarray(cascade_pallas(sos, x, zi, interpret=True))
    ref_y, ref_zf = j_sosfilt(sos, x, zi=zi, return_zf=True)
    y, zf = filters.sosfilt(sos, x, zi=zi, return_zf=True)
    assert y.dtype == zf.dtype == torch.float64
    _close(y, ref_k)
    _close(y, ref_y)
    _close(zf, ref_zf)
    # K6's plain version on the (B, N, C) layout, per-trial states
    yp, zfp = filter_cuda.sosfilt_plain(sos, torch.as_tensor(x)[None],
                                        torch.as_tensor(zi)[None])
    _close(yp[0], ref_k)
    _close(zfp[0], ref_zf)


def test_zero_states_broadcast_zi_and_1d_input():
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    x = RNG.standard_normal((2000, 2))
    _close(filters.sosfilt(sos, x), cascade_pallas(sos, x, np.zeros((2, 2, 2)),
                                                   interpret=True))
    zi2 = RNG.standard_normal((2, 2))  # (S, 2): broadcast over channels
    ref_y, ref_zf = j_sosfilt(sos, x, zi=zi2, return_zf=True)
    y, zf = filters.sosfilt(sos, x, zi=zi2, return_zf=True)
    _close(y, ref_y)
    _close(zf, ref_zf)
    x1 = x[:, 0]
    ref_y, ref_zf = j_sosfilt(sos, x1, zi=zi2, return_zf=True)
    y, zf = filters.sosfilt(sos, x1, zi=zi2, return_zf=True)
    assert y.shape == (2000,) and zf.shape == (2, 2)
    _close(y, ref_y)
    _close(zf, ref_zf)
    with pytest.raises(ValueError, match="zi must have shape"):
        filters.sosfilt(sos, x, zi=np.zeros((2, 2, 3)))


def test_batch_is_one_call_with_per_trial_states():
    sos = sps.butter(4, 4.0, output="sos", fs=1000.0)
    xs = RNG.standard_normal((3, 1500, 5))
    zi = RNG.standard_normal((3, 2, 2, 5))
    y, zf = filters.sosfilt(sos, xs, zi=zi, return_zf=True)
    assert y.shape == xs.shape and zf.shape == (3, 2, 2, 5)
    for b in range(3):
        ref_y, ref_zf = sps.sosfilt(sos, xs[b], axis=0, zi=zi[b])
        _close(y[b], ref_y)
        _close(zf[b], ref_zf)
        ref_y, ref_zf = j_sosfilt(sos, xs[b], zi=zi[b], return_zf=True)
        _close(y[b], ref_y, JAX_SCAN_BARS[0])
        _close(zf[b], ref_zf, JAX_SCAN_BARS[1])
    # the causal envelope of a batch: one filter call, equal to per trial
    kw = dict(critical_freqs=4.0, sampling_frequency=1000.0, order=4,
              zero_lag=False)
    env = emg.linear_envelope(xs, **kw)
    for b in range(3):
        _close(env[b], j_emg.linear_envelope(xs[b], **kw), JAX_SCAN_BARS[0])


def test_chunks_with_carried_states_equal_one_pass():
    sos = sps.butter(4, 4.0, output="sos", fs=2000.0)
    xs = torch.as_tensor(RNG.standard_normal((2, 5000, 3)))
    zi = torch.as_tensor(filters.sosfilt_zi(sos))[None, :, :, None] * xs[:, :1, None]
    whole, zf_whole = filters.sosfilt(sos, xs, zi=zi, return_zf=True)
    state, parts = zi, []
    for start in range(0, 5000, 1024):
        y, state = filters.sosfilt(sos, xs[:, start:start + 1024], zi=state,
                                   return_zf=True)
        parts.append(y)
    _close(torch.cat(parts, dim=1), whole)
    _close(state, zf_whole)
    ref = sps.sosfilt(sos, xs.numpy(), axis=1, zi=zi.permute(1, 0, 2, 3).numpy())[0]
    _close(whole, ref)


def test_cuda_impl_refuses_a_cpu_tensor():
    sos = sps.butter(2, 4.0, output="sos", fs=1000.0)
    x = torch.rand(2, 100, 3, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        filters.sosfilt(sos, x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        filter_cuda.sosfilt_cuda(sos, x)
    with pytest.raises(ValueError, match="impl"):
        filters.sosfilt(sos, x, impl="pallas")
