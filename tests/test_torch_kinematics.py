"""PyTorch port: kinematics and force-plate metrics against the JAX package.

Every function of ``muscle_synergies_tpu_torch.ops.kinematics`` on the
same seeded float64 inputs as ``muscle_synergies_tpu.ops.kinematics``,
to 1e-12 relative: derivatives of orders 1-2, marker speed, the
upsampling onto the fast time base (2-D and 1-D, default and given
lengths, past the last slow sample), CoP path and impulse with and
without a mask, and the loading rate at odd and even windows (numpy's
"same" centring, which ``jnp.convolve`` keeps).  The port keeps its
input's device and a float32 input's dtype.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu.ops import kinematics as jk  # noqa: E402
from muscle_synergies_tpu_torch.ops import kinematics as tk  # noqa: E402

RTOL = 1e-12


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= RTOL * scale


def _traj(seed, n=120, d=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 100.0
    return np.sin(t[:, None] * (1 + rng.random(d)) * 6) * 300 + rng.standard_normal((n, d))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("shape", [(50, 3), (7, 2), (40,)])
def test_finite_difference_matches_jax(order, shape):
    x = np.random.default_rng(order).standard_normal(shape)
    _close(tk.finite_difference(x, 250.0, order), jk.finite_difference(x, 250.0, order))


@pytest.mark.parametrize("name", ["marker_velocity", "marker_acceleration",
                                  "marker_speed"])
def test_marker_kinematics_match_jax(name):
    traj = _traj(1)
    _close(getattr(tk, name)(traj, 100.0), getattr(jk, name)(traj, 100.0))


@pytest.mark.parametrize("num_fast", [None, 1003, 2000, 95])
@pytest.mark.parametrize("one_d", [False, True])
def test_upsample_to_fast_matches_jax(num_fast, one_d):
    slow = _traj(2, n=100)
    if one_d:
        slow = slow[:, 0]
    got = tk.upsample_to_fast(slow, 20, num_fast)
    _close(got, jk.upsample_to_fast(slow, 20, num_fast))
    assert got.shape[0] == (num_fast or 2000)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims", [2, 3])
def test_cop_path_length_matches_jax(masked, dims):
    rng = np.random.default_rng(3)
    cop = np.cumsum(rng.standard_normal((300, dims)), axis=0)
    mask = (rng.random(300) > 0.3).astype(float) if masked else None
    _close(tk.cop_path_length(cop, mask), jk.cop_path_length(cop, mask))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(400,), (400, 3)])
def test_grf_impulse_matches_jax(masked, shape):
    rng = np.random.default_rng(4)
    force = rng.standard_normal(shape) * 100 - 300
    mask = (rng.random(400) > 0.5).astype(float) if masked else None
    _close(tk.grf_impulse(force, 2000.0, mask), jk.grf_impulse(force, 2000.0, mask))


@pytest.mark.parametrize("window", [1, 2, 3, 4, 5, 8, 11])
def test_loading_rate_matches_jax_at_odd_and_even_windows(window):
    rng = np.random.default_rng(window)
    fz = np.concatenate([np.zeros(20), np.linspace(0, -800, 60) ** 2 / 800,
                         -800 + rng.standard_normal(120)])
    _close(tk.loading_rate(fz, 2000.0, window), jk.loading_rate(fz, 2000.0, window))


@pytest.mark.parametrize("n, w", [(30, 4), (30, 5), (6, 9), (5, 10), (12, 1)])
def test_convolve_same_keeps_numpy_centring(n, w):
    rng = np.random.default_rng(n + w)
    a, v = rng.standard_normal(n), rng.random(w)
    got = tk._convolve_same(torch.as_tensor(a), torch.as_tensor(v)).numpy()
    want = np.convolve(a, v, mode="same")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_kinematics_keep_the_input_dtype_and_device():
    traj = torch.as_tensor(_traj(5), dtype=torch.float32)
    for out in (tk.marker_velocity(traj, 100.0), tk.marker_speed(traj, 100.0),
                tk.upsample_to_fast(traj, 20), tk.cop_path_length(traj[:, :2]),
                tk.grf_impulse(traj, 100.0), tk.loading_rate(traj[:, 2], 100.0)):
        assert out.dtype == torch.float32 and out.device == traj.device
    assert tk.marker_speed(_traj(5), 100.0).dtype == torch.float64
