"""PyTorch port: the JAX package's random draws, without jax.

``muscle_synergies_tpu_torch._prng`` reproduces jax's default generator
(Threefry-2x32, partitionable) in NumPy.  Held here to jax itself: keys,
splits and fold-ins equal, uniform draws equal bit for bit in float32
and float64, normal draws within 1e-12 relative in float64 and 1e-5 in
float32 (torch's inverse error function against XLA's; XLA's float32
one is a polynomial).  Then the draws where the port uses them: the
``nndsvdar`` fill and the ``random`` init of ``models.init`` equal the
JAX package's to 1e-12 relative (``generator=`` is covered in
``test_torch_nmf.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from muscle_synergies_tpu.models import init as jinit  # noqa: E402
from muscle_synergies_tpu_torch import _prng  # noqa: E402
from muscle_synergies_tpu_torch.models import init as tinit  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(), (7,), (3, 5), (4, 3, 2)]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_ins_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = _prng.prng_key(seed)
    np.testing.assert_array_equal(mine, np.asarray(key))
    for num in (2, 5):
        np.testing.assert_array_equal(_prng.split(mine, num),
                                      np.asarray(jax.random.split(key, num)))
    for data in (0, 3, 1000):
        np.testing.assert_array_equal(_prng.fold_in(mine, data),
                                      np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_draws_equal_jax_bit_for_bit(seed, dtype):
    key, mine = jax.random.PRNGKey(seed), _prng.prng_key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(key, shape, dtype=dtype))
        got = _prng.uniform(mine, shape, dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                      want.view(f"u{want.itemsize}"))
    sub = jax.random.fold_in(jax.random.split(key)[1], 7)
    np.testing.assert_array_equal(
        _prng.uniform(_prng.fold_in(_prng.split(mine)[1], 7), (6, 4), dtype),
        np.asarray(jax.random.uniform(sub, (6, 4), dtype=dtype)))


@pytest.mark.parametrize("dtype, bar", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_draws_match_jax(seed, dtype, bar):
    key, mine = jax.random.PRNGKey(seed), _prng.prng_key(seed)
    for shape in SHAPES + [(60, 40)]:
        want = np.asarray(jax.random.normal(key, shape, dtype=dtype))
        got = _prng.normal(mine, shape, dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=bar, atol=0)


X = np.random.default_rng(70).random((3, 30, 6))


@pytest.mark.parametrize("seed", [0, 5])
def test_random_inits_draw_what_jax_draws(seed):
    """``init="random"`` (sklearn's pick for k > min(N, L)) and the
    ``nndsvdar`` fill, one problem and a batch: every problem of a batch
    gets the JAX package's draw, as under its ``vmap``."""
    tw, th = tinit.initialize_nmf(torch.as_tensor(X), 9, seed=seed)
    sw, sh = tinit.nndsvd(torch.as_tensor(X), 4, variant="nndsvdar", seed=seed)
    for b in range(X.shape[0]):
        jw, jh = jinit.initialize_nmf(jnp.asarray(X[b]), 9, seed=seed)
        np.testing.assert_allclose(tw[b].numpy(), np.asarray(jw), rtol=1e-12, atol=0)
        np.testing.assert_allclose(th[b].numpy(), np.asarray(jh), rtol=1e-12, atol=0)
        jw, jh = jinit.nndsvd(jnp.asarray(X[b]), 4, variant="nndsvdar", seed=seed)
        np.testing.assert_allclose(sw[b].numpy(), np.asarray(jw), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(sh[b].numpy(), np.asarray(jh), rtol=1e-12, atol=1e-15)
    one_w, one_h = tinit.initialize_nmf(torch.as_tensor(X[1]), 9, seed=seed)
    assert torch.equal(one_w, tw[1]) and torch.equal(one_h, th[1])


def test_float32_inits_draw_in_float32():
    x = torch.as_tensor(X[0], dtype=torch.float32)
    w, h = tinit.initialize_nmf(x, 9, seed=2)
    assert w.dtype == h.dtype == torch.float32
    jw, jh = jinit.initialize_nmf(jnp.asarray(X[0], dtype=jnp.float32), 9, seed=2)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-7)
