"""The JAX package's random draws, reproduced without jax.

The JAX package draws its random inits with ``jax.random`` (the
``nndsvdar`` fill and the ``random`` init of ``models/init.py``, the
default activations of ``cnmf_transform`` and the default coefficients
of ``nm3f_transform``).  jax 0.9's default generator is Threefry-2x32
with ``jax_threefry_partitionable`` on, a pure 32-bit integer hash, so
its draws can be computed here bit for bit without jax:

- :func:`prng_key` is ``jax.random.PRNGKey(seed)`` (the seed as a 64-bit
  two's complement integer split into two words; seeds in
  ``[0, 2**31)`` give the same key with and without jax's x64 mode);
- :func:`split` and :func:`fold_in` are ``jax.random.split`` and
  ``jax.random.fold_in``;
- :func:`uniform` is ``jax.random.uniform`` in float32 or float64,
  equal to jax's bit for bit;
- :func:`normal` is ``jax.random.normal``: a uniform draw on
  ``(nextafter(-1, 0), 1)``, equal bit for bit, mapped through
  ``sqrt(2) * erfinv``.  The inverse error function is torch's, in
  float64, and XLA's may differ in the last ulps: float64 draws agree
  with jax's to 1e-12 relative.  float32 draws are the float64 value
  rounded once; XLA evaluates a float32 polynomial, so they agree with
  jax's to 1e-5 relative.

Keys are ``(2,)`` uint32 arrays, as jax's raw keys.  These run on the
host; callers move the draws to their device.  :func:`uniform_torch`
and :func:`fold_in_torch` compute the same bits with PyTorch integer
operations on any device (the words held in int64), so a transform's
default start is drawn inside its traced program, for a batch size
known only when it is called.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fold_in", "fold_in_torch", "normal", "prng_key", "split", "uniform",
           "uniform_torch"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotate_left(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the count words ``(x0, x1)`` under ``key``: five
    groups of four rounds with a key injection after each (jax's
    ``_threefry2x32_lowering``)."""
    k0, k1 = (np.asarray(key[i], np.uint32).reshape(1) for i in (0, 1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32).ravel() + ks[0]
    x1 = np.asarray(x1, np.uint32).ravel() + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotate_left(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the high and low words of the seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys, key ``i`` the
    hash of the count ``(0, i)``."""
    b0, b1 = _threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of ``(0, data)``."""
    b0, b1 = _threefry2x32(key, [0], [int(data) & 0xFFFFFFFF])
    return np.array([b0[0], b1[0]], dtype=np.uint32)


def _random_bits(key: np.ndarray, bit_width: int, shape) -> np.ndarray:
    """jax's partitionable ``random_bits``: element ``i`` (row-major) is
    the hash of the 64-bit count ``i``, its two words xor-ed (32 bits)
    or joined high word first (64 bits)."""
    count = np.arange(math.prod(shape), dtype=np.uint64)
    b0, b1 = _threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                           count.astype(np.uint32))
    if bit_width == 32:
        return (b0 ^ b1).reshape(shape)
    return ((b0.astype(np.uint64) << np.uint64(32)) | b1).reshape(shape)


def uniform(key: np.ndarray, shape, dtype=np.float64, minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform``: the random mantissa of a float in
    ``[1, 2)``, minus one, scaled to ``[minval, maxval)``."""
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        bits, uint, nmant = _random_bits(key, 32, shape), np.uint32, 23
    elif dtype == np.float64:
        bits, uint, nmant = _random_bits(key, 64, shape), np.uint64, 52
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    one = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(8 * dtype.itemsize - nmant)) | one).view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.asarray(np.maximum(lo, floats * (hi - lo) + lo))


def normal(key: np.ndarray, shape, dtype=np.float64) -> np.ndarray:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` of a uniform draw
    on ``(nextafter(-1, 0), 1)`` (module docstring for the precision)."""
    dtype = np.dtype(dtype)
    lo = np.nextafter(dtype.type(-1.0), dtype.type(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    z = torch.special.erfinv(torch.as_tensor(u, dtype=torch.float64)).numpy()
    return np.asarray(np.sqrt(2.0) * z).astype(dtype)


# ---------------------------------------------------------------------------
# The same hash in PyTorch integer operations (traceable, on any device)

_MASK = 0xFFFFFFFF


def _threefry2x32_torch(k0, k1, x0, x1):
    """:func:`_threefry2x32` on int64 tensors holding 32-bit words (keys
    and counts broadcast against each other)."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & _MASK
    return x0, x1


def fold_in_torch(key: np.ndarray, data: torch.Tensor):
    """:func:`fold_in` of one key with every entry of the int64 tensor
    ``data``: the two words of each new key, int64 tensors of
    ``data``'s shape."""
    return _threefry2x32_torch(int(key[0]), int(key[1]), torch.zeros_like(data),
                               data & _MASK)


def uniform_torch(k0, k1, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`uniform` on ``[0, 1)``: ``n`` draws (the trailing axis)
    under the key words ``k0``, ``k1`` (ints, or int64 tensors of shape
    ``(..., 1)`` for one key a row), in float32 or float64 on
    ``device``."""
    count = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32_torch(k0, k1, count >> 32, count & _MASK)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, not {dtype}")
