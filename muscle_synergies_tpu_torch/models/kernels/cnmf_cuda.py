"""Wrapper of the batched convolutive-NMF kernel (``csrc/cnmf.cu``).

Replaces the TPU kernel ``cnmf_iterations_pallas``
(``muscle_synergies_tpu/models/kernels/cnmf_pallas.py``) and its
chunked fit driver (``models/cnmf.py:_fit_cnmf_batch_pallas``).  One
CUDA source serves both entry points: the stopping rule is a template
switch, compiled out for the fixed-iteration one.  One thread block
runs one fit with X, C, S and the reconstruction in shared memory,
register-tiled so that one shared-memory load feeds 8 or more
multiply-adds; see the source.

:func:`cnmf_iterations_cuda` and :func:`fit_cnmf_cuda` take contiguous
CUDA float32 tensors in the JAX layouts, X ``(B, T, L)``, C
``(B, T, K)``, S ``(B, K, D, L)``, and raise on anything else.  Their
plain versions are :func:`cnmf_iterations_plain` and
:func:`fit_cnmf_plain` (the batched
:mod:`muscle_synergies_tpu_torch.models.cnmf` functions).
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import load
from ..._common import check_cuda_f32, check_kernel_nans
from .. import cnmf as _cnmf
from .mu_cuda import SMEM_LIMIT

__all__ = [
    "cnmf_iterations_cuda",
    "fit_cnmf_cuda",
    "cnmf_iterations_plain",
    "fit_cnmf_plain",
    "launches",
]

launches = 0  # kernel launches since the last reset


def smem_bytes(t: int, l: int, k: int, d: int) -> int:
    """Shared memory of one fit (csrc/cnmf.cu ``cnmf_smem_floats``): X
    and its reconstruction ``(T, Lp)`` with ``Lp`` = L rounded up to a
    power of two of at least 8, C transposed ``(K, T)`` rounded up to 4
    floats, S ``(K, D, Lp)``, the S update's partial sums (16 floats per
    (k, d) pair and time slice after the first) and 33 doubles."""
    lp = 8
    while lp < l:
        lp *= 2
    pairs = k * d
    groups = min(4, max(1, 128 // pairs))  # csrc/cnmf.cu cnmf_groups
    floats = 2 * t * lp + (k * t + 3) // 4 * 4 + pairs * lp
    floats += 16 * (groups - 1) * pairs
    floats += floats & 1
    return 4 * (floats + 2 * 33)


def check_shapes(name: str, xs, c, s) -> None:
    """Raise unless the problem fits the kernel's bounds."""
    check_cuda_f32(name, xs, c, s)
    if xs.ndim != 3 or c.ndim != 3 or s.ndim != 4:
        raise ValueError(f"{name}: expected X (B, T, L), C (B, T, K), S (B, K, D, L)")
    b, t, l = xs.shape
    k, d = s.shape[1], s.shape[2]
    if c.shape != (b, t, k) or s.shape != (b, k, d, l):
        raise ValueError(
            f"{name}: shapes X {tuple(xs.shape)}, C {tuple(c.shape)}, "
            f"S {tuple(s.shape)} do not match"
        )
    if not 1 <= d <= t:
        raise ValueError(f"{name}: {d} lags outside 1..{t} samples")
    if smem_bytes(t, l, k, d) > SMEM_LIMIT:
        raise ValueError(
            f"{name}: one fit of {t}x{l} with {k} synergies of {d} lags "
            f"needs {smem_bytes(t, l, k, d)} bytes of shared memory, over "
            f"{SMEM_LIMIT}; use impl='torch'"
        )


def _lib():
    fn = load("cnmf").cnmf_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_double]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, c0, s0, iters, tol, check_every, with_stop):
    global launches
    check_shapes("cnmf", xs, c0, s0)
    xs, c0, s0 = xs.contiguous(), c0.contiguous(), s0.contiguous()
    b, t, l = xs.shape
    k, d = s0.shape[1], s0.shape[2]
    c, s = torch.empty_like(c0), torch.empty_like(s0)
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    prev_err = torch.zeros(b, dtype=torch.float32, device=xs.device)
    converged = torch.zeros(b, dtype=torch.int32, device=xs.device)
    err = _lib()(
        xs.data_ptr(), c0.data_ptr(), s0.data_ptr(), c.data_ptr(),
        s.data_ptr(), n_iter.data_ptr(), prev_err.data_ptr(),
        converged.data_ptr(), b, t, l, k, d, int(iters), float(tol),
        int(check_every), int(with_stop),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cnmf kernel launch failed: CUDA error {err}")
    launches += 1
    check_kernel_nans("cnmf", c, s, prev_err)
    return c, s, n_iter, prev_err, converged.bool()


def cnmf_iterations_cuda(xs, c, s, n_iters: int):
    """``n_iters`` convolutive updates of every fit, no stopping (K5b)."""
    c, s, *_ = _launch(xs, c, s, n_iters, 0.0, 1, False)
    return c, s


def fit_cnmf_cuda(xs, c0, s0, max_iter: int = 200, tol: float = 1e-4,
                  check_every: int = 10):
    """Convolutive NMF of every fit to the stop, converged fits frozen (K5a).

    Returns a :class:`~muscle_synergies_tpu_torch.models.cnmf.CNMFState`.
    """
    return _cnmf.CNMFState(*_launch(xs, c0, s0, max_iter, tol, check_every,
                                    True))


def cnmf_iterations_plain(xs, c, s, n_iters: int, precision=None):
    """Plain version of :func:`cnmf_iterations_cuda` (its contractions at
    the JAX-style matmul ``precision``)."""
    return _cnmf.cnmf_iterations_batch(xs, c, s, n_iters, impl="torch",
                                       precision=precision)


def fit_cnmf_plain(xs, c0, s0, max_iter: int = 200, tol: float = 1e-4,
                   check_every: int = 10):
    """Plain version of :func:`fit_cnmf_cuda`."""
    return _cnmf.fit_cnmf(xs, c0, s0, max_iter=max_iter, tol=tol,
                          check_every=check_every)
