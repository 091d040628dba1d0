"""Wrapper of the batched CD/HALS kernel (``csrc/cd_nmf.cu``).

Replaces the TPU kernels ``cd_iterations_pallas`` and ``fit_cd_pallas``
(``muscle_synergies_tpu/models/kernels/cd_pallas.py``).  One CUDA
source serves both: the stopping rule is a template switch, compiled
out for the fixed-iteration entry point.

:func:`cd_iterations_cuda` and :func:`fit_cd_cuda` take contiguous CUDA
float32 tensors in the JAX layouts, X ``(B, N, L)``, W ``(B, N, k)``,
H ``(B, k, L)``, and raise on anything else; :func:`fit_cd_cuda`
returns a :class:`~muscle_synergies_tpu_torch.models.hals.CDState`
whose ``ht`` is ``(B, L, k)`` and takes sklearn's L1/L2 penalties as
the kernel does.  Their plain versions are
:func:`cd_iterations_plain` and :func:`fit_cd_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import load
from ..hals import CDState, cd_pass, fit_cd
from .mu_cuda import check_shapes

__all__ = [
    "cd_iterations_cuda",
    "fit_cd_cuda",
    "cd_iterations_plain",
    "fit_cd_plain",
    "launches",
]

launches = 0  # kernel launches since the last reset


def _lib():
    fn = load("cd_nmf").cd_nmf_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
        + [ctypes.c_int] + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, w0, h0, iters, tol, with_stop, regs=(0.0, 0.0, 0.0, 0.0)):
    global launches
    check_shapes("cd_nmf", xs, w0, h0)
    xs, w0, h0 = xs.contiguous(), w0.contiguous(), h0.contiguous()
    b, n, l = xs.shape
    k = w0.shape[-1]
    w, h = torch.empty_like(w0), torch.empty_like(h0)
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    viol_init = torch.zeros(b, dtype=torch.float32, device=xs.device)
    converged = torch.zeros(b, dtype=torch.int32, device=xs.device)
    err = _lib()(
        xs.data_ptr(), w0.data_ptr(), h0.data_ptr(), w.data_ptr(),
        h.data_ptr(), n_iter.data_ptr(), viol_init.data_ptr(),
        converged.data_ptr(), b, n, l, k, int(iters), float(tol),
        *map(float, regs), int(with_stop),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cd_nmf kernel launch failed: CUDA error {err}")
    launches += 1
    return w, h, n_iter, viol_init, converged.bool()


def cd_iterations_cuda(xs, w, h, n_iters: int):
    """``n_iters`` CD outer iterations of every fit, no stopping (K2b)."""
    w, h, *_ = _launch(xs, w, h, n_iters, 0.0, False)
    return w, h


def fit_cd_cuda(
    xs, w0, h0, max_iter: int = 200, tol: float = 1e-4, l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0, l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> CDState:
    """CD-NMF of every fit to sklearn's stop, converged fits frozen (K2a)."""
    w, h, n_iter, viol_init, converged = _launch(
        xs, w0, h0, max_iter, tol, True, (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    )
    return CDState(w, h.transpose(-1, -2), n_iter, viol_init, converged)


def cd_iterations_plain(xs, w, h, n_iters: int):
    """Plain version of :func:`cd_iterations_cuda`."""
    xt = xs.transpose(-1, -2)
    ht = h.transpose(-1, -2)
    for _ in range(n_iters):
        w, _ = cd_pass(xs, w, ht)
        ht, _ = cd_pass(xt, ht, w)
    return w, ht.transpose(-1, -2)


def fit_cd_plain(
    xs, w0, h0, max_iter: int = 200, tol: float = 1e-4, l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0, l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> CDState:
    """Plain version of :func:`fit_cd_cuda`."""
    return fit_cd(xs, w0, h0, max_iter=max_iter, tol=tol, l1_reg_w=l1_reg_w,
                  l2_reg_w=l2_reg_w, l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)
