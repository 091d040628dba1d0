"""Wrapper of the batched CD/HALS kernel (``csrc/cd_nmf.cu``).

Replaces the TPU kernels ``cd_iterations_pallas`` and ``fit_cd_pallas``
(``muscle_synergies_tpu/models/kernels/cd_pallas.py``).  One CUDA
source serves both: the stopping rule is a template switch, compiled
out for the fixed-iteration entry point.

The source has three entries, picked by :func:`route` (K1's rule,
:func:`~.mu_cuda.route`) from the frame's shape and the batch: the warp
entry (one warp per fit, X and W rows in registers) for frames of at
most ``WARP_NMAX`` x ``WARP_LMAX`` at rank ``WARP_KMAX``, which covers
every time-normalised 200 x 8 frame of the main paths at ranks 1-8; the
cluster (grid) entry (one fit spread over many blocks of the card, the
partial Grams and W-pass violations summed in block order after a
barrier in device memory, K1's plan, :func:`~.mu_cuda.grid_plan`) for
every larger frame, from 225 rows to a whole capture's envelope, at
most ``SMs // batch`` blocks a fit; the block entry (one block of 128
threads per fit, the fit in shared memory) only for batches of frames
within one block's shared memory at rank ``mu_cuda.BLOCK_KMIN`` to
``BLOCK_KMAX`` that would keep the grid entry's SMs busy for
``mu_cuda.BLOCK_MIN_WAVES`` waves or more (:func:`~.mu_cuda.block_keeps`);
and a refusal before any launch beyond.  The warp and grid entries run
each fit over its own rank, which the kernel finds at load (the last
component whose column of W0 or row of H0 holds a nonzero, plus one): a
rank sweep's zero padding costs them nothing and changes no bit.

The rule's numbers (scripts/torch_cluster_timing.py, crossover runs on
an H100 80GB HBM3 at 700 W, us an iteration, block entry -> grid entry):
at ranks 1-8, where the grid kernel (KMAX 4 or 8, 118-128 registers)
holds two blocks a SM, the grid entry is no slower at any batch (1 to
1,024 fits of 2,400 x 8 23.7-179.9 -> 5.8-88.2, 16 x 2,000 x 8 20.77 ->
5.52, 1,024 x 225 x 8 17.24 -> 15.75, 1,024 x 200 x 17 22.70 -> 22.38);
at ranks 9-16 its KMAX-16 kernel (166-169 registers) holds one, and the
block entry is ahead from 4 waves at ranks 9-10 (1,024 x 200 x 8 at rank
9 69.08 -> 90.07, 1,024 x 200 x 16 at rank 9 100.42 -> 108.57, 1,024 x
200 x 10 at rank 10 83.74 -> 95.08) but behind at ranks 12-16 (768 x 200
x 16 at rank 12 98.01 -> 87.53, 1,024 x 200 x 16 at rank 16 179.89 ->
145.30), its H pass and Grams growing with k (k + l).

``warp_launches``, ``launches`` and ``cluster_launches`` count the three
entries' launches; ``last_plan`` is the last cluster launch's plan.

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
from ..._common import check_kernel_nans
from ..hals import CDState, cd_pass, fit_cd
from . import mu_cuda
from .mu_cuda import (  # noqa: F401 (the warp limits, shared with K1 and K4)
    CLUSTER_ARGTYPES,
    WARP_KMAX,
    WARP_LMAX,
    WARP_NMAX,
    card_sms,
    check_layout,
    check_plan,
    cluster_call,
    grid_plan,
    grid_workspace_floats,
    warp_fits,
)

__all__ = [
    "cd_iterations_cuda",
    "fit_cd_cuda",
    "cd_iterations_plain",
    "fit_cd_plain",
    "cluster_launches",
    "launches",
    "route",
    "warp_launches",
]

launches = 0  # block-entry launches since the last reset
warp_launches = 0  # warp-entry launches since the last reset
cluster_launches = 0  # cluster-entry launches since the last reset
last_plan = None  # the plan of the last cluster-entry launch (mu_cuda.GridPlan)
# K2's highest rank that keeps the block entry for mu_cuda.block_keeps's
# batches (from mu_cuda.BLOCK_KMIN, where the grid kernel's KMAX is 16)
BLOCK_KMAX = 10


def route(n: int, l: int, k: int, *, batch: int | None = None,
          sms: int | None = None) -> str:
    """K2's entry for ``batch`` fits of ``(n, l)`` frames at rank ``k`` on
    a card of ``sms`` SMs: ``"warp"``, ``"cluster"`` or ``"block"`` (see
    the module's note); left out, the batch is taken as one that keeps the
    block entry wherever a fit fits a block.  Raises ``ValueError``
    (naming ``impl='torch'``) beyond the cluster entry's limit."""
    block = None
    if batch is not None:
        block = (mu_cuda.block_keeps(batch, sms, mu_cuda.smem_bytes(n, l, k))
                 and mu_cuda.BLOCK_KMIN <= k <= BLOCK_KMAX)
    return mu_cuda.entry_for("cd_nmf", n, l, k, block=block)


def _lib(entry: str):
    lib = load("cd_nmf")
    fn = {"warp": lib.cd_nmf_warp_f32, "block": lib.cd_nmf_f32,
          "cluster": lib.cd_nmf_cluster_f32}[entry]
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
        + [ctypes.c_int] + (CLUSTER_ARGTYPES if entry == "cluster" else [])
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, w0, h0, iters, tol, with_stop, regs=(0.0, 0.0, 0.0, 0.0)):
    global launches, warp_launches, cluster_launches, last_plan
    check_layout("cd_nmf", xs, w0, h0)
    xs, w0, h0 = xs.contiguous(), w0.contiguous(), h0.contiguous()
    b, n, l = xs.shape
    k = w0.shape[-1]
    entry = route(n, l, k, batch=b, sms=card_sms(xs))
    w, h = torch.empty_like(w0), torch.empty_like(h0)
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    viol_init = torch.zeros(b, dtype=torch.float32, device=xs.device)
    converged = torch.zeros(b, dtype=torch.int32, device=xs.device)
    extra, held = ((), None)
    if entry == "cluster":
        extra, held = cluster_call(xs, lambda sms: grid_plan(b, n, l, k, sms),
                                   lambda plan: grid_workspace_floats(plan, b, l, k))
    err = _lib(entry)(
        xs.data_ptr(), w0.data_ptr(), h0.data_ptr(), w.data_ptr(),
        h.data_ptr(), n_iter.data_ptr(), viol_init.data_ptr(),
        converged.data_ptr(), b, n, l, k, int(iters), float(tol),
        *map(float, regs), int(with_stop), *extra,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cd_nmf {entry} entry launch failed: CUDA error {err}")
    if entry == "warp":
        warp_launches += 1
    elif entry == "cluster":
        last_plan = check_plan("cd_nmf", held)
        cluster_launches += 1
    else:
        launches += 1
    check_kernel_nans("cd_nmf", w, h, viol_init)
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
