"""Wrapper of the batched beta-divergence MU kernel (``csrc/beta_nmf.cu``).

Replaces the TPU kernels ``beta_mu_iterations_pallas`` and
``kl_mu_iterations_pallas``
(``muscle_synergies_tpu/models/kernels/beta_pallas.py``) and their
chunked fit driver (``models/batch.py:_fit_beta_batch_pallas``).  One
CUDA source serves both entry points: the stopping rule is a template
switch, compiled out for the fixed-iteration one (a run-time switch in
the cluster entry, whose one kernel a kind serves both), and the kernel is
specialised for KL (beta = 1) and Itakura-Saito (beta = 0), with every
other beta taken at run time.

The source has three entries, picked by :func:`route` from the frame's
shape, beta and the batch: the warp entry (one warp per fit, X and W
rows in registers) for KL frames within the warp limits of
:mod:`.mu_cuda` and for Itakura-Saito frames within ``IS_WARP_LMAX``
columns at rank ``IS_WARP_KMAX`` (the main paths' 200 x 8 at ranks
1-4); the cluster (grid) entry (one fit spread over many blocks of the
card on K1's grid design, at most ``SMs // batch`` blocks a fit, each
block a range of rows, the weights kept in registers and the two
partial (k, L) planes summed in block order after a barrier in device
memory) for every other frame, from a run-time beta on 200 x 8 to a
whole capture; the block entry (one block of 128 threads per fit, X, W,
H and the weight planes in shared memory; KL stores one plane, the other
kinds two) only for batches of frames within one block that would keep
the grid entry's SMs busy for ``mu_cuda.BLOCK_MIN_WAVES`` waves or more
of its one block a SM, and whose blocks share an SM that many at a time
(:func:`~.mu_cuda.block_keeps`: 1,024 fits of 200 x 8 at beta 1.5, say;
a run-time beta's warp entry was slower than the block entry); and a
refusal before any launch for a frame whose small per-block state alone
would fill a block (:func:`cluster_smem_bytes`).  ``warp_launches``, ``launches`` and
``cluster_launches`` count the three entries' launches.
:func:`grid_plan` mirrors the cluster entry's plan (blocks a fit, rows a
block, resident or streamed); each launch checks the plan the kernel
reports against it and keeps it in ``last_plan``.

:func:`beta_iterations_cuda` and :func:`fit_beta_cuda` take contiguous
CUDA float32 tensors in the JAX layouts, X ``(B, N, L)``, W
``(B, N, k)``, H ``(B, k, L)``, and raise on anything else;
:func:`fit_beta_cuda` takes sklearn's L1/L2 penalties as the kernel
does.  Their
plain versions are :func:`beta_iterations_plain` and
:func:`fit_beta_plain` (the batched
:mod:`muscle_synergies_tpu_torch.models.beta` functions).
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import load
from ..._common import check_kernel_nans
from ..beta import BetaState, _gamma, fit_mu_beta, mu_update_beta
from .mu_cuda import (
    CLUSTER_ARGTYPES,
    CLUSTER_MIN_TILE,
    GRID_THREADS,
    GridPlan,
    block_keeps,
    card_sms,
    check_layout,
    check_plan,
    cluster_call,
    entry_for,
    grid_rule,
    warp_fits,
)
from .mu_cuda import smem_bytes as mu_smem_bytes

__all__ = [
    "beta_iterations_cuda",
    "fit_beta_cuda",
    "beta_iterations_plain",
    "fit_beta_plain",
    "cluster_launches",
    "grid_plan",
    "launches",
    "route",
    "warp_launches",
]

launches = 0  # block-entry launches since the last reset
warp_launches = 0  # warp-entry launches since the last reset
cluster_launches = 0  # cluster-entry launches since the last reset
last_plan = None  # the plan of the last cluster-entry launch (mu_cuda.GridPlan)
# csrc/beta_nmf.cu: BETA_WARP_IS_LMAX, BETA_WARP_IS_KMAX
IS_WARP_LMAX, IS_WARP_KMAX = 8, 4


def smem_bytes(n: int, l: int, k: int, kl: bool = False) -> int:
    """Shared memory of one fit of the block entry (csrc/beta_nmf.cu
    ``beta_smem_floats``); KL (``kl=True``) stores no denominator plane."""
    floats = mu_smem_bytes(n, l, k) // 4 + (1 if kl else 2) * n * (l | 1) + 2 * k * l
    floats += floats & 1
    return 4 * (floats + 2 * 33)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_nq(l: int, k: int) -> int:
    """Entries of the cluster entry's partial set: tiles of 4 components
    x 8 columns, 32 entries of each plane a tile (csrc/beta_nmf.cu
    ``beta_grid_nq``)."""
    return 64 * _cdiv(k, 4) * _cdiv(l, 8)


def grid_small_floats(l: int, k: int, kl: bool = False) -> int:
    """Floats of a cluster-entry block besides its rows: float64 scratch,
    H, KL's row sums of H, the fit's sums of the two planes (KL: one plane
    and the column sums of W), the partial set and the warps' sums
    (csrc/beta_nmf.cu ``beta_grid_small_floats``)."""
    return (66 + 2 * k * l + k + (k if kl else k * l) + grid_nq(l, k)
            + (GRID_THREADS // 32) * 64)


def cluster_smem_bytes(l: int, k: int, kl: bool = False) -> int:
    """Shared memory of one block of the cluster entry at its least: its
    small state (:func:`grid_small_floats`) and a streamed tile of
    ``CLUSTER_MIN_TILE`` rows of W and X.  The entry takes an ``(l, k)``
    fit of any number of rows when this fits one block."""
    return 4 * (grid_small_floats(l, k, kl) + CLUSTER_MIN_TILE * (k + l))


def grid_plan(batch: int, n: int, l: int, k: int, sms: int, kl: bool = False) -> GridPlan:
    """The cluster entry's plan for ``batch`` fits of ``(n, l)`` frames at
    rank ``k`` on a card of ``sms`` SMs (csrc/beta_nmf.cu
    ``beta_grid_rule``): K1's rule (:func:`~.mu_cuda.grid_rule`) with
    K4's small state and rows of ``k + l`` floats (W, then X)."""
    try:
        return grid_rule(batch, n, sms, grid_small_floats(l, k, kl), k + l)
    except ValueError as e:
        raise ValueError(f"beta_nmf {n}x{l} at rank {k}: {e}") from None


def grid_workspace_floats(plan: GridPlan, batch: int, l: int, k: int) -> int:
    """Floats of the cluster entry's workspace (csrc/beta_nmf.cu
    ``beta_grid_workspace_floats``): the fits' arrive counters, a float64
    divergence slot a block, two partial sets a block."""
    blocks = batch * plan.blocks
    return _cdiv(batch, 4) * 4 + 2 * _cdiv(blocks, 4) * 4 + 2 * blocks * _cdiv(grid_nq(l, k), 4) * 4


def route(n: int, l: int, k: int, beta: float = 1.0, *, batch: int | None = None,
          sms: int | None = None) -> str:
    """K4's entry for ``batch`` fits of ``(n, l)`` frames at rank ``k``
    and ``beta`` on a card of ``sms`` SMs: ``"warp"``, ``"cluster"`` or
    ``"block"`` (see the module's note); left out, the batch is taken as
    one that keeps the block entry wherever a fit fits a block.  Raises
    ``ValueError`` (naming ``impl='torch'``) when even a cluster block
    cannot hold the fit's small state and a tile of rows."""
    kl = beta == 1.0
    is_ = beta == 0.0 and l <= IS_WARP_LMAX and k <= IS_WARP_KMAX
    block_bytes = smem_bytes(n, l, k, kl=kl)
    block = None if batch is None else block_keeps(batch, sms, block_bytes)
    return entry_for("beta_nmf", n, l, k, warp=warp_fits(n, l, k) and (kl or is_),
                     block_bytes=block_bytes, cluster_bytes=cluster_smem_bytes(l, k, kl=kl),
                     block=block)


def _lib(entry: str):
    lib = load("beta_nmf")
    fn = {"warp": lib.beta_nmf_warp_f32, "block": lib.beta_nmf_f32,
          "cluster": lib.beta_nmf_cluster_f32}[entry]
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_double] + [ctypes.c_int] + [ctypes.c_float] * 4
        + [ctypes.c_int] + (CLUSTER_ARGTYPES if entry == "cluster" else [])
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, w0, h0, beta, iters, tol, check_every, with_stop,
            regs=(0.0, 0.0, 0.0, 0.0)):
    global launches, warp_launches, cluster_launches, last_plan
    check_layout("beta_nmf", xs, w0, h0)
    xs, w0, h0 = xs.contiguous(), w0.contiguous(), h0.contiguous()
    b, n, l = xs.shape
    k = w0.shape[-1]
    entry = route(n, l, k, float(beta), batch=b, sms=card_sms(xs))
    w, h = torch.empty_like(w0), torch.empty_like(h0)
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    prev_err = torch.zeros(b, dtype=torch.float32, device=xs.device)
    converged = torch.zeros(b, dtype=torch.int32, device=xs.device)
    extra, held = ((), None)
    if entry == "cluster":
        kl = float(beta) == 1.0
        extra, held = cluster_call(xs, lambda sms: grid_plan(b, n, l, k, sms, kl),
                                   lambda plan: grid_workspace_floats(plan, b, l, k))
    err = _lib(entry)(
        xs.data_ptr(), w0.data_ptr(), h0.data_ptr(), w.data_ptr(),
        h.data_ptr(), n_iter.data_ptr(), prev_err.data_ptr(),
        converged.data_ptr(), b, n, l, k, int(iters), float(beta),
        _gamma(float(beta)), float(tol), int(check_every),
        *map(float, regs), int(with_stop), *extra,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"beta_nmf {entry} entry launch failed: CUDA error {err}")
    if entry == "warp":
        warp_launches += 1
    elif entry == "cluster":
        last_plan = check_plan("beta_nmf", held)
        cluster_launches += 1
    else:
        launches += 1
    check_kernel_nans("beta_nmf", w, h, prev_err)
    return w, h, n_iter, prev_err, converged.bool()


def beta_iterations_cuda(xs, w, h, n_iters: int, beta: float = 1.0):
    """``n_iters`` beta-MU updates of every fit, no stopping (K4b)."""
    w, h, *_ = _launch(xs, w, h, beta, n_iters, 0.0, 1, False)
    return w, h


def fit_beta_cuda(
    xs, w0, h0, beta: float = 1.0, max_iter: int = 200, tol: float = 1e-4,
    check_every: int = 10, l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> BetaState:
    """Beta-MU of every fit to sklearn's stop, converged fits frozen (K4a)."""
    return BetaState(*_launch(xs, w0, h0, beta, max_iter, tol, check_every,
                              True, (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)))


def beta_iterations_plain(xs, w, h, n_iters: int, beta: float = 1.0):
    """Plain version of :func:`beta_iterations_cuda`."""
    for _ in range(n_iters):
        w, h = mu_update_beta(xs, w, h, beta)
    return w, h


def fit_beta_plain(
    xs, w0, h0, beta: float = 1.0, max_iter: int = 200, tol: float = 1e-4,
    check_every: int = 10, l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> BetaState:
    """Plain version of :func:`fit_beta_cuda`."""
    return fit_mu_beta(xs, w0, h0, beta=beta, max_iter=max_iter, tol=tol,
                       check_every=check_every, l1_reg_w=l1_reg_w,
                       l2_reg_w=l2_reg_w, l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)
