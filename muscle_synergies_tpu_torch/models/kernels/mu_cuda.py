"""Wrapper of the batched MU-NMF kernel (``csrc/mu_nmf.cu``).

Replaces the TPU kernels ``mu_iterations_pallas`` and ``fit_mu_pallas``
(``muscle_synergies_tpu/models/kernels/mu_pallas.py``).  One CUDA
source serves both: the stopping rule is a template switch, compiled
out for the fixed-iteration entry point.

The source has three entries, picked by :func:`route` from the frame's
shape and the batch: the warp entry (one warp per fit, X and W rows in
registers) for frames of at most ``WARP_NMAX`` x ``WARP_LMAX`` at rank
``WARP_KMAX``, which covers every time-normalised 200 x 8 frame of the
main paths at ranks 1-8; the cluster (grid) entry (one fit spread over
many blocks of the card, each block owning a range of rows, the partial
Grams summed in block order after a barrier in device memory) for every
larger frame, from 225 rows to a whole capture, at most ``SMs //
batch`` blocks a fit; the block entry (one block of 128 threads per
fit, the fit in shared memory) only for batches of frames within one
block's shared memory at rank over ``BLOCK_KMIN - 1`` that would keep
the grid entry's SMs busy for ``BLOCK_MIN_WAVES`` waves or more
(:func:`block_keeps`); and a refusal before any launch for a frame
whose H and Grams alone would fill a block (:func:`cluster_smem_bytes`).
``warp_launches``, ``launches`` and ``cluster_launches`` count the three
entries' launches.  The warp limits are those of every warp entry (K1,
K2 and K4; ``csrc/nmf_common.cuh``).

:func:`grid_plan` mirrors the cluster entry's plan (blocks a fit, rows
a block, rows resident in shared memory or streamed in tiles); each
launch checks the plan the kernel reports against it and keeps it in
``last_plan``.

:func:`mu_iterations_cuda` and :func:`fit_mu_cuda` take contiguous CUDA
float32 tensors in the JAX layouts, X ``(B, N, L)``, W ``(B, N, k)``,
H ``(B, k, L)``, and raise on anything else; :func:`fit_mu_cuda` takes
sklearn's L1/L2 penalties as the kernel does.  Their plain versions are
:func:`mu_iterations_plain` and :func:`fit_mu_plain` (the batched
:mod:`muscle_synergies_tpu_torch.models.mu` functions).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..._build import load
from ..._common import check_cuda_f32, check_kernel_nans
from ..mu import MUState, fit_mu, mu_update

__all__ = [
    "mu_iterations_cuda",
    "fit_mu_cuda",
    "mu_iterations_plain",
    "fit_mu_plain",
    "block_keeps",
    "cluster_launches",
    "grid_plan",
    "launches",
    "route",
    "warp_launches",
]

launches = 0  # block-entry launches since the last reset
warp_launches = 0  # warp-entry launches since the last reset
cluster_launches = 0  # cluster-entry launches since the last reset
last_plan = None  # the plan of the last cluster-entry launch (a GridPlan)
# blocks a SM the card holds for each kernel's last cluster-entry launch, by
# kernel name (the plan's last int, reported by the kernel)
blocks_per_sm = {}
KMAX = 16  # csrc/nmf_common.cuh NMF_KMAX
# csrc/nmf_common.cuh: NMF_WARP_NMAX, NMF_WARP_LMAX, NMF_WARP_KMAX
WARP_NMAX, WARP_LMAX, WARP_KMAX = 224, 16, 8
SMEM_LIMIT = 227 * 1024  # bytes of shared memory one block may use on sm_90
SM_SMEM = 228 * 1024  # bytes of shared memory one SM holds on sm_90, 1 KB a block reserved
CLUSTER_MIN_TILE = 128  # csrc/nmf_common.cuh NMF_GRID_MIN_TILE

# Which batches of frames within one block's shared memory keep the block
# entry (:func:`block_keeps`; K1 and K4).  The grid entry at one block a
# fit runs a batch in waves of one block a SM where its kernel's
# registers allow one (K4: 184-255 registers a thread; K1 at rank over 8,
# KMAX 16: 193-246), two where they allow two (K1 at ranks 1-8: 118-128);
# the block entry's 128-thread blocks of a small frame share an SM 4-8 at
# a time.  Times an iteration (scripts/torch_cluster_timing.py, crossover
# runs on an H100 80GB HBM3 at 700 W, block entry -> grid entry): K4 at
# 200 x 8, beta 1.5, 132 fits 21.94 -> 8.44 us, 264 fits 23.52 -> 16.42,
# 528 fits 29.02 -> 32.29, 792 fits 38.18 -> 47.59, 1,024 fits 49.72 ->
# 63.81 (beta -0.5 52.40 -> 68.73; IS at rank 6 46.14 -> 52.54, 528 fits
# 24.60 -> 26.86); KL on 1,024 x 300 x 8 31.18 -> 40.39, but 600 x 8 at
# beta 1.5 (77 KB a block, two a SM) 203.83 -> 169.30 and KL on 1,024 x
# 2,000 x 8 450.54 -> 130.55.  K1 at rank 9 on 1,024 x 200 x 8 63.11 ->
# 85.82; at ranks 1-8 the grid entry no slower at any batch measured (1 to
# 1,024 fits of 2,400 x 8 22.2-178.5 -> 5.7-85.8, 1,024 x 225 x 8 16.31 ->
# 15.87, 1,024 x 225 x 16 at rank 8 62.70 -> 40.05, 1,024 x 200 x 17
# 20.55 -> 20.70).  So the block entry keeps a batch where the grid entry
# would run BLOCK_MIN_WAVES waves or more of one block a SM and the block
# entry holds that many fits on each SM.
BLOCK_MIN_WAVES = 4
BLOCK_KMIN = 9  # K1's and K2's least rank that keeps the block entry (grid KMAX 16)


def smem_bytes(n: int, l: int, k: int) -> int:
    """Shared memory of one fit (csrc/nmf_common.cuh ``nmf_smem_floats``)."""
    return 4 * (n * ((l | 1) + (k | 1)) + 2 * k * l + k * k + 33)


# csrc/nmf_common.cuh: NMF_GRID_THREADS, NMF_GRID_MIN_ROWS, NMF_GRID_PLAN_INTS
GRID_THREADS, GRID_MIN_ROWS, GRID_PLAN_INTS = 256, 256, 7


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_nq(l: int, k: int) -> int:
    """Entries of the cluster entry's partial set: ``W^T [W X]`` in 4 x 8
    tiles of 32 (csrc/nmf_common.cuh ``nmf_grid_nq``)."""
    return 32 * _cdiv(k, 4) * _cdiv(k + l, 8)


def grid_small_floats(l: int, k: int) -> int:
    """Floats of a cluster-entry block besides its rows: H, the Gram
    matrix, W^T X, reduction scratch, the partial set and the warps' sums
    (csrc/nmf_common.cuh ``nmf_grid_small_floats``)."""
    return 2 * k * l + k * k + 33 + grid_nq(l, k) + 1 + (GRID_THREADS // 32) * 64


def cluster_smem_bytes(l: int, k: int) -> int:
    """Shared memory of one block of the cluster entries at its least:
    its small state (:func:`grid_small_floats`) and a streamed tile of
    ``CLUSTER_MIN_TILE`` rows of W and X.  The entry takes an ``(l, k)``
    fit of any number of rows when this fits one block."""
    return 4 * (grid_small_floats(l, k) + CLUSTER_MIN_TILE * (k + l))


class GridPlan(NamedTuple):
    """How the cluster entries run a batch of fits: ``blocks`` a fit,
    ``rows`` a block, ``resident`` (rows kept in shared memory) or
    streamed in tiles of ``tile`` rows, ``smem`` bytes of shared memory
    a block."""

    blocks: int
    rows: int
    resident: bool
    tile: int
    smem: int


def grid_rule(batch: int, n: int, sms: int, small: int, row: int,
              smem_limit: int = SMEM_LIMIT) -> GridPlan:
    """The grid entries' plan rule for a kernel that keeps ``small``
    floats a block besides its rows and ``row`` floats a row
    (csrc/nmf_common.cuh ``nmf_grid_rule_sized``): at most ``sms //
    batch`` blocks a fit (one block a SM, so the batch's blocks are
    resident together) and at most ``ceil(n / GRID_MIN_ROWS)``; rows
    resident at the least block count whose rows fit a block, where that
    is within ``sms // batch``; else ``sms // batch`` blocks streaming
    their rows in tiles of as many rows as fit.  Raises ``ValueError``
    where not even ``CLUSTER_MIN_TILE`` rows fit."""
    room = smem_limit // 4 - small
    p_max = max(1, sms // batch)
    p = min(_cdiv(n, GRID_MIN_ROWS), p_max)
    fit = room // row if room > 0 else 0
    if fit >= 1 and _cdiv(n, fit) <= p_max:
        p = max(p, _cdiv(n, fit))
        rows = _cdiv(n, p)
        return GridPlan(p, rows, True, rows, 4 * (small + rows * row))
    rows = _cdiv(n, p_max)
    tile = min(fit, rows)
    if tile < CLUSTER_MIN_TILE and tile < rows:
        raise ValueError(f"{n} rows: a block holds {tile} rows, under {CLUSTER_MIN_TILE}")
    return GridPlan(p_max, rows, False, tile, 4 * (small + tile * row))


def grid_plan(batch: int, n: int, l: int, k: int, sms: int,
              smem_limit: int = SMEM_LIMIT) -> GridPlan:
    """K1's and K2's cluster-entry plan for ``batch`` fits of ``(n, l)``
    frames at rank ``k`` on a card of ``sms`` SMs (csrc/nmf_common.cuh
    ``nmf_grid_rule``): :func:`grid_rule` with their small state
    (:func:`grid_small_floats`) and rows of ``k + l`` floats."""
    try:
        return grid_rule(batch, n, sms, grid_small_floats(l, k), k + l, smem_limit)
    except ValueError as e:
        raise ValueError(f"{n}x{l} at rank {k}: {e}") from None


def grid_workspace_floats(plan: GridPlan, batch: int, l: int, k: int) -> int:
    """Floats of the cluster entries' workspace (csrc/nmf_common.cuh
    ``nmf_grid_workspace_floats``): the fits' arrive counters, a slot a
    block for the stopping statistic, two partial sets a block."""
    blocks = batch * plan.blocks
    pstride = (grid_nq(l, k) + 1 + 3) // 4 * 4
    return _cdiv(batch, 4) * 4 + _cdiv(blocks, 4) * 4 + 2 * blocks * pstride


def card_sms(xs) -> int:
    """The SM count of the card ``xs`` lies on."""
    return torch.cuda.get_device_properties(xs.device).multi_processor_count


def cluster_call(xs, plan_for, floats_for):
    """The grid entries' last arguments for a batch on ``xs``'s card: the
    zeroed workspace, its size, the plan's output ints; and what
    :func:`check_plan` needs.  ``plan_for(sms)`` is the plan the kernel
    must report (its Python mirror), ``floats_for(plan)`` the workspace's
    floats."""
    sms = card_sms(xs)
    plan = plan_for(sms)
    floats = floats_for(plan)
    ws = torch.zeros(floats, dtype=torch.float32, device=xs.device)
    out = (ctypes.c_int * GRID_PLAN_INTS)()
    return (ws.data_ptr(), floats, out), (plan, ws, out, sms)


def check_plan(name: str, held) -> GridPlan:
    """Raise unless the plan a cluster entry reported (``held`` from
    :func:`cluster_call`) is its Python mirror's; returns the plan."""
    plan, _, out, sms = held
    got = GridPlan(out[0], out[1], bool(out[2]), out[3], out[4])
    if got != plan or out[5] != sms:
        raise RuntimeError(f"{name}: the kernel planned {got} on {out[5]} SMs, "
                           f"the mirror {plan} on {sms}")
    blocks_per_sm[name] = out[6]
    return plan


def check_layout(name: str, xs, w, h) -> None:
    """Raise unless X, W and H are CUDA float32 tensors of matching
    ``(B, N, L)``, ``(B, N, k)`` and ``(B, k, L)`` shapes."""
    check_cuda_f32(name, xs, w, h)
    if xs.ndim != 3 or w.ndim != 3 or h.ndim != 3:
        raise ValueError(f"{name}: expected 3-D X, W, H")
    b, n, l = xs.shape
    k = w.shape[-1]
    if w.shape != (b, n, k) or h.shape != (b, k, l):
        raise ValueError(
            f"{name}: shapes X {tuple(xs.shape)}, W {tuple(w.shape)}, "
            f"H {tuple(h.shape)} do not match"
        )


def warp_fits(n: int, l: int, k: int) -> bool:
    """Whether an ``(n, l)`` frame at rank ``k`` is within the warp
    entries' limits (one warp's registers hold its rows)."""
    return n <= WARP_NMAX and l <= WARP_LMAX and k <= WARP_KMAX


def block_keeps(batch: int, sms: int | None, block_bytes: int) -> bool:
    """Whether ``batch`` fits of ``block_bytes`` of shared memory each (a
    frame within one block) run on the block entry rather than on a grid
    entry of one block a SM: the grid entry would take
    ``BLOCK_MIN_WAVES`` waves or more of ``sms`` blocks, and
    ``BLOCK_MIN_WAVES`` of the block entry's fits share one SM's shared
    memory."""
    if sms is None:
        raise ValueError("a batch's route needs the card's SM count (sms=)")
    return (_cdiv(batch, sms) >= BLOCK_MIN_WAVES
            and BLOCK_MIN_WAVES * (block_bytes + 1024) <= SM_SMEM)


def route(n: int, l: int, k: int, *, batch: int | None = None,
          sms: int | None = None) -> str:
    """K1's entry for ``batch`` fits of ``(n, l)`` frames at rank ``k`` on
    a card of ``sms`` SMs: ``"warp"``, ``"cluster"`` or ``"block"`` (see
    the module's note); left out, the batch is taken as one that keeps the
    block entry wherever a fit fits a block.  Raises ``ValueError``
    (naming ``impl='torch'``) when even a cluster block cannot hold H,
    the Grams and two tiles of rows."""
    block = None
    if batch is not None:
        block = block_keeps(batch, sms, smem_bytes(n, l, k)) and k >= BLOCK_KMIN
    return entry_for("mu_nmf", n, l, k, block=block)


def entry_for(name: str, n: int, l: int, k: int, warp=None, block_bytes=None,
              cluster_bytes=None, block=None) -> str:
    """The rule of :func:`route`, shared by K1, K2 and K4 (``name`` heads
    the error): the warp entry where ``warp``, else the block entry
    where one fit's ``block_bytes`` fit a block and ``block`` (the
    batch's rule; None, the block entry wherever a fit fits) or the
    cluster entry cannot take the frame, else the cluster
    entry where a cluster block's least ``cluster_bytes`` fit.  Left out,
    the sizes are K1's and K2's (:func:`warp_fits`, :func:`smem_bytes`,
    :func:`cluster_smem_bytes`)."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"{name}: rank {k} outside the kernel's 1..{KMAX}")
    if warp is None:
        warp, block_bytes = warp_fits(n, l, k), smem_bytes(n, l, k)
        cluster_bytes = cluster_smem_bytes(l, k)
    if warp:
        return "warp"
    if block_bytes <= SMEM_LIMIT and (block is not False or cluster_bytes > SMEM_LIMIT):
        return "block"
    if cluster_bytes <= SMEM_LIMIT:
        return "cluster"
    raise ValueError(
        f"{name}: one fit of {n}x{l} at rank {k} needs {cluster_bytes} bytes of "
        f"shared memory a block even on the cluster entry, over {SMEM_LIMIT}; "
        "pass impl='torch' for the plain fit on the card, or device='cpu'"
    )


# the cluster entries' workspace, its floats and the plan's output ints
CLUSTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]


def _lib(entry: str):
    lib = load("mu_nmf")
    fn = {"warp": lib.mu_nmf_warp_f32, "block": lib.mu_nmf_f32,
          "cluster": lib.mu_nmf_cluster_f32}[entry]
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_float] * 4 + [ctypes.c_int]
        # the cluster entry: the plan's batch, then the workspace
        + ([ctypes.c_int] + CLUSTER_ARGTYPES if entry == "cluster" else [])
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, w0, h0, iters, tol, check_every, inner_iter, with_stop,
            regs=(0.0, 0.0, 0.0, 0.0), plan_batch=None):
    global launches, warp_launches, cluster_launches, last_plan
    check_layout("mu_nmf", xs, w0, h0)
    xs, w0, h0 = xs.contiguous(), w0.contiguous(), h0.contiguous()
    b, n, l = xs.shape
    k = w0.shape[-1]
    pb = b if plan_batch is None else int(plan_batch)
    if pb < b:
        raise ValueError(f"mu_nmf: plan_batch {pb} under the batch's {b} fits")
    entry = route(n, l, k, batch=pb, sms=card_sms(xs))
    w, h = torch.empty_like(w0), torch.empty_like(h0)
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    prev_err = torch.zeros(b, dtype=torch.float32, device=xs.device)
    converged = torch.zeros(b, dtype=torch.int32, device=xs.device)
    extra, held = ((), None)
    if entry == "cluster":
        extra, held = cluster_call(xs, lambda sms: grid_plan(pb, n, l, k, sms),
                                   lambda plan: grid_workspace_floats(plan, b, l, k))
        extra = (pb, *extra)
    err = _lib(entry)(
        xs.data_ptr(), w0.data_ptr(), h0.data_ptr(), w.data_ptr(),
        h.data_ptr(), n_iter.data_ptr(), prev_err.data_ptr(),
        converged.data_ptr(), b, n, l, k, int(iters), float(tol),
        int(check_every), int(inner_iter), *map(float, regs), int(with_stop),
        *extra, torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mu_nmf {entry} entry launch failed: CUDA error {err}")
    if entry == "warp":
        warp_launches += 1
    elif entry == "cluster":
        last_plan = check_plan("mu_nmf", held)
        cluster_launches += 1
    else:
        launches += 1
    check_kernel_nans("mu_nmf", w, h, prev_err)
    return w, h, n_iter, prev_err, converged.bool()


def mu_iterations_cuda(xs, w, h, n_iters: int, inner_iter: int = 1):
    """``n_iters`` MU updates of every fit, no stopping (K1b)."""
    w, h, *_ = _launch(xs, w, h, n_iters, 0.0, 1, inner_iter, False)
    return w, h


def fit_mu_cuda(
    xs, w0, h0, max_iter: int = 200, tol: float = 1e-4, check_every: int = 10,
    inner_iter: int = 1, l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0, *, plan_batch: int | None = None,
) -> MUState:
    """MU-NMF of every fit to sklearn's stop, converged fits frozen (K1a).

    ``plan_batch`` (at least the batch): the batch whose route and grid
    plan the fits take, so that fits cut from a larger batch (a
    checkpointed bootstrap's chunks) keep that batch's order of sums and
    give its bits; the batch itself by default."""
    return MUState(*_launch(xs, w0, h0, max_iter, tol, check_every,
                            inner_iter, True,
                            (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h), plan_batch))


def mu_iterations_plain(xs, w, h, n_iters: int, inner_iter: int = 1):
    """Plain version of :func:`mu_iterations_cuda`."""
    for _ in range(n_iters):
        w, h = mu_update(xs, w, h, inner_iter=inner_iter)
    return w, h


def fit_mu_plain(
    xs, w0, h0, max_iter: int = 200, tol: float = 1e-4, check_every: int = 10,
    inner_iter: int = 1, l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
) -> MUState:
    """Plain version of :func:`fit_mu_cuda`."""
    return fit_mu(xs, w0, h0, max_iter=max_iter, tol=tol,
                  check_every=check_every, inner_iter=inner_iter,
                  l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w, l1_reg_h=l1_reg_h,
                  l2_reg_h=l2_reg_h)
