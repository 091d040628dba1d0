"""Wrapper of the batched convolutive-NMF kernel (``csrc/cnmf.cu``).

Replaces the TPU kernel ``cnmf_iterations_pallas``
(``muscle_synergies_tpu/models/kernels/cnmf_pallas.py``) and its
chunked fit driver (``models/cnmf.py:_fit_cnmf_batch_pallas``).  One
CUDA source serves both entry points: the stopping rule is a template
switch, compiled out for the fixed-iteration one.

The source has three entries, picked by :func:`route` and
:func:`launch_plan`: for a frame within one block's shared memory
(:func:`smem_bytes`: 200 x 8 fits, up to 2,822 x 8 at K = 4, D = 10) the
block entry (one thread block of 128 threads per fit with X, C, S and
the reconstruction in shared memory, register-tiled so that one
shared-memory load feeds 8 or more multiply-adds) and the wide entry
(the same fit, bit for bit, on ``WIDE_THREADS`` threads, for fits that
have an SM or half of one to themselves); the cluster entry (one fit spread over many blocks of the card on K1's
grid design, each block a range of time with the block entry's
register-tiled passes, the S sums added in block order after a barrier
in device memory, the lags' halo rows of C read from the blocks that
own them once their flags say the rows are written) for a longer frame,
such as a subject's concatenated cycles or a whole capture; and a
refusal before any launch for a frame whose S, its sums and the halo
alone would fill a block (:func:`cluster_smem_bytes`).  A batch that
one wave of wide blocks holds (:func:`wide_wave`), or any batch of
frames whose shared memory leaves the block entry no more fits an SM
than the wide entry (:func:`wide_keeps`), runs on the wide entry in one
launch; a larger one with the stop on starts on the block entry
in chunks of ``CHUNK_ITERS`` iterations, the running fits read after
each, and finishes on the wide entry once they fit one wave (both
entries resume each fit's stop where the launch before left it, so the
fit is the uninterrupted one's).  ``launches``, ``wide_launches`` and
``cluster_launches`` count the three entries' launches; :func:`grid_plan`
mirrors the cluster entry's plan (blocks a fit, rows a block, resident
or streamed), which each launch checks and keeps in ``last_plan``; see
the source.

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
from .mu_cuda import (
    CLUSTER_ARGTYPES,
    CLUSTER_MIN_TILE,
    GRID_THREADS,
    SM_SMEM,
    SMEM_LIMIT,
    GridPlan,
    card_sms,
    check_plan,
    cluster_call,
    grid_rule,
)

__all__ = [
    "cnmf_iterations_cuda",
    "fit_cnmf_cuda",
    "cnmf_iterations_plain",
    "fit_cnmf_plain",
    "cluster_launches",
    "grid_plan",
    "launch_plan",
    "launches",
    "route",
    "wide_keeps",
    "wide_launches",
    "wide_wave",
]

launches = 0  # block-entry launches since the last reset
wide_launches = 0  # wide-entry launches since the last reset
cluster_launches = 0  # cluster-entry launches since the last reset
last_plan = None  # the plan of the last cluster-entry launch (mu_cuda.GridPlan)
GRID_SLICES = 8  # csrc/cnmf.cu CNMF_GRID_SLICES
WIDE_THREADS = 512  # csrc/cnmf.cu CNMF_WIDE_THREADS
WIDE_BLOCKS = 1024 // WIDE_THREADS  # most wide blocks a SM (64 registers a thread)
BLOCK_BLOCKS = 8  # most block-entry blocks a SM (csrc/cnmf.cu's launch bounds)
# Iterations a fit runs in one block-entry launch of a batch larger than a
# wide wave, before the running fits are read (a multiple of check_every).
CHUNK_ITERS = 500


def _lp(l: int) -> int:
    """Row stride of X and its reconstruction: L rounded up to a power of
    two of at least 8 (csrc/cnmf.cu ``cnmf_lp``)."""
    lp = 8
    while lp < l:
        lp *= 2
    return lp


def smem_bytes(t: int, l: int, k: int, d: int) -> int:
    """Shared memory of one fit (csrc/cnmf.cu ``cnmf_smem_floats``): X
    and its reconstruction ``(T, Lp)`` with ``Lp`` = L rounded up to a
    power of two of at least 8, C transposed ``(K, T)`` rounded up to 4
    floats, S ``(K, D, Lp)``, the S update's partial sums (16 floats per
    (k, d) pair and time slice after the first) and 33 doubles."""
    lp = _lp(l)
    pairs = k * d
    groups = min(4, max(1, 128 // pairs))  # csrc/cnmf.cu cnmf_groups
    floats = 2 * t * lp + (k * t + 3) // 4 * 4 + pairs * lp
    floats += 16 * (groups - 1) * pairs
    floats += floats & 1
    return 4 * (floats + 2 * 33)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_items(l: int, k: int, d: int) -> int:
    """(k, d, L-tile) items of the cluster entry's S sums, 16 floats each
    (csrc/cnmf.cu ``cnmf_grid_items``)."""
    return k * d * (_lp(l) // 8)


def grid_small_floats(l: int, k: int, d: int) -> int:
    """Floats of a cluster-entry block besides its rows: the X and Xh rows
    past a tile, S, float64 scratch, the S sums and the time slices'
    partial sums, the halo and carried rows of C, C^T's halo columns
    (csrc/cnmf.cu ``cnmf_grid_small_floats``)."""
    lp, h1, items = _lp(l), d - 1, grid_items(l, k, d)
    slices = min(GRID_SLICES, max(1, GRID_THREADS // items))
    return (2 * h1 * lp + k * d * lp + 68 + 16 * items * slices + 3 * h1 * k
            + k * (2 * h1 + 3))


def cluster_smem_bytes(l: int, k: int, d: int) -> int:
    """Shared memory of one block of the cluster entry at its least: its
    small state (:func:`grid_small_floats`) and a streamed tile of
    ``CLUSTER_MIN_TILE`` rows of X, its reconstruction and C.  The entry
    takes an ``(l, k, d)`` fit of any length when this fits one block."""
    return 4 * (grid_small_floats(l, k, d) + CLUSTER_MIN_TILE * (2 * _lp(l) + k))


def grid_plan(batch: int, t: int, l: int, k: int, d: int, sms: int) -> GridPlan:
    """The cluster entry's plan for ``batch`` fits of ``(t, l)`` frames
    with ``k`` synergies of ``d`` lags on a card of ``sms`` SMs
    (csrc/cnmf.cu ``cnmf_grid_rule``): K1's rule
    (:func:`~.mu_cuda.grid_rule`) with K5's small state and rows of ``2
    Lp + k`` floats (X, its reconstruction, C)."""
    try:
        return grid_rule(batch, t, sms, grid_small_floats(l, k, d), 2 * _lp(l) + k)
    except ValueError as e:
        raise ValueError(f"cnmf {t}x{l} with {k} synergies of {d} lags: {e}") from None


def grid_workspace_floats(plan: GridPlan, batch: int, l: int, k: int, d: int) -> int:
    """Floats of the cluster entry's workspace (csrc/cnmf.cu
    ``cnmf_grid_workspace_floats``): the fits' arrive counters, a flag and
    a float64 error slot a block, the fits' edge slots (two parities of a
    block's first and last D - 1 rows of C) and two partial sets a
    block."""
    blocks = batch * plan.blocks
    edges = _cdiv(4 * plan.blocks * (d - 1) * k, 4) * 4
    return (_cdiv(batch, 4) * 4 + 3 * _cdiv(blocks, 4) * 4 + batch * edges
            + 2 * blocks * 16 * grid_items(l, k, d))


def _per_sm(most: int, t: int, l: int, k: int, d: int) -> int:
    """Fits an SM holds: ``most``, or as many as its shared memory holds."""
    return min(most, SM_SMEM // (smem_bytes(t, l, k, d) + 1024))


def wide_wave(t: int, l: int, k: int, d: int, sms: int) -> int:
    """Fits one wave of the wide entry holds on a card of ``sms`` SMs:
    ``WIDE_BLOCKS`` a SM, or as many as the SM's shared memory holds."""
    return sms * _per_sm(WIDE_BLOCKS, t, l, k, d)


def wide_keeps(running: int, t: int, l: int, k: int, d: int, sms: int) -> bool:
    """Whether ``running`` fits go to the wide entry: when one wave of it
    holds them, or at any batch when shared memory leaves the block entry
    no more fits an SM than the wide entry (2,400 x 8: one each, the wide
    entry 2.1 times as fast at 1-528 fits on an H100).  Past one wave of
    200 x 8 fits (2 an SM against 8) the block entry's fixed iterations
    are the faster, and with the stop the block-entry chunks then the
    wide tail (``scripts/torch_cnmf_entries.py``)."""
    return (running <= wide_wave(t, l, k, d, sms)
            or _per_sm(BLOCK_BLOCKS, t, l, k, d) <= _per_sm(WIDE_BLOCKS, t, l, k, d))


def route(t: int, l: int, k: int, d: int, *, batch: int | None = None,
          sms: int | None = None) -> str:
    """K5's entry for ``batch`` fits of ``(t, l)`` frames with ``k``
    synergies of ``d`` lags on a card of ``sms`` SMs: within one block's
    shared memory ``"wide"`` where :func:`wide_keeps` the batch, else
    ``"block"`` (a batch left out is taken as one that fills the card);
    past it ``"cluster"``; raises
    ``ValueError`` (naming ``impl='torch'``) when even a cluster block
    cannot hold the fit's small state and a tile of rows."""
    if not 1 <= d <= t:
        raise ValueError(f"cnmf: {d} lags outside 1..{t} samples")
    if smem_bytes(t, l, k, d) <= SMEM_LIMIT:
        if batch is not None:
            if sms is None:
                raise ValueError("a batch's route needs the card's SM count (sms=)")
            if wide_keeps(batch, t, l, k, d, sms):
                return "wide"
        return "block"
    if cluster_smem_bytes(l, k, d) <= SMEM_LIMIT:
        return "cluster"
    raise ValueError(
        f"cnmf: one fit of {t}x{l} with {k} synergies of {d} lags needs "
        f"{cluster_smem_bytes(l, k, d)} bytes of shared memory a block even on "
        f"the cluster entry, over {SMEM_LIMIT}; use impl='torch'"
    )


def launch_plan(running: int, t: int, l: int, k: int, d: int, sms: int,
                check_every: int) -> tuple[str, int | None]:
    """The next launch of a fit with the stop on, ``running`` fits still
    going: ``("wide", None)`` (to the end) once :func:`wide_keeps` them,
    else ``("block", cap)``, ``CHUNK_ITERS`` rounded up to a multiple of
    ``check_every``."""
    if wide_keeps(running, t, l, k, d, sms):
        return "wide", None
    return "block", _cdiv(CHUNK_ITERS, check_every) * check_every


def check_shapes(name: str, xs, c, s) -> str:
    """Raise unless the problem fits the kernel's bounds; returns its
    entry for a batch that fills the card (:func:`route`)."""
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
    return route(t, l, k, d)


# the one-block entries: x, c, s, the fits' list, its length, then per fit
# n_iter, prev_err (float64), scale (float64), converged
ONE_BLOCK_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 6 + [ctypes.c_double] + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])


def _lib(entry: str):
    lib = load("cnmf")
    if entry == "wide" and lib.cnmf_wide_threads() != WIDE_THREADS:
        raise RuntimeError(f"cnmf.cu's wide entry runs {lib.cnmf_wide_threads()} threads "
                           f"a fit, this wrapper plans for {WIDE_THREADS}")
    fn = {"block": lib.cnmf_f32, "wide": lib.cnmf_wide_f32,
          "cluster": lib.cnmf_cluster_f32}[entry]
    if entry == "cluster":
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_double]
                       + [ctypes.c_int] * 2 + CLUSTER_ARGTYPES + [ctypes.c_void_p])
    else:
        fn.argtypes = ONE_BLOCK_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _cluster_launch(xs, c0, s0, iters, tol, check_every, with_stop):
    global cluster_launches, last_plan
    b, t, l = xs.shape
    k, d = s0.shape[1], s0.shape[2]
    c, s = torch.empty_like(c0), torch.empty_like(s0)
    n_iter = torch.zeros(b, dtype=torch.int32, device=xs.device)
    prev_err = torch.zeros(b, dtype=torch.float32, device=xs.device)
    converged = torch.zeros(b, dtype=torch.int32, device=xs.device)
    extra, held = cluster_call(xs, lambda sms: grid_plan(b, t, l, k, d, sms),
                               lambda plan: grid_workspace_floats(plan, b, l, k, d))
    err = _lib("cluster")(
        xs.data_ptr(), c0.data_ptr(), s0.data_ptr(), c.data_ptr(),
        s.data_ptr(), n_iter.data_ptr(), prev_err.data_ptr(),
        converged.data_ptr(), b, t, l, k, d, int(iters), float(tol),
        int(check_every), int(with_stop), *extra,
        _stream(xs),
    )
    if err != 0:
        raise RuntimeError(f"cnmf cluster entry launch failed: CUDA error {err}")
    last_plan = check_plan("cnmf", held)
    cluster_launches += 1
    return c, s, n_iter, prev_err, converged


def _one_block(entry, xs, c, s, fits, state, iters, cap, tol, check_every, with_stop):
    """One launch of the block or wide entry on the fits ``fits`` (a
    CUDA int32 tensor, or None for all), C and S updated in place."""
    global launches, wide_launches
    b, t, l = xs.shape
    k, d = s.shape[1], s.shape[2]
    n_iter, prev_err, scale, converged = state
    err = _lib(entry)(
        xs.data_ptr(), c.data_ptr(), s.data_ptr(),
        None if fits is None else fits.data_ptr(), b if fits is None else fits.numel(),
        n_iter.data_ptr(), prev_err.data_ptr(), scale.data_ptr(), converged.data_ptr(),
        t, l, k, d, int(iters), int(cap), float(tol), int(check_every), int(with_stop),
        _stream(xs),
    )
    if err != 0:
        raise RuntimeError(f"cnmf {entry} entry launch failed: CUDA error {err}")
    if entry == "wide":
        wide_launches += 1
    else:
        launches += 1


def _stream(xs):
    return torch.cuda.current_stream(xs.device).cuda_stream


def _launch(xs, c0, s0, iters, tol, check_every, with_stop):
    entry = check_shapes("cnmf", xs, c0, s0)
    xs, c0, s0 = xs.contiguous(), c0.contiguous(), s0.contiguous()
    if entry != "cluster":
        sms = card_sms(xs)
        entry = route(*xs.shape[1:], *s0.shape[1:3], batch=xs.shape[0], sms=sms)
    if entry == "cluster":
        c, s, n_iter, prev_err, converged = _cluster_launch(
            xs, c0, s0, iters, tol, check_every, with_stop)
    else:
        b, t, l = xs.shape
        k, d = s0.shape[1], s0.shape[2]
        c, s = c0.clone(), s0.clone()
        zeros = lambda dtype: torch.zeros(b, dtype=dtype, device=xs.device)  # noqa: E731
        state = (zeros(torch.int32), zeros(torch.float64), zeros(torch.float64),
                 zeros(torch.int32))
        n_iter, converged = state[0], state[3]
        if not with_stop:
            _one_block(entry, xs, c, s, None, state, iters, 1, 0.0, 1, False)
        else:
            fits = None
            while True:
                entry, cap = launch_plan(b if fits is None else fits.numel(),
                                         t, l, k, d, sms, check_every)
                if cap is None:  # to the end: the fit's own count bounds it
                    cap = (2**31 - 1) // check_every * check_every
                _one_block(entry, xs, c, s, fits, state, iters, cap, tol, check_every,
                           True)
                if entry == "wide":
                    break
                running = ((n_iter < iters) & (converged == 0)).nonzero().flatten()
                if running.numel() == 0:
                    break
                fits = running.to(torch.int32)
        prev_err = state[1].float()
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
