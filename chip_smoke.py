#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``muscle_synergies_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the nine hand-written CUDA kernels from the five sources in
``muscle_synergies_tpu_torch/csrc/`` (one ``nvcc`` per source, all
started together; K3 and K6 share ``sosfiltfilt.cu``; K1, K2 and K4
each have a warp entry, one warp per fit, for frames of at most 224 x
16 at rank 8, and a block entry, one block per fit, above that, only
for batches that fill the card with 4 waves or more of fits (K1 at rank
9-16, K2 at rank 9-10, K4 past its warp entry); K1, K2, K4 and K5 also
a cluster (grid) entry, each spreading one fit over many blocks of the
card, for frames over one block's shared memory and, K1, K2 and K4, for
every other frame past the warp entry) and then, failing on the first
assertion that does not hold:

1. prints the card and its power limit, and the build time;
2. K3 ``sosfiltfilt``: 64 trials x 124,460 samples x 8 channels through
   the kernel against ``scipy.signal.sosfiltfilt`` in float64 (all 64)
   and the plain version in float64 on the card (4 trials x 20,000
   samples: it takes one Python step per sample; that run is also the
   plain time); bar: max abs error <= 5e-4 * max|y|; then timed at 64
   and at 256 trials (the 64 four times over);
3. K1/K2 fixed iterations (stop compiled out): 50 MU / CD iterations at
   1024 x 200 x 8, rank 4 (K1's and K2's warp entries), at 16 x 2,000
   x 8 (K1's and K2's grid entries, each plan and blocks a SM logged)
   and at 1024 x 200 x 16, rank 12 (K1's block entry), each route
   asserted by batch, kernel in float32 against the plain version in
   float64; bar: max relative factor error <= 1e-3;
4. K1/K2 fits against a plain float64 fit on 128 of the 200 x 8
   problems (the warp entries), the 16 problems of 2,000 x 8 (the grid
   entries) and, K1, the 1024 of 200 x 16 (its block entry) at tol
   1e-4, each launch on the entry named: the median stopping gap must
   be 0, and the factor error at the kernel's own stopping iteration
   <= 1e-3;
5. the main path, ``analyze_dataset`` under the default
   ``PipelineConfig`` on 256 synthetic float32 trials of 124,460 x 8 at
   2000 Hz (ranks 1-4, 1,024 fits), once with ``solver="cd"`` and once
   with ``solver="mu"``: every kernel's launch counter must rise, every
   VAF be finite and <= 1, the mean VAF rise from rank 1 to 4, and a
   16-trial subset match ``impl="torch"`` to VAF 1e-3 (CD at
   ``max_iter=2,000`` on both sides); on that subset's CD inputs (ranks
   1-4 padded to 4, one launch of K2's warp entry) the rank-1 fits hold
   the same bits as the same fits launched at k = 1 (50 fixed
   iterations, and fits), and the longest rank-1 fit alone is timed at
   the path's stop beside the parent design's 5.14 us an iteration
   (PERF.md); then MU on 64
   trials of 16 channels (two trials side by side), ranks 1-12 at
   ``max_iter=2,000``: one K3 launch and one of K1's block entry (768
   fits of 200 x 16 at rank 12), the VAF rising with rank and 4 trials
   matching ``impl="torch"`` to VAF 1e-3; and CD on the same trials,
   ranks 1-10: one launch of K2's block entry (640 fits of 200 x 16 at
   rank 10), the same checks, then that launch's inputs through the
   block entry against float64: 50 fixed iterations (bar 1e-3) and a fit
   at tol 1e-4 (median stopping gap 0, factor error at the kernel's stop
   <= 1e-3);
6. K4 fixed iterations: 50 beta-MU iterations at 1024 x 200 x 8, rank
   4, on strictly positive X, for beta = 1 (KL) and 0 (Itakura-Saito) on
   the warp entry and 1.5 (the generic kind) on the block entry; 50 KL
   iterations at 16 x 2,000 x 8 and 50 at beta 1.5 on 16 x 200 x 8 on
   the grid entry (plan and blocks a SM logged); each route asserted,
   kernel in float32 against the plain version in float64; bar: max
   relative factor error <= 1e-3;
7. K4 fits: 128 problems at tol 1e-4, max_iter 200, beta = 1 and 0
   (warp entry), the 1024 problems at beta = 1.5 (block entry), and the
   16 problems of 2,000 x 8 at beta = 1 (grid entry), each launch on the
   entry named, against a plain float64 fit: |median stopping gap| <= 10
   iterations and the factor error at the kernel's own stop <= 2e-3;
8. K5: 20 convolutive iterations at 1024 x 200 x 8, K = 4, D = 10,
   against the plain version in float64 (bar 1e-3); then 128 fits at
   tol 1e-4 against float64: |median gap| <= 10, error at the
   kernel's own stop <= 2e-3;
9. the KL main path: ``analyze_dataset(solver="mu",
   beta_loss="kullback-leibler")`` on the 256 trials of phase 5 with
   the default device and config: the K3 and K4 launch counters must
   rise, every VAF be finite and <= 1, the mean VAF rise from rank 1 to
   4, and a 16-trial subset match ``impl="torch"`` to VAF 1e-3; then the
   same with ``beta_loss=1.5`` at ``max_iter=2,000``: one launch of K4's
   block entry (the 1,024 fits), the same checks;
10. the time-varying main path: ``analyze_dataset_time_varying(
    n_synergies=4, n_lags=10, n_inits=4)`` on the same 256 trials
    (1,024 fits): the K3 and K5 counters must rise, every VAF be finite
    and <= 1, and a 16-trial subset match ``impl="torch"`` to VAF 1e-3
    at ``max_iter=2,000`` on both sides;
11. K6 ``sosfilt`` (the causal cascade from given states): 64 trials x
    124,460 x 8 through the kernel from ``zi = sosfilt_zi * x[0]`` per
    column, against ``scipy.signal.sosfilt`` in float64 (all 64) and
    the plain version in float64 on the card (4 trials x 20,000
    samples: it takes one Python step per sample); then those 4 whole
    trials cut into 8,192-row chunks, carrying ``zf`` from chunk to
    chunk, against one whole-signal launch; bar: max abs error <= 5e-4
    * max|y| in each case; then timed at 64 and at 256 trials;
12. the causal main path: ``analyze_dataset`` with
    ``FilterSpec(zero_lag=False)`` and ``solver="mu"`` on the 256 trials
    of phase 5: the K6 and K1 counters must rise and K3's stay at 0,
    with the VAF checks of phase 5 (``impl`` picks only the solver, so
    K6 still filters the subset's trials);
13. the RMS main path: ``analyze_dataset`` with ``use_rms=True`` and
    ``solver="cd"`` on 256 ragged trials (lengths drawn from 100,000 to
    124,460 samples by a numpy seed): K2's counter must rise; 4 trials'
    moving RMS on the card match ``np.convolve(x**2, ones(w)/w,
    "same")`` in float64 to 1e-5 relative; the VAF checks of phase 5,
    the subset against ``impl="torch"`` at ``max_iter=2,000`` on both
    sides (the plain CD loop at the default 100,000 would take minutes);
    then ``preprocess_trials`` under the causal and under the default
    zero-phase envelope on the same ragged trials: one K6 launch, or one
    K3 launch (each trial filtered over its own length), for the padded
    batch, and 4 of its rows within 1e-5 x max of the same trials
    preprocessed one at a time;
14. the per-capture API, no pandas: ``NMFModel(n_components=4)`` on one
    preprocessed 200 x 8 trial (``fit_transform`` through K2's warp
    entry, one launch; ``transform``, plain), ``rank_sweep_batch`` over
    ranks 1-8 on it (one launch of the warp entry); the same trial
    resampled to 2,000 x 8 through ``NMFModel`` with the CD, MU and KL
    solvers (one launch each of the grid entries of K2, which its route
    names for a batch of one, K1 and K4, each within 1e-3 of float64 in
    reconstruction error); on a 20,000 x 8
    frame, over one block's shared memory, ``fit_transform`` in exactly
    one launch of K2's cluster entry and no other, and with
    ``impl="torch"`` the plain fit on the card (no counter moves), the
    two within 1e-3 in reconstruction error;
15. the capture main path, no pandas: 16 Vicon Nexus captures written
    by ``testing.write_synthetic_capture`` at the reference trial's scale
    (2,000 Hz, 2 force plates and an 8-channel EMG, 40 markers at 100
    Hz, 4 passes x 2 cycles, capture i with ``seed=i`` and
    ``state_len=2,800 + 20 i``: 114,800-127,100 samples), in parallel
    processes that load the writer's module from its file alone (no
    torch import), then the package's import timed in a fresh process
    for comparison; ``io.load_vicon_files`` (native decoder, threads), one
    capture held bit for bit against the plain decoder and its EMG
    against the writer's array; ``segment.Segmenter`` on each, whose
    transitions must sit on the written state boundaries; the 8 gait
    cycles of each cut from the EMG (stop inclusive), 128 ragged trials
    of 11,200-12,400 x 8, each a ``DeviceData`` of its own; then
    ``analyze_dataset(trials, 2000.0, ranks=(1, 2, 3, 4))`` under the
    default config: exactly one K3 launch (per-trial lengths), K2's warp
    entry and no block entry, the VAF checks of phase 5, the channel
    names from the EMG's coords, and a 16-trial subset against
    ``impl="torch"`` at ``max_iter=2,000`` on both sides; K3's launch
    at that shape (the 128 cycles, per-trial lengths) against
    ``scipy.signal.sosfiltfilt`` in float64 on each cycle's own samples
    (bar 5e-4 x max|y|), and the card's preprocess of the shortest and
    the longest cycle against the plain chain in float64 on the host
    (bar 1e-5 x max); last, one capture's EMG streamed with
    ``io.DeviceStream`` in 8,192-row chunks through
    ``ops.filters.sosfilt`` (K6) carrying ``zf``, against one K6 launch
    on the loaded array and against ``scipy.signal.sosfilt`` in float64
    from the same states, bar 5e-4 x max|y| each;
16. the space-by-time dataset path, run before 15 while phase 5's 256
    trials are alive: ``analyze_dataset_space_by_time(n_temporal=4,
    n_spatial=3, n_inits=4)`` under the default config: exactly one K3
    launch and no other, unit-norm temporal (200 x 4) and spatial (3 x 8)
    modules, coefficients (256, 4, 3) >= 0, every VAF finite and <= 1;
    20 ``nm3f_update`` steps at 1024 x 200 x 8 in float32 against
    float64 on the host (bar 1e-4 at full float32, 5e-2 with
    ``precision="high"``, TF32); the 4 restarts fitted from the same
    inits on the card and in float64 on the host at ``max_iter=2,000``,
    overall and per-trial VAF within 1e-3; then the NM3F stage's time,
    iterations and, from the torch profiler, its kernels an iteration;
17. the per-capture convolutive and space-by-time models, no pandas:
    ``CNMFModel(4, 10, n_inits=4).fit_transform`` on one preprocessed
    200 x 8 trial (exactly one K5 launch; VAF within 1e-3 of the float64
    fit on the host), its ``transform`` of 16 other trials (plain torch,
    no launch), the card's default start equal to the host's draw and
    ``cnmf_transform`` of them from that start at ``tol=0``,
    ``max_iter=200`` within 1e-3 of float64; ``NM3FModel(4, 3).fit`` on
    64 trials and ``transform`` of 16 new ones (no launch), and
    ``nm3f_transform`` from one start at ``tol=0``, ``max_iter=200``
    within 1e-3 of float64;
18. stability and held-out rank selection (``models.stability``), run
    after 17 on phase 16's preprocessed trials: ``bootstrap_synergies(x,
    4)`` at its defaults (50 resamples) on one subject's 12 cycles
    (2,400 x 8) in exactly one launch of K1's grid entry (51 fits of two
    blocks each; plan and time in the stage line), and on one
    200 x 8 trial in one launch of its warp entry; a 5,000 x 8 matrix in
    one launch of K1's cluster entry, and of K5's for
    ``bootstrap_time_varying_synergies(x, 4, 10, n_boot=2)``;
    ``bootstrap_time_varying_synergies(x, 4, 10, n_boot=20)`` in exactly
    one K5 launch; each held against the same call in float64 on the host
    (similarities within 2e-3, reference components' cosines >= 0.999);
    ``cv_rank_selection`` over ranks 1-8 and
    ``cv_time_varying_rank_selection`` over 2-5 (plain torch, no launch:
    the best rank equal to float64's, held-out errors within 1e-3
    relative); ``bootstrap_space_by_time`` (20 resamples) and
    ``cv_space_by_time_selection`` on 64 trials with the same bars, and
    the masked NM3F loop's time, iterations and kernels an iteration;
    last ``analyze_dataset`` on 64 trials as 8 subjects of 8 trials,
    ``cluster_subjects(4)``, and ``cluster_synergies``/``match_synergies``
    of the subjects' components as float32 card tensors, equal to the
    float64 host run (labels, membership, pairs exactly; consensus
    within 1e-6).
19. resume, persistence, export and profiling, after 18 on the same
    trials, no pandas: ``bootstrap_synergies_checkpointed`` on phase 18's
    2,400 x 8 subject (rank 4, 50 resamples in chunks of 10) from an
    empty directory (exactly 5 launches of K1's grid entry, each planned
    for the one-shot call's 51 fits), fully restored (1 launch,
    the reference) and with two chunks deleted (2 launches), its
    similarities and reference within 1e-6 of the one-shot
    ``bootstrap_synergies``; the convolutive one (20 resamples, exactly 2
    K5 launches) to the same bar; ``cv_rank_selection_checkpointed``
    over ranks 1-8 from empty and with three candidates deleted, the
    same best rank as the one-shot call and its columns within 1e-6
    relative in float64 (the float32 gap logged); an ``NMFModel(4)``
    fitted through K2's warp entry, phase 17's ``CNMFModel`` and
    ``NM3FModel`` saved and loaded (factors and the transform of 16
    trials bit-equal; loadable with ``device="cpu"``); each transform
    exported for ``("b", 200, 8)`` on the card and replayed by a process
    that has torch and NumPy but not this package, on 16 and on 3
    trials, within 1e-5 relative of the eager transform; last
    ``annotate`` in the torch profiler's trace with device time,
    ``debug_nans`` raising for a torch op and for K1's wrapper, and
    ``solver_report`` against NumPy.
20. the pipelined dataset path and the command line, on phase 15's 16
    captures before their directory is removed, no pandas:
    ``analyze_dataset_pipelined(paths, chunk_files=4, prefetch=2)``
    (a producer thread parses, pads into pinned memory and stages each
    chunk on a side CUDA stream): exactly one K3 launch a chunk, K2's
    warp entry, no other counter, VAF overall and per channel within 1e-4
    of ``analyze_dataset`` on the same parsed captures, and from the torch
    profiler's trace no device->host copy over 64 bytes beyond the
    results' bytes (the host->device copies logged with their kind and
    stream); the chunked float64 path against the one-shot one on 4
    captures cut by one count from their ends (their real differences in
    length, 10,000 samples the shortest), two ragged chunks, ``max_iter``
    2,000, on the host, not on the card (K3 takes float32 only): VAF
    within 1e-6, ``w`` within 1e-5; the wall times of ``chunk_files`` 2,
    4 and 16 against parsing then analysing, and the analysis alone chunk
    by chunk (no bar);
    then the CLI through ``main()``: ``describe``, ``analyze --ranks 1:4
    --save-model`` (one K3 and one K2 warp launch), ``analyze --ranks 1:4
    --reduce-to 0`` on the whole capture (one K3 launch and one of K2's
    cluster entry), ``analyze-dataset``
    with and without ``--prefetch 2 --chunk-files 4`` (VAF within 1e-4
    of each other) and with ``--subjects`` of 4 labels and
    ``--cluster-subjects 4``, ``export-transform`` of the saved rank 4
    for ``b,200,8`` on the card, replayed on 16 trials within 1e-5 of the
    eager transform; last ``python -X importtime -m
    muscle_synergies_tpu_torch analyze-dataset`` in a subprocess with no
    ``--platform``: exit 0, its report within 1e-4 of the in-process one,
    and neither pandas nor matplotlib imported.

21. the device mesh (``parallel``, ``torch.distributed``) at world size
    1 over a real NCCL communicator, after 19: ``init_distributed()``
    and ``make_mesh((1, 1))`` / ``make_mesh((1, 1), ("data", "model"))``
    (the backend must be NCCL and every shard on the card); the meshed
    ``analyze_dataset`` on phase 5's trials with MU at ``max_iter``
    100,000 and with CD (a 2,000-iteration probe first; when it projects
    past 60 s at 100,000, both sides run at 2,000), each one K3 launch
    and no solver launch, VAF within 1e-3 of phase 5's kernel path (w
    and h gaps, wall time and time an iteration printed against K1's and
    K2's); ``sharded_sosfiltfilt`` / ``sharded_sosfilt`` on 64 x 124,460
    x 8 folded to 512 channels, 7 and 2 K6 launches, within 5e-4 x
    max|y| of K3 / K6, timed against them; ``sharded_fit_cd``,
    ``sharded_fit_kl``, ``sharded_fit_mu_tp``, ``sharded_fit_cnmf`` and
    ``sharded_fit_nm3f`` for 30 iterations against the plain functions
    from the same start (1e-4); the meshed ``bootstrap_synergies`` and
    ``cv_rank_selection`` on phase 18's subject against phase 18's
    results (its bars); and an ``orbax`` checkpoint chunk saved and
    restored bit-equal.
22. large frames (K1's and K2's cluster entries), after 21: (a) 50
    fixed iterations of each at 4 x 20,000 x 8, rank 4 (33 blocks a fit)
    and 2 x 124,460 x 8, rank 8 (66 blocks a fit), rows resident in
    shared memory, against the plain version in float64, bar 1e-3, then
    timed at the second; every launch's plan (blocks a fit, rows a
    block, resident or streamed) is the one ``mu_cuda.grid_plan`` gives;
    (b) ranks 1-4 with the stop on (tol 1e-4, max_iter 500) on a subject's
    30 cycles (6,000 x 8) and on two trials' envelopes side by side
    (20,000 x 16) against float64, phase 4's method: median stopping gap
    0 (CD at rank 1, which starts at its optimum, exempt) and factor
    error at the kernel's stop <= 1e-3; (c) under default arguments:
    ``find_synergies``' array core on a whole trial's 124,460 x 8
    envelope, ranks 1-4 batched (one K2 cluster launch),
    ``bootstrap_synergies`` on the 6,000 x 8 subject (one K1 cluster
    launch; phase 18's bars against float64), and the dataset grid at
    full length (4 whole trials' envelopes, one K3 launch, then ranks 1-4
    as 16 fits, one K2 cluster launch; ``analyze_dataset`` itself needs
    ``reduce_to``, as the JAX package's does) against ``impl="torch"``
    to VAF 1e-3 at max_iter 2,000 on both sides (the 16 fits' rows
    exceed the card's shared memory, so they stream); (d) the time of an
    iteration of a lone 124,460 x 8 fit and of 4 at once on each entry,
    with the plan each took, beside the plain loop's and the bound.
23. large frames (K4's and K5's cluster entries), after 22: (a) 50
    fixed iterations at 4 x 6,000 x 8, 4 x 124,460 x 8 (K4 resident on 33
    blocks a fit, K5 streamed, as ``CNMFModel(4, 10)`` runs it) and 1 x
    124,460 x 8 (resident), rank 4, for beta = 1, 0, 1.5 and -0.5, and of K5
    at K = 4, D = 10, against the plain version in float64, bar 1e-3,
    then timed at the last; every launch's plan (blocks a fit, rows a
    block, resident or streamed) is logged and is the one
    ``beta_cuda.grid_plan`` / ``cnmf_cuda.grid_plan`` gives; (b) fits with the stop
    on (max_iter 500) on a subject's 30 cycles (6,000 x 8): K4 at ranks
    1-4 for KL and IS (tol 1e-4), K5 with 4 restarts (tol 1e-3),
    against float64 at phase 7's bars (|median stopping gap| <= 10 iterations, factor
    error at the kernel's stop <= 2e-3); (c) under default arguments,
    each exactly one cluster launch and no other launch:
    ``NMFModel(4, solver="mu", beta_loss="kullback-leibler").fit`` on
    the 30 cycles, ``find_synergies``' array core with the KL loss on a
    whole trial's 124,460 x 8 envelope (ranks 1-4 batched),
    ``CNMFModel(4, 10).fit`` on that envelope (4 restarts), and
    ``bootstrap_time_varying_synergies`` on the 30 cycles, held to
    float64 at phase 18's bars; (d) the time of an iteration of a lone
    124,460 x 8 fit and of 4 at once on each entry (K4 for beta = 1, 0,
    1.5; K5's 4 stream their rows), with the plan each took, beside the
    plain loop's and the bound.

Each main path is driven with every launch counter set to 0 just before
it and read just after; the CD, RMS-CD and ``rank_sweep_batch`` paths
must take K2's warp entry, the MU and causal paths K1's and the KL path
K4's, never a block entry.  The script prints each stage's time beside the
card's name and power limit, then one JSON line with every kernel's
launches on the main paths, its error against the plain version
(absolute, and relative to the plain result's largest magnitude, which
is what its ``tol`` bounds), its time beside the plain version's, its
bound (the larger of the bytes it must move over the card's memory rate
and its operations over the peak rate of their type) and
``library_ms`` (null: no single PyTorch call computes any of these
functions), and last ``{"ok": true, "device": {...}}``.  Without a CUDA
card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

FS = 2000.0  # Hz
N_SAMPLES = 124_460  # one full trial of the reference capture
N_CHANNELS = 8
MAIN_TRIALS = 256
SUBSET = 16
RAGGED_MIN = 100_000  # the RMS path's shortest ragged trial
CAPTURES = 16  # phase 15's written captures
STATE_LEN = 2_800  # capture i holds 41 support states of STATE_LEN + 20 i samples
N_MARKERS = 40  # the reference trial's marker montage
F64_BASE = 10_000  # phase 20's float64 check: the shortest capture's samples

# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
NO_LIBRARY = "no single PyTorch call computes this"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, kind: str = "f32"):
    """The least time in ms the card could take, and what sets it."""
    ops_ms = flops / PEAK_FLOPS[kind] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nmf_flops(kernel: str, n: int, l: int, k: int, d: int = 1) -> int:
    """Operations of one iteration of one fit as the kernels compute them
    (a multiply-add counts 2; a divide, power, root or log counts 1)."""
    if kernel == "mu_nmf":
        return 4 * n * l * k + 4 * n * k * k + 4 * k * k * l + 2 * n * k + 2 * k * l
    if kernel == "cd_nmf":
        return 4 * n * l * k + 4 * n * k * k + 4 * k * k * l + 3 * n * k + 3 * k * l
    if kernel == "beta_nmf_kl":  # two WH rebuilds, two numerators, quotients
        return 8 * n * l * k + 2 * n * l + 3 * n * k + 3 * k * l
    if kernel == "beta_nmf":  # KL's work plus two denominator projections
        return 12 * n * l * k + 6 * n * l + 3 * n * k + 3 * k * l
    if kernel == "cnmf":  # six passes of K*D*L*T multiply-adds
        return 12 * k * d * l * n + 2 * k * d * l + 2 * k * n
    raise ValueError(kernel)


def fit_bound(kname: str, n_iter, n: int, l: int, k: int, nbytes: int,
              d: int = 1) -> None:
    """Log a fit's bound: the iterations its fits ran (data-dependent)
    times the operations of one iteration, against the bytes it moves."""
    iters = int(n_iter.sum())
    ms, by = bound(iters * nmf_flops(kname, n, l, k, d), nbytes)
    log(f"fit {kname}: {iters} iterations over {n_iter.numel()} fits "
        f"(max {int(n_iter.max())}); bound {ms:.3f} ms ({by})")


def synthetic_emg(n_trials: int, seed: int) -> np.ndarray:
    """``(B, N, 8)`` float32 EMG with non-negative 4-synergy structure.

    Each trial's envelope is ``C @ W``: four smooth, non-negative,
    gait-periodic activation profiles (about one cycle a second, with
    per-trial phase and rate) mixing into eight muscles through a
    non-negative W; the EMG is that envelope times unit Gaussian noise.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES, dtype=np.float32) / np.float32(FS)
    out = np.empty((n_trials, N_SAMPLES, N_CHANNELS), dtype=np.float32)
    base_w = rng.random((4, N_CHANNELS)).astype(np.float32)
    for b in range(n_trials):
        rate = np.float32(0.9 + 0.2 * rng.random())
        phase = rng.random(4).astype(np.float32)
        cycle = (t[:, None] * rate + phase[None, :]) % np.float32(1.0)
        centers = np.array([0.1, 0.35, 0.6, 0.85], dtype=np.float32)
        acts = np.exp(-0.5 * ((cycle - centers) / np.float32(0.08)) ** 2)
        w = base_w * (0.8 + 0.4 * rng.random((4, N_CHANNELS))).astype(np.float32)
        env = acts @ w + np.float32(0.02)
        out[b] = env * rng.standard_normal(env.shape, dtype=np.float32)
    return out


def rel_err(a, b) -> float:
    """Max over problems of max|a - b| / max|b| (bench.py --check's measure)."""
    num = (a.double() - b.double()).abs().amax(dim=tuple(range(1, a.ndim)))
    den = b.double().abs().amax(dim=tuple(range(1, b.ndim)))
    return float((num / den).max())


def abs_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def plain_snapshot(step, xs, w, h, counts):
    """Run ``step`` on each problem exactly ``counts[b]`` times."""
    w, h = w.clone(), h.clone()
    counts = counts.to(xs.device)
    for i in range(int(counts.max())):
        idx = (counts > i).nonzero().flatten()
        wa, ha = step(xs[idx], w[idx], h[idx])
        w[idx], h[idx] = wa, ha
    return w, h


_WRITER = "_chip_smoke_capture_writer"


def _write_capture(path: str, state_len: int, n_markers: int, seed: int):
    """One of phase 15's captures (a process pool's task: module level).

    The writer module is loaded from its file alone: ``testing.py``
    needs only numpy (and scipy), so a writer process skips the
    package's ``__init__`` and its torch import.  Returns the seconds
    spent loading the writer (0 once a process has it) and writing.
    """
    import importlib.util

    t0 = time.perf_counter()
    if _WRITER not in sys.modules:
        spec = importlib.util.spec_from_file_location(_WRITER, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "muscle_synergies_tpu_torch",
            "testing.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[_WRITER] = module
    t1 = time.perf_counter()
    sys.modules[_WRITER].write_synthetic_capture(
        path, state_len=state_len, n_markers=n_markers, seed=seed)
    return t1 - t0, time.perf_counter() - t1


def _cut_cycles(data, segmenter):
    """Every gait cycle of a capture's EMG (stop inclusive, as
    ``segment.phase_summary`` cuts), each a ``DeviceData`` of its own
    whose frames count from 1 at the cycle's start."""
    from muscle_synergies_tpu_torch import DeviceData, ForcesEMGFrameTracker, SamplingFreq

    emg, rates = data.emg, data.sampling_freq
    out = []
    for trecho, cycles in segmenter.segments.items():
        for cycle in cycles:
            times = segmenter.get_times_of(trecho, cycle)
            start, stop = emg.to_index(times.start), emg.to_index(times.stop) + 1
            tracker = ForcesEMGFrameTracker(SamplingFreq(
                rates.freq_forces_emg, rates.freq_traj,
                num_frames=(stop - start) // rates.num_subframes))
            out.append(DeviceData(emg.name, emg.dev_type, emg.units, tracker,
                                  array=emg.array[start:stop], coords=emg.coords))
    return out


class Smoke:
    """One run's card, its kernel records and its main-path launch counts."""

    def __init__(self, dev, smi: str):
        import torch

        from muscle_synergies_tpu_torch.models.kernels import (
            beta_cuda,
            cd_cuda,
            cnmf_cuda,
            mu_cuda,
        )
        from muscle_synergies_tpu_torch.ops import filter_cuda

        self.torch = torch
        self.dev = dev
        self.smi = smi
        self.rng = np.random.default_rng(0)
        self.kernels = {}
        # each kernel's launch counter: (module, attribute)
        self.counters = {"sosfiltfilt": (filter_cuda, "launches"),
                         "sosfilt": (filter_cuda, "sosfilt_launches"),
                         "cd_nmf": (cd_cuda, "launches"),
                         "cd_nmf_warp": (cd_cuda, "warp_launches"),
                         "cd_nmf_cluster": (cd_cuda, "cluster_launches"),
                         "mu_nmf": (mu_cuda, "launches"),
                         "mu_nmf_warp": (mu_cuda, "warp_launches"),
                         "mu_nmf_cluster": (mu_cuda, "cluster_launches"),
                         "beta_nmf": (beta_cuda, "launches"),
                         "beta_nmf_warp": (beta_cuda, "warp_launches"),
                         "beta_nmf_cluster": (beta_cuda, "cluster_launches"),
                         "cnmf": (cnmf_cuda, "launches"),
                         "cnmf_cluster": (cnmf_cuda, "cluster_launches")}
        self.launches = {name: 0 for name in self.counters}
        self.phase5, self.phase18 = {}, {}  # results phase 21 is held against
        self.small_grid = {}  # the grid entries on block-range frames (phases 3, 6)

    def stage(self, label: str, seconds: float) -> None:
        log(f"stage {label}: {seconds:.3f} s  [{self.smi}]")

    def timed(self, label: str, fn):
        """Run ``fn`` between two synchronisations and log its time."""
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log(f"stage {label}: {(time.perf_counter() - t) * 1e3:.2f} ms  [{self.smi}]")
        return out

    def grid_fits(self, xs, fits, label: str = "", ranks=(1, 2, 3, 4)):
        """The stages of a batched rank sweep on preprocessed ``xs``: the
        NNDSVDA init of every (rank, trial) pair, zero-padded to the top
        rank, then each of ``fits`` (name -> ``fit(x, w, h)``) with its
        bound, the VAF of the first, and each one's longest fit alone."""
        from muscle_synergies_tpu_torch.models import batch as mb

        torch, top = self.torch, max(ranks)

        def grid_init():
            ws, hs = [], []
            for kk in ranks:
                w, h = mb.init_batch(xs, kk)
                ws.append(torch.nn.functional.pad(w, (0, top - kk)))
                hs.append(torch.nn.functional.pad(h, (0, 0, 0, top - kk)))
            return xs.repeat(len(ranks), 1, 1), torch.cat(ws), torch.cat(hs)

        gx, gw, gh = self.timed(f"{label}init (NNDSVDA, {len(ranks)} ranks)", grid_init)
        n, l = gx.shape[1:]
        states = {}
        for kname, fit in fits.items():
            states[kname] = self.timed(f"{label}fit {kname} (kernel, {gx.shape[0]} fits)",
                                       lambda: fit(gx, gw, gh))
            fit_bound(kname, states[kname].n_iter, n, l, top,
                      4 * gx.shape[0] * (n * l + 2 * (n * top + top * l)))
            medians = states[kname].n_iter.view(len(ranks), -1).float().median(dim=1)
            log(f"fit {kname}: n_iter median by rank {medians.values.tolist()}")
        st = states[next(iter(fits))]
        self.timed(f"{label}vaf", lambda: mb.vaf_batch(gx, st.w, st.ht.transpose(-1, -2)))
        for kname, fit in fits.items():
            self.lone_fit(f"{label}{kname}", states[kname].n_iter,
                          lambda i: fit(gx[i], gw[i], gh[i]))
        return gx, states

    def record(self, name, replaces, errs, ms, plain_ms, flops, nbytes,
               kind="f32", source=None, **extra):
        bound_ms, bound_by = bound(flops, nbytes, kind)
        log(f"{name}: bound {bound_ms:.4f} ms ({bound_by}); kernel at "
            f"{bound_ms / ms:.1%} of it  [{self.smi}]")
        self.kernels[name] = dict(
            route="cuda",
            source=f"muscle_synergies_tpu_torch/csrc/{source or name}.cu",
            replaces=replaces, max_abs_err=errs[0], max_rel_err=errs[1],
            tol=errs[2], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, library_note=NO_LIBRARY,
            **extra,
        )

    def main_path(self, label: str, fn):
        """Drive one main path with every launch counter at 0 just before
        it and read just after; returns its result and its counts."""
        torch = self.torch
        for mod, attr in self.counters.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.last_seconds = time.perf_counter() - t0
        self.stage(f"main {label}", self.last_seconds)
        counts = {k: getattr(mod, attr) for k, (mod, attr) in self.counters.items()}
        for k, v in counts.items():
            self.launches[k] += v
        log(f"main {label}: launches {counts}")
        return out, counts

    # ---- 2. K3 ----
    def filter_phase(self, n_trials: int = 64, plain_n: int = 20_000):
        from scipy import signal as sps

        from muscle_synergies_tpu_torch.ops import filter_cuda, filters

        torch, dev = self.torch, self.dev
        sos = filters.sos_design(4, 4.0, FS)
        raw = synthetic_emg(n_trials, seed=1)
        # the filter's input on the main path: zero-centered, rectified EMG
        x_host = np.abs(raw - raw.mean(axis=1, keepdims=True))
        del raw
        x = torch.from_numpy(x_host).to(dev)
        padlen = filters.default_padlen(sos)
        y = filter_cuda.sosfiltfilt_cuda(sos, x, padlen, "odd")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = sps.sosfiltfilt(sos, x_host.astype(np.float64), axis=1)
        log(f"filter: scipy float64 reference on the host {time.perf_counter() - t0:.2f} s")
        scale = float(np.abs(ref).max())
        err_scipy = float(np.abs(y.cpu().numpy() - ref).max()) / scale
        del ref
        # the plain version takes one Python step per sample: 4 x 20,000,
        # in float64 (the kernel's arithmetic), as reference and plain time
        xs4 = x[:4, :plain_n]
        y4 = filter_cuda.sosfiltfilt_cuda(sos, xs4, padlen, "odd")
        x64, plain = xs4.double(), []
        plain_ms = cuda_ms(lambda: plain.append(
            filter_cuda.sosfiltfilt_plain(sos, x64, padlen, "odd")), reps=1, warmup=0)
        err_plain = float((y4.double() - plain.pop()).abs().max())
        log(f"filter: kernel vs scipy {err_scipy:.3e} x max|y|, vs plain f64 at "
            f"4x{plain_n}x{N_CHANNELS} {err_plain / scale:.3e} x max|y| (bar 5e-4)")
        assert err_scipy <= 5e-4 and err_plain <= 5e-4 * scale, "filter disagrees"
        ms = cuda_ms(lambda: filter_cuda.sosfiltfilt_cuda(sos, x, padlen, "odd"))
        log(f"filter: {n_trials}x{x.shape[1]}x{N_CHANNELS} f32 kernel {ms:.3f} ms; "
            f"plain f64 at 4x{plain_n}x{N_CHANNELS} {plain_ms:.1f} ms")

        # each sample of each column: two passes (forward, backward) over the
        # padded signal, per second-order section 5 float64 multiply-adds
        def work(xb):
            cols = xb.shape[0] * N_CHANNELS
            return 2 * len(sos) * 10 * cols * (xb.shape[1] + 2 * padlen), 2 * xb.numel() * 4

        x4 = x.repeat(4, 1, 1)  # 256 trials
        ms4 = cuda_ms(lambda: filter_cuda.sosfiltfilt_cuda(sos, x4, padlen, "odd"))
        bound4, _ = bound(*work(x4), kind="f64")
        log(f"filter: {x4.shape[0]}x{x.shape[1]}x{N_CHANNELS} f32 kernel {ms4:.3f} ms, "
            f"bound {bound4:.4f} ms  [{self.smi}]")
        del x4
        self.record("sosfiltfilt", "muscle_synergies_tpu/ops/filter_pallas.py:508",
                    (err_plain, err_plain / scale, 5e-4), ms, plain_ms, *work(x),
                    kind="f64", plain_dtype="float64",
                    plain_at=f"4x{plain_n}x{N_CHANNELS}", rel_err_vs_scipy=err_scipy,
                    ms_256_trials=ms4, bound_ms_256_trials=bound4,
                    chunk=filter_cuda.CHUNK)

    # ---- 3./4. K1 and K2 (every entry of the block range) ----
    def nmf_phases(self, b=1024, n=200, l=8, k=4, iters=50, fb=128, big_b=16,
                   big_n=2000, wide_l=16, wide_k=12):
        from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda
        from muscle_synergies_tpu_torch.models.mu import mu_update

        torch, dev, rng = self.torch, self.dev, self.rng
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def problem(b_, n_, l_=l, k_=k):
            return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.random((b_, n_, l_)), np.abs(rng.standard_normal((b_, n_, k_))),
                np.abs(rng.standard_normal((b_, k_, l_))))]

        main, big, wide = problem(b, n), problem(big_b, big_n), problem(b, n, wide_l, wide_k)
        # the warp entries take the main paths' frames; above them K1 and K2
        # their grid entries for a small batch, K1 its block entry only for
        # a batch of fits past rank 8 that fills the card
        for mod in (cd_cuda, mu_cuda):
            assert mod.route(n, l, k) == "warp"
            assert mod.route(big_n, l, k, batch=big_b, sms=sms) == "cluster"
        assert mu_cuda.route(n, wide_l, wide_k, batch=b, sms=sms) == "block"
        cd_replaces = "muscle_synergies_tpu/models/kernels/cd_pallas.py:168"
        mu_replaces = "muscle_synergies_tpu/models/kernels/mu_pallas.py:269"
        fixed = {
            "mu_nmf_warp": (mu_cuda.mu_iterations_cuda, mu_cuda.mu_iterations_plain,
                            mu_replaces, main, (mu_cuda, "warp_launches")),
            "mu_nmf": (mu_cuda.mu_iterations_cuda, mu_cuda.mu_iterations_plain,
                       mu_replaces, wide, (mu_cuda, "launches")),
            "mu_nmf_cluster": (mu_cuda.mu_iterations_cuda, mu_cuda.mu_iterations_plain,
                               mu_replaces, big, (mu_cuda, "cluster_launches")),
            "cd_nmf_warp": (cd_cuda.cd_iterations_cuda, cd_cuda.cd_iterations_plain,
                            cd_replaces, main, (cd_cuda, "warp_launches")),
            "cd_nmf_cluster": (cd_cuda.cd_iterations_cuda, cd_cuda.cd_iterations_plain,
                               cd_replaces, big, (cd_cuda, "cluster_launches")),
        }
        for kname, (kern, plain, replaces, data, (mod, attr)) in fixed.items():
            xs, w0, h0 = data
            bb, nn, ll = xs.shape
            kk = w0.shape[-1]
            before = getattr(mod, attr)
            wk, hk = kern(xs, w0, h0, iters)
            assert getattr(mod, attr) == before + 1, f"{kname} took another entry"
            wp, hp = plain(xs.double(), w0.double(), h0.double(), iters)
            err = max(rel_err(wk, wp), rel_err(hk, hp))
            ms = cuda_ms(lambda: kern(xs, w0, h0, iters))
            plain_ms = cuda_ms(lambda: plain(xs, w0, h0, iters), reps=3)
            log(f"{kname}: {iters} iterations at {bb}x{nn}x{ll} k={kk}: rel err {err:.3e} "
                f"(bar 1e-3); kernel {ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
            assert err <= 1e-3, f"{kname} fixed iterations disagree"
            if kname.endswith("_cluster"):
                # the grid entry's record is the capture-length one (phase 22)
                log(f"{kname}: plan {mod.last_plan}, "
                    f"{mu_cuda.blocks_per_sm[kname[:6]]} blocks a SM  [{self.smi}]")
                self.small_grid[kname] = dict(ms=ms, plain_ms=plain_ms, err=err,
                                              shape=f"{bb}x{nn}x{ll}, k={kk}")
                continue
            extra = {"also_replaces": "muscle_synergies_tpu/models/kernels/" + (
                "cd_pallas.py:248" if kname.startswith("cd") else "mu_pallas.py:205")}
            self.record(kname, replaces, (abs_err([(wk, wp), (hk, hp)]), err, 1e-3),
                        ms, plain_ms, bb * iters * nmf_flops(kname[:6], nn, ll, kk),
                        4 * bb * (nn * ll + 2 * (nn * kk + kk * ll)),
                        source=kname[:6], shape=f"{bb}x{nn}x{ll}, k={kk}", **extra)

        fits = {
            "mu_nmf_warp": (mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain, mu_update,
                            [a[:fb] for a in main]),
            "mu_nmf": (mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain, mu_update, wide),
            "mu_nmf_cluster": (mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain, mu_update, big),
            "cd_nmf_warp": (cd_cuda.fit_cd_cuda, cd_cuda.fit_cd_plain, self._cd_step,
                            [a[:fb] for a in main]),
            "cd_nmf_cluster": (cd_cuda.fit_cd_cuda, cd_cuda.fit_cd_plain, self._cd_step,
                               big),
        }
        counter = {"warp": "warp_launches", "": "launches", "cluster": "cluster_launches"}
        for kname, (kern, plain, step, (fx, fw, fh)) in fits.items():
            fx64, fw64, fh64 = fx.double(), fw.double(), fh.double()
            mod, attr = (mu_cuda if kname.startswith("mu") else cd_cuda,
                         counter[kname[7:]])
            before = getattr(mod, attr)
            t0 = time.perf_counter()
            sk = kern(fx, fw, fh, max_iter=200, tol=1e-4)
            torch.cuda.synchronize()
            assert getattr(mod, attr) == before + 1, f"{kname} fit took another entry"
            fit_ms = (time.perf_counter() - t0) * 1e3
            sp = plain(fx64, fw64, fh64, max_iter=200, tol=1e-4)
            gap = (sk.n_iter - sp.n_iter).cpu().numpy()
            hk = sk.h if kname.startswith("mu") else sk.ht.transpose(-1, -2)
            wr, hr = plain_snapshot(step, fx64, fw64, fh64, sk.n_iter)
            err = max(rel_err(sk.w, wr), rel_err(hk, hr))
            log(f"{kname}: fit of {'x'.join(map(str, fx.shape))} at tol 1e-4: stopping "
                f"gap median {np.median(gap):g} (min {gap.min()}, max {gap.max()}); "
                f"factor err at the kernel's stop {err:.3e} (bar 1e-3); kernel wall "
                f"{fit_ms:.2f} ms")
            assert np.median(gap) == 0, f"{kname} fit stops elsewhere than float64"
            assert err <= 1e-3, f"{kname} fit disagrees"

    # ---- 6./7. K4 (every entry of the block range) ----
    def beta_phases(self, b=1024, n=200, l=8, k=4, iters=50, fb=128, big_b=16,
                    big_n=2000):
        from muscle_synergies_tpu_torch.models.beta import mu_update_beta
        from muscle_synergies_tpu_torch.models.kernels import beta_cuda, mu_cuda

        torch, dev, rng = self.torch, self.dev, self.rng

        def problem(b_, n_):
            # strictly positive X: beta <= 0 refuses zeros
            return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.random((b_, n_, l)) + 0.05,
                np.abs(rng.standard_normal((b_, n_, k))),
                np.abs(rng.standard_normal((b_, k, l))))]

        main, big = problem(b, n), problem(big_b, big_n)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def fixed(data, beta, counter):
            xs, w0, h0 = data
            t0 = time.perf_counter()
            before = getattr(beta_cuda, counter)
            wk, hk = beta_cuda.beta_iterations_cuda(xs, w0, h0, iters, beta)
            assert getattr(beta_cuda, counter) == before + 1, "beta_nmf took another entry"
            wp, hp = beta_cuda.beta_iterations_plain(xs.double(), w0.double(), h0.double(),
                                                     iters, beta)
            err = max(rel_err(wk, wp), rel_err(hk, hp))
            ms = cuda_ms(lambda: beta_cuda.beta_iterations_cuda(xs, w0, h0, iters, beta))
            plain_ms = cuda_ms(lambda: beta_cuda.beta_iterations_plain(xs, w0, h0, iters,
                                                                        beta), reps=3)
            log(f"beta_nmf ({counter}): {iters} iterations at {xs.shape[0]}x{xs.shape[1]}x"
                f"{l} k={k}, beta={beta:g}: rel err {err:.3e} (bar 1e-3); kernel "
                f"{ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
            self.stage(f"K4 fixed beta={beta:g} {xs.shape[0]}x{xs.shape[1]}",
                       time.perf_counter() - t0)
            assert err <= 1e-3, f"beta_nmf fixed iterations disagree at beta={beta}"
            return ms, plain_ms, abs_err([(wk, wp), (hk, hp)]), err

        # the warp entry takes KL and IS at the main paths' frames; a
        # run-time beta on them takes the block entry at the main paths'
        # 1,024 fits and the grid entry at 16, as do KL's larger frames
        assert beta_cuda.route(n, l, k, 1.0) == beta_cuda.route(n, l, k, 0.0) == "warp"
        assert beta_cuda.route(n, l, k, 1.5, batch=b, sms=sms) == "block"
        assert beta_cuda.route(n, l, k, 1.5, batch=big_b, sms=sms) == "cluster"
        assert beta_cuda.route(big_n, l, k, 1.0, batch=big_b, sms=sms) == "cluster"
        times = {beta: fixed(main, beta, "warp_launches") for beta in (1.0, 0.0)}
        generic = fixed(main, 1.5, "launches")
        replaces = "muscle_synergies_tpu/models/kernels/beta_pallas.py:231"
        also = "muscle_synergies_tpu/models/kernels/beta_pallas.py:292"
        # the main path runs KL: the warp entry's row carries the KL numbers
        ms, plain_ms, a_err, r_err = times[1.0]
        self.record("beta_nmf_warp", replaces, (a_err, r_err, 1e-3), ms, plain_ms,
                    b * iters * nmf_flops("beta_nmf_kl", n, l, k),
                    4 * b * (n * l + 2 * (n * k + k * l)), source="beta_nmf",
                    also_replaces=also, shape=f"{b}x{n}x{l}, k={k}",
                    ms_by_beta={f"{bt:g}": v[0] for bt, v in times.items()})
        ms, plain_ms, a_err, r_err = generic
        self.record("beta_nmf", replaces, (a_err, r_err, 1e-3), ms, plain_ms,
                    b * iters * nmf_flops("beta_nmf", n, l, k),
                    4 * b * (n * l + 2 * (n * k + k * l)),
                    also_replaces=also, shape=f"{b}x{n}x{l}, k={k}, beta 1.5")
        # the grid entry on block-range frames: its record is the
        # capture-length one (phase 23)
        for label, data, beta in (("KL", big, 1.0), ("beta 1.5", [a[:big_b] for a in main],
                                                     1.5)):
            ms, plain_ms, _, r_err = fixed(data, beta, "cluster_launches")
            log(f"beta_nmf_cluster: plan {beta_cuda.last_plan}, "
                f"{mu_cuda.blocks_per_sm['beta_nmf']} blocks a SM  [{self.smi}]")
            shape = "x".join(map(str, data[0].shape))
            self.small_grid[f"beta_nmf_cluster {label}"] = dict(
                ms=ms, plain_ms=plain_ms, err=r_err, shape=f"{shape}, k={k}")

        for beta, (fx, fw, fh), counter in (
                (1.0, [a[:fb] for a in main], "warp_launches"),
                (0.0, [a[:fb] for a in main], "warp_launches"),
                (1.5, main, "launches"), (1.0, big, "cluster_launches")):
            fx64, fw64, fh64 = fx.double(), fw.double(), fh.double()
            before = getattr(beta_cuda, counter)
            t0 = time.perf_counter()
            sk = beta_cuda.fit_beta_cuda(fx, fw, fh, beta=beta, max_iter=200, tol=1e-4)
            torch.cuda.synchronize()
            assert getattr(beta_cuda, counter) == before + 1, "beta_nmf took another entry"
            fit_ms = (time.perf_counter() - t0) * 1e3
            sp = beta_cuda.fit_beta_plain(fx64, fw64, fh64, beta=beta, max_iter=200,
                                          tol=1e-4)
            gap = (sk.n_iter - sp.n_iter).cpu().numpy()
            wr, hr = plain_snapshot(lambda x_, w_, h_: mu_update_beta(x_, w_, h_, beta),
                                    fx64, fw64, fh64, sk.n_iter)
            err = max(rel_err(sk.w, wr), rel_err(sk.h, hr))
            shape = f"{fx.shape[0]}x{fx.shape[1]}x{l}"
            log(f"beta_nmf: fit of {shape} at tol 1e-4, beta={beta:g}: stopping gap "
                f"median {np.median(gap):g} (min {gap.min()}, max {gap.max()}); "
                f"n_iter median {float(sk.n_iter.float().median()):g}; factor err at "
                f"the kernel's stop {err:.3e} (bar 2e-3); kernel wall {fit_ms:.2f} ms")
            self.stage(f"K4 fits beta={beta:g} {shape}", time.perf_counter() - t0)
            assert abs(np.median(gap)) <= 10, "beta_nmf fit stops far from float64"
            assert err <= 2e-3, "beta_nmf fit disagrees"

    # ---- 8. K5 ----
    def cnmf_phases(self, b=1024, t=200, l=8, k=4, d=10, iters=20, fb=128):
        from muscle_synergies_tpu_torch.models.cnmf import cnmf_update, init_cnmf
        from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda

        torch, dev, rng = self.torch, self.dev, self.rng
        x_host = rng.random((b, t, l))
        c_host, s_host = init_cnmf(x_host, k, d, seed=5)
        xs, c0, s0 = (torch.from_numpy(a.astype(np.float32)).to(dev)
                      for a in (x_host, c_host, s_host))
        x64, c64, s64 = xs.double(), c0.double(), s0.double()
        t0 = time.perf_counter()
        ck, sk = cnmf_cuda.cnmf_iterations_cuda(xs, c0, s0, iters)
        cp, sp = cnmf_cuda.cnmf_iterations_plain(x64, c64, s64, iters)
        err = max(rel_err(ck, cp), rel_err(sk, sp))
        ms = cuda_ms(lambda: cnmf_cuda.cnmf_iterations_cuda(xs, c0, s0, iters))
        plain_ms = cuda_ms(lambda: cnmf_cuda.cnmf_iterations_plain(xs, c0, s0, iters),
                           reps=3)
        log(f"cnmf: {iters} iterations at {b}x{t}x{l} K={k} D={d}: rel err {err:.3e} "
            f"(bar 1e-3); kernel {ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
        self.stage("K5 fixed", time.perf_counter() - t0)
        assert err <= 1e-3, "cnmf fixed iterations disagree"
        self.record("cnmf", "muscle_synergies_tpu/models/kernels/cnmf_pallas.py:147",
                    (abs_err([(ck, cp), (sk, sp)]), err, 1e-3), ms, plain_ms,
                    b * iters * nmf_flops("cnmf", t, l, k, d),
                    4 * b * (t * l + 2 * (t * k + k * d * l)))

        fx, fc, fs = xs[:fb], c0[:fb], s0[:fb]
        fx64, fc64, fs64 = x64[:fb], c64[:fb], s64[:fb]
        t0 = time.perf_counter()
        st = cnmf_cuda.fit_cnmf_cuda(fx, fc, fs, max_iter=1000, tol=1e-4)
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3
        sp = cnmf_cuda.fit_cnmf_plain(fx64, fc64, fs64, max_iter=1000, tol=1e-4)
        gap = (st.n_iter - sp.n_iter).cpu().numpy()
        cr, sr = plain_snapshot(cnmf_update, fx64, fc64, fs64, st.n_iter)
        err = max(rel_err(st.c, cr), rel_err(st.s, sr))
        log(f"cnmf: fit of {fb} at tol 1e-4: stopping gap median {np.median(gap):g} "
            f"(min {gap.min()}, max {gap.max()}); n_iter median "
            f"{float(st.n_iter.float().median()):g}; factor err at the kernel's stop "
            f"{err:.3e} (bar 2e-3); kernel wall {fit_ms:.2f} ms")
        self.stage("K5 fits", time.perf_counter() - t0)
        assert abs(np.median(gap)) <= 10, "cnmf fit stops far from float64"
        assert err <= 2e-3, "cnmf fit disagrees"

    # ---- 5. the Frobenius main path ----
    def frobenius_main(self, emg):
        from muscle_synergies_tpu_torch import PipelineConfig, analyze_dataset

        torch = self.torch
        config = PipelineConfig()
        torch.cuda.reset_peak_memory_stats()
        results = {}
        for solver in ("cd", "mu"):
            results[solver], counts = self.main_path(
                f"analyze_dataset solver={solver}",
                lambda: analyze_dataset(emg, FS, ranks=(1, 2, 3, 4), config=config,
                                        solver=solver, device="cuda",
                                        dtype=torch.float32))
            self.phase5[solver] = (results[solver], self.last_seconds)  # for 21
            # the 200 x 8 fits take the warp entries, never a block entry
            kname = "cd_nmf_warp" if solver == "cd" else "mu_nmf_warp"
            assert counts["sosfiltfilt"] > 0 and counts[kname] > 0, \
                f"a kernel of the {solver} path never ran"
            assert counts["cd_nmf"] == counts["mu_nmf"] == 0, counts
        log(f"main: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for solver, res in results.items():
            self.check_rank_sweep(solver, res)
        kw = dict(ranks=(1, 2, 3, 4), config=config, device="cuda", dtype=torch.float32)
        self.subset_matches("mu", results["mu"].vaf_overall[:, :SUBSET], lambda: analyze_dataset(
            emg[:SUBSET], FS, solver="mu", impl="torch", **kw).vaf_overall)
        # CD's rank-1 fits run all 100,000 iterations, which the plain CD
        # loop takes minutes over: both sides at 2,000
        capped = dict(kw, solver="cd", max_iter=2000)
        self.subset_matches(
            "cd (max_iter 2,000 on both sides)",
            analyze_dataset(emg[:SUBSET], FS, **capped).vaf_overall,
            lambda: analyze_dataset(emg[:SUBSET], FS, impl="torch", **capped).vaf_overall)
        self.cd_warp_own_rank(emg[:SUBSET])

        # 16 channels (two trials side by side), ranks 1-12: 768 fits of 200
        # x 16 at rank 12, past the warp entry, enough to fill the card
        # with waves of fits: K1's block entry
        emg16 = np.concatenate([emg[:64], emg[64:128]], axis=2)
        kw = dict(ranks=tuple(range(1, 13)), solver="mu", max_iter=2000)
        res, counts = self.main_path("analyze_dataset 16 channels, ranks 1-12, solver=mu",
                                     lambda: analyze_dataset(emg16, FS, **kw))
        assert counts["sosfiltfilt"] > 0 and counts["mu_nmf"] == 1, counts
        vaf = res.vaf_overall
        assert vaf.shape == (12, 64) and np.isfinite(vaf).all() and (vaf <= 1).all()
        means = vaf.mean(axis=1)
        log(f"main mu 16 channels: mean VAF by rank {np.round(means, 6).tolist()}")
        assert (np.diff(means) > 0).all(), "mean VAF does not rise with rank"
        self.subset_matches("mu 16 channels", vaf[:, :4], lambda: analyze_dataset(
            emg16[:4], FS, impl="torch", **kw).vaf_overall)
        self.cd_block_main(emg16)
        del emg16

    def cd_warp_own_rank(self, emg, iters: int = 50):
        """K2's warp entry over each fit's own rank, on the CD path's
        inputs (``emg``'s trials preprocessed, the NNDSVDA init of ranks
        1-4 zero-padded to 4, one launch): the rank-1 fits of the sweep
        hold the same bits as the same fits launched alone at k = 1
        (``iters`` fixed iterations, and fits at max_iter 2,000), their
        padding 0; then the longest rank-1 fit alone at the path's stop
        (tol 1e-6, max_iter 100,000), the latency that sets the CD path's
        tail, beside the parent design's (every loop over KMAX = 4: 5.14 us
        an iteration on this card, PERF.md, PR 8; the A/B script
        ``scripts/torch_ab_parent_kernels.py`` times both in one call)."""
        from muscle_synergies_tpu_torch import PipelineConfig, preprocess_trials
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models.kernels import cd_cuda

        torch = self.torch
        config = PipelineConfig()
        xs = preprocess_trials(emg, FS, config)
        b = xs.shape[0]
        ws, hs = [], []
        for kk in (1, 2, 3, 4):
            w, h = mb.init_batch(xs, kk)
            ws.append(torch.nn.functional.pad(w, (0, 4 - kk)))
            hs.append(torch.nn.functional.pad(h, (0, 0, 0, 4 - kk)))
        gx, gw, gh = xs.repeat(4, 1, 1), torch.cat(ws), torch.cat(hs)
        alone = (gx[:b], gw[:b, :, :1].contiguous(), gh[:b, :1].contiguous())
        before = cd_cuda.warp_launches
        swept = cd_cuda.cd_iterations_cuda(gx, gw, gh, iters)
        own = cd_cuda.cd_iterations_cuda(*alone, iters)
        same = (torch.equal(swept[0][:b, :, :1], own[0]) and torch.equal(swept[1][:b, :1], own[1])
                and not swept[0][:b, :, 1:].any() and not swept[1][:b, 1:].any())
        sk = cd_cuda.fit_cd_cuda(gx, gw, gh, max_iter=2000, tol=config.tol)
        so = cd_cuda.fit_cd_cuda(*alone, max_iter=2000, tol=config.tol)
        same = same and all(torch.equal(a[:b], c) for a, c in (
            (sk.w[..., :1], so.w), (sk.ht[..., :1], so.ht), (sk.n_iter, so.n_iter),
            (sk.violation_init, so.violation_init)))
        assert cd_cuda.warp_launches == before + 4, "a K2 check took another entry"
        log(f"cd_nmf_warp: the rank-1 fits of a KMAX-4 sweep launch ({b} trials x ranks 1-4, "
            f"the CD path's inputs) against the same fits launched at k = 1: bit for bit "
            f"{same} ({iters} fixed iterations, and fits of {int(so.n_iter.min())}-"
            f"{int(so.n_iter.max())} iterations)")
        assert same, "a padded fit differs from the same fit at its own rank"
        idx = sk.n_iter[:b].argmax().view(1)
        fit = lambda: cd_cuda.fit_cd_cuda(gx[idx], gw[idx], gh[idx],  # noqa: E731
                                          max_iter=config.max_iter, tol=config.tol)
        fit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lone = fit()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_iter = int(lone.n_iter[0])
        us = ms / n_iter * 1e3
        log(f"stage cd_nmf_warp lone rank-1 fit (200 x 8 padded to 4, the CD path's longest "
            f"kind): {n_iter} iterations in {ms:.2f} ms, {us:.3f} us an iteration; parent "
            f"design 5.14 us (PERF.md, PR 8)  [{self.smi}]")
        self.kernels["cd_nmf_warp"].update(lone_rank1_us_per_iteration=us,
                                           lone_rank1_iterations=n_iter,
                                           padded_equals_own_rank=same)

    def cd_block_main(self, emg16, top: int = 10, iters: int = 50):
        """CD on the 64 trials of 16 channels, ranks 1-``top``: 640 fits of
        200 x 16 at rank 10, a batch of 5 waves of the card's SMs at a rank
        where K2 keeps its block entry (``cd_cuda.route``); the sweep's
        checks, then the launch held to float64 on the sweep's own inputs
        (fixed iterations, and a fit's stop and factors) and timed."""
        from muscle_synergies_tpu_torch import PipelineConfig, analyze_dataset, preprocess_trials
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models.kernels import cd_cuda

        torch = self.torch
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        b, n, l = emg16.shape[0] * top, 200, emg16.shape[2]
        assert cd_cuda.route(n, l, top, batch=b, sms=sms) == "block"
        assert cd_cuda.route(n, l, top + 2, batch=b, sms=sms) == "cluster"
        kw = dict(ranks=tuple(range(1, top + 1)), solver="cd", max_iter=2000)
        res, counts = self.main_path(f"analyze_dataset 16 channels, ranks 1-{top}, solver=cd",
                                     lambda: analyze_dataset(emg16, FS, **kw))
        assert counts["sosfiltfilt"] > 0 and counts["cd_nmf"] == 1, counts
        vaf = res.vaf_overall
        assert vaf.shape == (top, emg16.shape[0]) and np.isfinite(vaf).all()
        assert (vaf <= 1).all()
        means = vaf.mean(axis=1)
        log(f"main cd 16 channels: mean VAF by rank {np.round(means, 6).tolist()}")
        assert (np.diff(means) > 0).all(), "mean VAF does not rise with rank"
        self.subset_matches("cd 16 channels", vaf[:, :4], lambda: analyze_dataset(
            emg16[:4], FS, impl="torch", **kw).vaf_overall)

        # the launch's inputs: the preprocessed trials and the NNDSVDA init
        # of every (rank, trial) pair, zero-padded to the top rank
        xs = preprocess_trials(emg16, FS, PipelineConfig())
        ws, hs = [], []
        for kk in kw["ranks"]:
            w, h = mb.init_batch(xs, kk)
            ws.append(torch.nn.functional.pad(w, (0, top - kk)))
            hs.append(torch.nn.functional.pad(h, (0, 0, 0, top - kk)))
        gx, gw, gh = xs.repeat(top, 1, 1), torch.cat(ws), torch.cat(hs)
        args64 = (gx.double(), gw.double(), gh.double())
        before = cd_cuda.launches
        wk, hk = cd_cuda.cd_iterations_cuda(gx, gw, gh, iters)
        assert cd_cuda.launches == before + 1, "cd_nmf took another entry"
        wp, hp = cd_cuda.cd_iterations_plain(*args64, iters)
        err = max(rel_err(wk, wp), rel_err(hk, hp))
        ms = cuda_ms(lambda: cd_cuda.cd_iterations_cuda(gx, gw, gh, iters))
        plain_ms = cuda_ms(lambda: cd_cuda.cd_iterations_plain(gx, gw, gh, iters), reps=3)
        log(f"cd_nmf: {iters} iterations at {b}x{n}x{l} k={top} (the sweep's inputs): rel "
            f"err {err:.3e} (bar 1e-3); kernel {ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
        assert err <= 1e-3, "cd_nmf fixed iterations disagree"
        before = cd_cuda.launches
        sk = cd_cuda.fit_cd_cuda(gx, gw, gh, max_iter=200, tol=1e-4)
        assert cd_cuda.launches == before + 1, "cd_nmf fit took another entry"
        sp = cd_cuda.fit_cd_plain(*args64, max_iter=200, tol=1e-4)
        gap = (sk.n_iter - sp.n_iter).cpu().numpy()
        wr, hr = plain_snapshot(self._cd_step, *args64, sk.n_iter)
        fit_err = max(rel_err(sk.w, wr), rel_err(sk.ht.transpose(-1, -2), hr))
        log(f"cd_nmf: fit of {b}x{n}x{l} k={top} at tol 1e-4: stopping gap median "
            f"{np.median(gap):g} (min {gap.min()}, max {gap.max()}); factor err at the "
            f"kernel's stop {fit_err:.3e} (bar 1e-3)")
        assert np.median(gap) == 0, "cd_nmf fit stops elsewhere than float64"
        assert fit_err <= 1e-3, "cd_nmf fit disagrees"
        self.record("cd_nmf", "muscle_synergies_tpu/models/kernels/cd_pallas.py:168",
                    (abs_err([(wk, wp), (hk, hp)]), err, 1e-3), ms, plain_ms,
                    b * iters * nmf_flops("cd_nmf", n, l, top),
                    4 * b * (n * l + 2 * (n * top + top * l)), shape=f"{b}x{n}x{l}, k={top}",
                    also_replaces="muscle_synergies_tpu/models/kernels/cd_pallas.py:248")

    def check_rank_sweep(self, label, res):
        vaf = res.vaf_overall
        b = vaf.shape[1]
        assert vaf.shape == (4, b) and res.w.shape == (4, b, 200, 4)
        assert res.h.shape == (4, b, 4, N_CHANNELS)
        assert np.isfinite(vaf).all() and (vaf <= 1).all(), "bad VAF"
        assert np.isfinite(res.w).all() and np.isfinite(res.h).all()
        means = vaf.mean(axis=1)
        log(f"main {label}: mean VAF by rank {np.round(means, 6).tolist()}, "
            f"n_iter median by rank {np.median(res.n_iter, axis=1).tolist()}, "
            f"converged {res.converged.mean(axis=1).tolist()}")
        assert (np.diff(means) > 0).all(), "mean VAF does not rise with rank"

    def subset_matches(self, label, vaf_kernel, plain_vaf):
        t0 = time.perf_counter()
        diff = float(np.abs(plain_vaf() - vaf_kernel).max())
        log(f"main {label}: {SUBSET}-trial subset impl='torch' on the card "
            f"({time.perf_counter() - t0:.1f} s): max VAF diff {diff:.3e} (bar 1e-3)")
        assert diff <= 1e-3, f"{label}: kernel path and plain path disagree"

    # ---- 9. the KL main path ----
    def kl_main(self, emg):
        from muscle_synergies_tpu_torch import analyze_dataset

        kw = dict(ranks=(1, 2, 3, 4), solver="mu", beta_loss="kullback-leibler")
        res, counts = self.main_path("analyze_dataset beta_loss=kullback-leibler",
                                     lambda: analyze_dataset(emg, FS, **kw))
        assert counts["sosfiltfilt"] > 0 and counts["beta_nmf_warp"] > 0, \
            "a kernel of the KL path never ran"
        assert counts["beta_nmf"] == 0, counts
        self.check_rank_sweep("kl", res)
        self.subset_matches("kl", res.vaf_overall[:, :SUBSET], lambda: analyze_dataset(
            emg[:SUBSET], FS, impl="torch", **kw).vaf_overall)
        # beta = 1.5 (a run-time beta, no warp entry): the 1,024 fits fill
        # the card with waves of fits, K4's block entry
        kw = dict(ranks=(1, 2, 3, 4), solver="mu", beta_loss=1.5, max_iter=2000)
        res, counts = self.main_path("analyze_dataset beta_loss=1.5",
                                     lambda: analyze_dataset(emg, FS, **kw))
        assert counts["sosfiltfilt"] > 0 and counts["beta_nmf"] == 1, counts
        self.check_rank_sweep("beta 1.5", res)
        self.subset_matches("beta 1.5", res.vaf_overall[:, :SUBSET], lambda: analyze_dataset(
            emg[:SUBSET], FS, impl="torch", **kw).vaf_overall)

    # ---- 10. the time-varying main path ----
    def time_varying_main(self, emg):
        from muscle_synergies_tpu_torch import analyze_dataset_time_varying

        kw = dict(n_synergies=4, n_lags=10, n_inits=4)
        res, counts = self.main_path("analyze_dataset_time_varying",
                                     lambda: analyze_dataset_time_varying(emg, FS, **kw))
        assert counts["sosfiltfilt"] > 0 and counts["cnmf"] > 0, \
            "a kernel of the time-varying path never ran"
        b = emg.shape[0]
        assert res.c.shape == (b, 200, 4) and res.s.shape == (b, 4, 10, N_CHANNELS)
        assert res.restart_errors.shape == (b, 4)
        assert np.isfinite(res.vaf_overall).all() and (res.vaf_overall <= 1).all()
        assert np.isfinite(res.c).all() and np.isfinite(res.s).all()
        log(f"main time-varying: mean VAF {float(res.vaf_overall.mean()):.6f}, "
            f"n_iter median {float(np.median(res.n_iter)):g} (max {res.n_iter.max()}), "
            f"converged {float(res.converged.mean()):g}")
        # the plain loop runs each of its up to ~30,000 iterations as a
        # Python step: both sides at 2,000
        capped = dict(kw, max_iter=2000)
        self.subset_matches(
            "time-varying (max_iter 2,000 on both sides)",
            analyze_dataset_time_varying(emg[:SUBSET], FS, **capped).vaf_overall,
            lambda: analyze_dataset_time_varying(emg[:SUBSET], FS, impl="torch",
                                                 **capped).vaf_overall)

    # ---- 11. K6 ----
    def causal_filter_phase(self, n_trials: int = 64, plain_n: int = 20_000,
                            chunk: int = 8192):
        from scipy import signal as sps

        from muscle_synergies_tpu_torch.ops import filter_cuda, filters

        torch, dev = self.torch, self.dev
        sos = filters.sos_design(4, 4.0, FS)
        raw = synthetic_emg(n_trials, seed=3)
        # the causal envelope's input: zero-centered, rectified EMG
        x_host = np.abs(raw - raw.mean(axis=1, keepdims=True))
        del raw
        # zi = sosfilt_zi * x[0] for every column: (B, S, 2, C)
        zi_host = (filters.sosfilt_zi(sos)[None, :, :, None]
                   * x_host[:, 0].astype(np.float64)[:, None, None, :])
        x = torch.from_numpy(x_host).to(dev)
        zi = torch.from_numpy(zi_host).to(dev)
        y, _ = filter_cuda.sosfilt_cuda(sos, x, zi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _ = sps.sosfilt(sos, x_host.astype(np.float64), axis=1,
                             zi=zi_host.transpose(1, 0, 2, 3))
        log(f"causal filter: scipy float64 reference on the host "
            f"{time.perf_counter() - t0:.2f} s")
        scale = float(np.abs(ref).max())
        err_scipy = float(np.abs(y.cpu().numpy() - ref).max()) / scale
        del ref, y
        # the plain version takes one Python step per sample: 4 x 20,000
        xs4, zi4 = x[:4, :plain_n], zi[:4]
        y4, _ = filter_cuda.sosfilt_cuda(sos, xs4, zi4)
        t0 = time.perf_counter()
        y4_plain, _ = filter_cuda.sosfilt_plain(sos, xs4.double(), zi4)
        torch.cuda.synchronize()
        log(f"causal filter: plain float64 on the card, 4 x {plain_n} samples, "
            f"{time.perf_counter() - t0:.2f} s")
        err_plain = float((y4.double() - y4_plain).abs().max())
        # streaming: the 4 whole trials in chunks, each chunk's zf the
        # next one's zi, against one whole-signal launch
        whole, _ = filter_cuda.sosfilt_cuda(sos, x[:4], zi[:4])
        state, parts = zi[:4], []
        for start in range(0, x.shape[1], chunk):
            part, state = filter_cuda.sosfilt_cuda(sos, x[:4, start:start + chunk],
                                                   state)
            parts.append(part)
        scale4 = float(whole.abs().max())
        err_stream = float((torch.cat(parts, dim=1) - whole).abs().max()) / scale4
        log(f"causal filter: kernel vs scipy {err_scipy:.3e} x max|y|, vs plain f64 "
            f"{err_plain / scale:.3e} x max|y|, {len(parts)} chunks of {chunk} with "
            f"carried zf vs one launch {err_stream:.3e} x max|y| (bar 5e-4)")
        assert err_scipy <= 5e-4 and err_plain <= 5e-4 * scale, "causal filter disagrees"
        assert err_stream <= 5e-4, "chunked causal filtering disagrees"
        ms = cuda_ms(lambda: filter_cuda.sosfilt_cuda(sos, x, zi))
        plain_ms = cuda_ms(lambda: filter_cuda.sosfilt_plain(sos, xs4, zi4),
                           reps=1, warmup=0)
        log(f"causal filter: {n_trials}x{x.shape[1]}x{N_CHANNELS} f32 kernel "
            f"{ms:.3f} ms; plain f32 at 4x{plain_n}x{N_CHANNELS} {plain_ms:.1f} ms")

        # per sample, column and section 5 float64 multiply-adds; x read
        # and y written once, zi read and zf written in float64
        def work(xb):
            cols = xb.shape[0] * N_CHANNELS
            state_bytes = 2 * len(sos) * 2 * cols * 8
            return len(sos) * 10 * cols * xb.shape[1], 2 * xb.numel() * 4 + state_bytes

        x4, zi_4 = x.repeat(4, 1, 1), zi.repeat(4, 1, 1, 1)  # 256 trials
        ms4 = cuda_ms(lambda: filter_cuda.sosfilt_cuda(sos, x4, zi_4))
        bound4, _ = bound(*work(x4), kind="f64")
        log(f"causal filter: {x4.shape[0]}x{x.shape[1]}x{N_CHANNELS} f32 kernel "
            f"{ms4:.3f} ms, bound {bound4:.4f} ms  [{self.smi}]")
        del x4
        self.record("sosfilt", "muscle_synergies_tpu/ops/filter_pallas.py:488",
                    (err_plain, err_plain / scale, 5e-4), ms, plain_ms, *work(x),
                    kind="f64", source="sosfiltfilt",
                    plain_at=f"4x{plain_n}x{N_CHANNELS}",
                    rel_err_vs_scipy=err_scipy, rel_err_chunked=err_stream,
                    ms_256_trials=ms4, bound_ms_256_trials=bound4,
                    chunk=filter_cuda.CHUNK)

    # ---- 12. the causal main path ----
    def causal_main(self, emg):
        from muscle_synergies_tpu_torch import FilterSpec, PipelineConfig, analyze_dataset

        kw = dict(ranks=(1, 2, 3, 4), solver="mu",
                  config=PipelineConfig(envelope=FilterSpec(zero_lag=False)))
        res, counts = self.main_path("analyze_dataset causal envelope",
                                     lambda: analyze_dataset(emg, FS, **kw))
        # equal-length trials: one K6 launch, and no zero-phase filter
        assert counts["sosfilt"] == 1 and counts["mu_nmf_warp"] > 0, counts
        assert counts["mu_nmf"] == 0, counts
        assert counts["sosfiltfilt"] == 0, counts
        self.check_rank_sweep("causal", res)
        self.subset_matches("causal", res.vaf_overall[:, :SUBSET], lambda: analyze_dataset(
            emg[:SUBSET], FS, impl="torch", **kw).vaf_overall)

    # ---- 13. the RMS main path ----
    def rms_main(self, emg):
        from muscle_synergies_tpu_torch import (
            FilterSpec,
            PipelineConfig,
            analyze_dataset,
            preprocess_trials,
        )
        from muscle_synergies_tpu_torch.models.batch import pad_and_stack
        from muscle_synergies_tpu_torch.ops import batched
        from muscle_synergies_tpu_torch.ops.emg import rms_window

        torch = self.torch
        lengths = np.random.default_rng(4).integers(RAGGED_MIN, N_SAMPLES + 1,
                                                   size=emg.shape[0])
        trials = [emg[b, :n] for b, n in enumerate(lengths)]
        config = PipelineConfig(use_rms=True)
        kw = dict(ranks=(1, 2, 3, 4), solver="cd", config=config)
        res, counts = self.main_path("analyze_dataset rms envelope, ragged",
                                     lambda: analyze_dataset(trials, FS, **kw))
        assert counts["cd_nmf_warp"] > 0 and counts["cd_nmf"] == 0, counts
        assert counts["sosfiltfilt"] == counts["sosfilt"] == 0, counts
        self.check_rank_sweep("rms", res)

        window = rms_window(config.rms_window_s, FS)
        data, mask = (torch.from_numpy(a).to(self.dev) for a in pad_and_stack(trials[:4]))
        centred = batched.zero_center_batch(data, mask)
        env = batched.moving_rms_batch(centred, window, mask).cpu().numpy()
        centred = centred.cpu().numpy().astype(np.float64)
        box = np.ones(window) / window
        worst = 0.0
        for b, n in enumerate(lengths[:4]):
            ref = np.stack([np.sqrt(np.convolve(centred[b, :n, c] ** 2, box, "same"))
                            for c in range(N_CHANNELS)], axis=1)
            worst = max(worst, float(np.abs(env[b, :n] - ref).max() / np.abs(ref).max()))
        log(f"rms: 4 ragged trials, window {window}: moving RMS on the card vs "
            f"np.convolve in float64 {worst:.3e} relative (bar 1e-5)")
        assert worst <= 1e-5, "moving RMS disagrees"
        capped = dict(kw, max_iter=2000)
        self.subset_matches(
            "rms (max_iter 2,000 on both sides)",
            analyze_dataset(trials[:SUBSET], FS, **capped).vaf_overall,
            lambda: analyze_dataset(trials[:SUBSET], FS, impl="torch",
                                    **capped).vaf_overall)

        # the causal envelope is exact under the padding too: the ragged
        # trials filter as one padded batch, one K6 launch
        causal = PipelineConfig(envelope=FilterSpec(zero_lag=False))
        pre, counts = self.main_path("preprocess_trials causal envelope, ragged",
                                     lambda: preprocess_trials(trials, FS, causal))
        assert counts["sosfilt"] == 1 and sum(counts.values()) == 1, counts
        pre = pre.cpu().numpy()
        alone = np.stack([preprocess_trials([t], FS, causal)[0].cpu().numpy()
                          for t in trials[:4]])
        gap = float(np.abs(pre[:4] - alone).max() / np.abs(alone).max())
        log(f"causal, ragged: padded batch vs each trial alone {gap:.3e} x max "
            f"(bar 1e-5)")
        assert pre.shape == (len(trials), 200, N_CHANNELS) and np.isfinite(pre).all()
        assert gap <= 1e-5, "the padded causal batch disagrees"

        # the zero-phase envelope takes each trial's own length: the ragged
        # trials filter as one padded batch, one K3 launch
        zero_phase = PipelineConfig()
        pre, counts = self.main_path("preprocess_trials zero-phase envelope, ragged",
                                     lambda: preprocess_trials(trials, FS, zero_phase))
        assert counts["sosfiltfilt"] == 1 and sum(counts.values()) == 1, counts
        pre = pre.cpu().numpy()
        alone = np.stack([preprocess_trials([t], FS, zero_phase)[0].cpu().numpy()
                          for t in trials[:4]])
        gap = float(np.abs(pre[:4] - alone).max() / np.abs(alone).max())
        log(f"zero-phase, ragged: padded batch vs each trial alone {gap:.3e} x max "
            f"(bar 1e-5)")
        assert pre.shape == (len(trials), 200, N_CHANNELS) and np.isfinite(pre).all()
        assert gap <= 1e-5, "the padded zero-phase batch disagrees"

    # ---- 14. the per-capture API ----
    def per_capture_api(self, emg):
        from muscle_synergies_tpu_torch import NMFModel, PipelineConfig, preprocess_trials
        from muscle_synergies_tpu_torch.models.batch import rank_sweep_batch

        torch = self.torch
        frame = preprocess_trials(emg[:1], FS, PipelineConfig())[0]  # (200, 8)

        def fit_and_transform():
            model = NMFModel(n_components=4)
            return model, model.fit_transform(frame), model.transform(frame)

        (model, w, w_t), counts = self.main_path(
            "NMFModel 200x8 fit_transform + transform", fit_and_transform)
        # the shape rule sends this frame through K2's warp entry;
        # transform is plain
        assert counts["cd_nmf_warp"] == 1 and sum(counts.values()) == 1, counts
        assert w.shape == w_t.shape == (200, 4) and np.isfinite(w).all()
        assert np.isfinite(w_t).all() and (w_t >= 0).all()
        ref = NMFModel(n_components=4, device="cpu", dtype=torch.float64)
        ref.fit_transform(frame.cpu().double())
        gap = abs(model.reconstruction_err_ - ref.reconstruction_err_) / ref.reconstruction_err_
        log(f"NMFModel 200x8: n_iter {model.n_iter_} (float64 on the host "
            f"{ref.n_iter_}), reconstruction error {model.reconstruction_err_:.6f} "
            f"vs {ref.reconstruction_err_:.6f}, relative gap {gap:.2e} (bar 1e-3)")
        assert gap <= 1e-3, "NMFModel on the card disagrees with float64"

        (states, vafs), counts = self.main_path(
            "rank_sweep_batch ranks 1-8, 200x8",
            lambda: rank_sweep_batch(frame, range(1, 9), solver="cd"))
        assert counts["cd_nmf_warp"] == 1 and sum(counts.values()) == 1, counts
        vafs = vafs.cpu().numpy()
        _, plain = rank_sweep_batch(frame, range(1, 9), solver="cd", impl="torch")
        diff = float(np.abs(plain.cpu().numpy() - vafs).max())
        log(f"rank_sweep_batch: VAF by rank {np.round(vafs, 6).tolist()}; plain "
            f"on the card max VAF diff {diff:.2e} (bar 1e-3)")
        assert np.isfinite(vafs).all() and (vafs <= 1).all() and diff <= 1e-3
        assert (np.diff(vafs) > -1e-6).all(), "VAF falls with rank"

        # a frame over the warp entries' rows (the envelope resampled to
        # 2,000 samples, not 200), one fit: the entry K2's route names for a
        # batch of one (its grid entry), and the grid entries of K1 and K4
        from muscle_synergies_tpu_torch.models.kernels import cd_cuda

        frame2k = preprocess_trials(emg[:1], FS, PipelineConfig(reduce_to=2000))[0]
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        cd_entry = cd_cuda.route(*frame2k.shape, 4, batch=1, sms=sms)
        assert cd_entry == "cluster", cd_entry
        for kname, kw in (("cd_nmf_cluster", {}), ("mu_nmf_cluster", dict(solver="mu")),
                          ("beta_nmf_cluster",
                           dict(solver="mu", beta_loss="kullback-leibler"))):

            def fit_2000():
                model = NMFModel(n_components=4, **kw)
                return model, model.fit_transform(frame2k)

            (model, w), counts = self.main_path(f"NMFModel 2,000x8 fit_transform {kw}",
                                                fit_2000)
            assert counts[kname] == 1 and sum(counts.values()) == 1, counts
            assert w.shape == (2000, 4) and np.isfinite(w).all()
            ref = NMFModel(n_components=4, device="cpu", dtype=torch.float64, **kw)
            ref.fit_transform(frame2k.cpu().double())
            gap = (abs(model.reconstruction_err_ - ref.reconstruction_err_)
                   / ref.reconstruction_err_)
            log(f"NMFModel 2,000x8 {kw} ({kname}): n_iter {model.n_iter_} (float64 "
                f"on the host {ref.n_iter_}), relative gap in reconstruction error "
                f"{gap:.2e} (bar 1e-3)")
            assert gap <= 1e-3, f"NMFModel 2,000x8 {kw} on the card disagrees with float64"

        big = torch.from_numpy(np.abs(emg[0, :20_000])).to(self.dev)

        def fit_big(**kw):
            model = NMFModel(n_components=4, **kw)
            return model, model.fit_transform(big)

        # over one block's shared memory: one launch of K2's cluster entry;
        # impl="torch" is the plain fit on the card
        (m_big, w_big), counts = self.main_path(
            "NMFModel 20,000x8 fit_transform (cluster entry)", fit_big)
        assert counts["cd_nmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        assert w_big.shape == (big.shape[0], 4) and np.isfinite(w_big).all()
        (m_plain, w_plain), counts = self.main_path(
            "NMFModel 20,000x8 fit_transform (impl='torch')", lambda: fit_big(impl="torch"))
        assert sum(counts.values()) == 0, counts
        assert w_plain.shape == (big.shape[0], 4) and np.isfinite(w_plain).all()
        gap = (abs(m_big.reconstruction_err_ - m_plain.reconstruction_err_)
               / m_plain.reconstruction_err_)
        log(f"NMFModel 20,000x8: n_iter {m_big.n_iter_} on the cluster entry, "
            f"{m_plain.n_iter_} plain; relative gap in reconstruction error {gap:.2e} "
            "(bar 1e-3)")
        assert gap <= 1e-3, "NMFModel 20,000x8: the cluster entry and the plain fit disagree"

    # ---- 15. the capture main path ----
    def capture_main(self, n_captures: int = CAPTURES, state_len: int = STATE_LEN,
                     n_markers: int = N_MARKERS, chunk: int = 8192, then=None):
        """Phase 15; then ``then(paths, datas, directory)`` on its written
        and parsed captures, before their directory is removed."""
        import concurrent.futures
        import multiprocessing
        import shutil
        import tempfile

        from scipy import signal as sps

        from muscle_synergies_tpu_torch import analyze_dataset, preprocess_trials
        from muscle_synergies_tpu_torch.io import (
            DeviceStream,
            load_vicon_file,
            load_vicon_files,
        )
        from muscle_synergies_tpu_torch.ops import filter_cuda, filters
        from muscle_synergies_tpu_torch.segment import Segmenter, transition_indices
        from muscle_synergies_tpu_torch.testing import GAIT_MUSCLES, _gait_emg_array

        torch, dev = self.torch, self.dev
        phase_t0 = time.perf_counter()
        lens = [state_len + 20 * i for i in range(n_captures)]
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_captures_", dir=root)
        try:
            paths = [os.path.join(tmp, f"capture{i:02d}.csv") for i in range(n_captures)]
            t0 = time.perf_counter()
            workers = min(n_captures, os.cpu_count() or 1, 8)
            with concurrent.futures.ProcessPoolExecutor(
                    workers, mp_context=multiprocessing.get_context("spawn")) as pool:
                spent = list(pool.map(_write_capture, paths, lens,
                                      [n_markers] * n_captures, range(n_captures)))
            nbytes = sum(os.path.getsize(p) for p in paths)
            self.stage(f"capture write ({n_captures} captures, {nbytes / 1e6:.1f} MB, "
                       f"{workers} processes)", time.perf_counter() - t0)
            loads, writes = zip(*spent)
            log(f"capture write: writer module load {max(loads):.3f} s at most in a "
                f"process; writing {sum(writes):.3f} s in all, "
                f"{sum(writes) / n_captures:.3f} s a capture  [{self.smi}]")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", "import muscle_synergies_tpu_torch"],
                           check=True, cwd=os.path.dirname(os.path.abspath(__file__)))
            self.stage("capture write, for comparison: the whole package's import in a "
                       "fresh process", time.perf_counter() - t0)

            t0 = time.perf_counter()
            datas = load_vicon_files(paths)
            secs = time.perf_counter() - t0
            self.stage(f"capture parse (load_vicon_files, native decoder, threads; "
                       f"{nbytes / 1e6 / secs:.1f} MB/s)", secs)
            t0 = time.perf_counter()
            load_vicon_file(paths[0])
            secs = time.perf_counter() - t0
            self.stage(f"capture parse, one capture, native decoder "
                       f"({os.path.getsize(paths[0]) / 1e6 / secs:.1f} MB/s)", secs)
            t0 = time.perf_counter()
            os.environ["MST_DISABLE_NATIVE"] = "1"
            try:
                plain = load_vicon_file(paths[0])
            finally:
                del os.environ["MST_DISABLE_NATIVE"]
            secs = time.perf_counter() - t0
            self.stage(f"capture parse, one capture, plain decoder "
                       f"({os.path.getsize(paths[0]) / 1e6 / secs:.1f} MB/s)", secs)
            first = datas[0]
            devices = [first.emg] + first.forcepl + first.traj
            plain_devices = [plain.emg] + plain.forcepl + plain.traj
            assert len(first.traj) == n_markers and len(first.forcepl) == 2
            for a, b in zip(devices, plain_devices):
                assert a.name == b.name and a.coords == b.coords and a.units == b.units
                assert np.array_equal(np.ascontiguousarray(a.array).view(np.uint64),
                                      np.ascontiguousarray(b.array).view(np.uint64)), \
                    f"native and plain decoders disagree on {a.name}"
            n = 41 * lens[0]
            written = np.round(_gait_emg_array(n_samples=n, sampling_frequency=FS,
                                               seed=0), 6)
            assert np.array_equal(np.ascontiguousarray(first.emg.array).view(np.uint64),
                                  written.view(np.uint64)), \
                "the parsed EMG differs from the writer's array"
            assert first.emg.coords == GAIT_MUSCLES
            log(f"capture: {n_captures} captures of {[d.emg.array.shape[0] for d in datas]}"
                f" samples; capture 0 bit for bit equal to the plain decoder "
                f"({len(devices)} devices) and its EMG to the writer's array")

            t0 = time.perf_counter()
            segmenters = [Segmenter(d) for d in datas]
            self.stage(f"capture segment ({n_captures} Segmenters)",
                       time.perf_counter() - t0)
            for d, length in zip(datas, lens):
                left, right = (p.array[:, p.coords.index("Fz")] for p in d.forcepl[:2])
                got = transition_indices(left, right, num_segments=40)
                assert got == [k * length for k in range(40)], \
                    "transitions off the written state boundaries"

            t0 = time.perf_counter()
            trials = [cycle for d, seg in zip(datas, segmenters)
                      for cycle in _cut_cycles(d, seg)]
            self.stage(f"capture cut ({len(trials)} gait cycles)", time.perf_counter() - t0)
            sizes = [t.array.shape[0] for t in trials]
            assert len(trials) == 8 * n_captures
            assert sorted(set(sizes)) == [4 * length for length in lens], sizes
            log(f"capture: {len(trials)} ragged trials of {min(sizes)}-{max(sizes)} "
                f"x {trials[0].array.shape[1]}")

            kw = dict(ranks=(1, 2, 3, 4))
            res, counts = self.main_path("analyze_dataset on the cut gait cycles",
                                         lambda: analyze_dataset(trials, FS, **kw))
            assert counts["sosfiltfilt"] == 1, counts  # one K3 launch, ragged
            assert counts["cd_nmf_warp"] > 0 and counts["cd_nmf"] == 0, counts
            assert sum(counts.values()) == 1 + counts["cd_nmf_warp"], counts
            self.check_rank_sweep("capture", res)
            assert res.channel_names == list(GAIT_MUSCLES), res.channel_names
            capped = dict(kw, max_iter=2000)
            self.subset_matches(
                "capture (max_iter 2,000 on both sides)",
                analyze_dataset(trials[:SUBSET], FS, **capped).vaf_overall,
                lambda: analyze_dataset(trials[:SUBSET], FS, impl="torch",
                                        **capped).vaf_overall)
            arrays = [t.array for t in trials]
            xs = self.capture_stages(arrays)
            self.ragged_filter_check(arrays)
            # the card's preprocess of the whole ragged batch against the
            # plain chain in float64 on the host, on its shortest and
            # longest trial
            picks = [int(np.argmin(sizes)), int(np.argmax(sizes))]
            t0 = time.perf_counter()
            plain_pre = preprocess_trials([arrays[i] for i in picks], FS, device="cpu",
                                          dtype=torch.float64).numpy()
            gap = float(np.abs(xs[picks].double().cpu().numpy() - plain_pre).max()
                        / np.abs(plain_pre).max())
            log(f"capture preprocess: trials {picks} of the {len(trials)}-trial batch on the "
                f"card vs "
                f"the plain chain in float64 on the host ({time.perf_counter() - t0:.1f} s)"
                f" {gap:.3e} x max (bar 1e-5)")
            assert gap <= 1e-5, "the card's ragged preprocess disagrees with float64"

            # one capture's EMG, streamed in chunks through K6 with carried
            # zf, against one K6 launch on the loaded array
            sos = filters.sos_design(4, 4.0, FS)
            emg = first.emg.array
            zi = torch.as_tensor(filters.sosfilt_zi(sos)[:, :, None] * emg[0],
                                 dtype=torch.float32)
            stream = DeviceStream(paths[0], "emg", chunk_rows=chunk)

            def streamed():
                state, parts = zi.to(dev), []
                for part in stream:
                    y, state = filters.sosfilt(sos, part, zi=state, return_zf=True,
                                               device=dev, dtype=torch.float32)
                    parts.append(y)
                return torch.cat(parts)

            ys, counts = self.main_path(f"DeviceStream, {chunk}-row chunks through K6",
                                        streamed)
            n_chunks = -(-emg.shape[0] // chunk)
            assert counts["sosfilt"] == n_chunks and sum(counts.values()) == n_chunks, \
                counts
            whole, _ = filter_cuda.sosfilt_cuda(
                sos, torch.as_tensor(emg, dtype=torch.float32, device=dev)[None],
                zi.to(dev)[None])
            scale = float(whole.abs().max())
            err = float((ys - whole[0]).abs().max()) / scale
            # and against scipy in float64 on the same float32 samples and zi
            ref, _ = sps.sosfilt(sos, emg.astype(np.float32).astype(np.float64), axis=0,
                                 zi=zi.double().numpy())
            err_ref = float(np.abs(ys.double().cpu().numpy() - ref).max()
                            / np.abs(ref).max())
            log(f"capture stream: {n_chunks} chunks of {chunk} rows with carried zf vs "
                f"one K6 launch {err:.3e} x max|y|, vs scipy sosfilt in float64 "
                f"{err_ref:.3e} x max|y| (bar 5e-4)")
            assert err <= 5e-4, "the streamed capture disagrees with one K6 launch"
            assert err_ref <= 5e-4, "the streamed capture disagrees with scipy"
            self.stage("phase 15 (capture main path, whole)",
                       time.perf_counter() - phase_t0)
            if then is not None:
                then(paths, datas, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def capture_stages(self, arrays):
        """Phase 15's analyze stage split, piece by piece as the stage
        breakdown splits the other paths: host padding, the copy, the
        preprocess (one K3 launch with per-trial lengths inside), init,
        fit, VAF."""
        from muscle_synergies_tpu_torch import PipelineConfig, preprocess_trials
        from muscle_synergies_tpu_torch.models.batch import fit_cd_batch, pad_and_stack

        torch, dev = self.torch, self.dev
        config = PipelineConfig()
        data, _ = self.timed("capture host padding of the ragged trials",
                             lambda: pad_and_stack(arrays))
        self.timed(f"capture host->device {data.nbytes / 2**20:.0f} MiB "
                   "(float64 -> float32)",
                   lambda: torch.as_tensor(data, dtype=torch.float32, device=dev))
        xs = self.timed("capture preprocess_trials whole (padding, copy, K3, resample, "
                        "normalize)", lambda: preprocess_trials(arrays, FS, config))
        self.grid_fits(xs, {"cd_nmf": lambda x, w, h: fit_cd_batch(
            x, w, h, max_iter=config.max_iter, tol=config.tol)}, label="capture ")
        return xs

    def ragged_filter_check(self, arrays):
        """K3 at the capture path's launch: every ragged trial zero-centred
        and rectified over its own length, filtered in one launch with
        per-trial lengths, against ``scipy.signal.sosfiltfilt`` in float64
        on each trial's own samples; the padding must come back zero."""
        from scipy import signal as sps

        from muscle_synergies_tpu_torch.models.batch import pad_and_stack
        from muscle_synergies_tpu_torch.ops import filter_cuda, filters

        torch = self.torch
        sos = filters.sos_design(4, 4.0, FS)
        lengths = [a.shape[0] for a in arrays]
        rect = [np.abs(a - a.mean(axis=0)).astype(np.float32) for a in arrays]
        x = torch.as_tensor(pad_and_stack(rect)[0], device=self.dev)
        y = filter_cuda.sosfiltfilt_cuda(sos, x, filters.default_padlen(sos), "odd",
                                         lengths=lengths).cpu().numpy()
        err = scale = 0.0
        for b, (r, n) in enumerate(zip(rect, lengths)):
            ref = sps.sosfiltfilt(sos, r.astype(np.float64), axis=0)
            err = max(err, float(np.abs(y[b, :n] - ref).max()))
            scale = max(scale, float(np.abs(ref).max()))
            assert not y[b, n:].any(), "K3 wrote past a trial's length"
        log(f"capture K3: {len(arrays)} ragged trials ({min(lengths)}-{max(lengths)} "
            f"samples) in one launch vs scipy sosfiltfilt in float64 {err / scale:.3e} "
            f"x max|y| (bar 5e-4)")
        assert err <= 5e-4 * scale, "K3 disagrees with scipy on the ragged cycles"

    # ---- 16. the space-by-time dataset path ----
    # ---- 20. the pipelined dataset path and the command line ----
    def pipeline_cli_phase(self, paths, datas, work):
        """Phase 20 on phase 15's written and parsed captures."""
        t0 = time.perf_counter()
        one = self.pipelined_path(paths, datas, work)
        self.pipeline_overlap(paths, datas)
        self.cli_checks(paths, datas, work, one)
        self.stage("phase 20 (pipelined dataset path, the command line)",
                   time.perf_counter() - t0)

    @staticmethod
    def memcpy_events(trace_path):
        """``(name, bytes, stream)`` of every copy in a torch profiler
        trace (the chrome trace's ``gpu_memcpy`` events)."""
        with open(trace_path) as fh:
            events = json.load(fh).get("traceEvents", [])
        return [(e["name"], int(e.get("args", {}).get("bytes", 0)),
                 e.get("args", {}).get("stream")) for e in events
                if e.get("cat") == "gpu_memcpy"]

    def pipelined_path(self, paths, datas, work, chunk_files: int = 4):
        """(a) ``analyze_dataset_pipelined`` against the one-shot path on
        the same captures, (b) the copies it made, from the profiler."""
        from torch.profiler import ProfilerActivity, profile

        from muscle_synergies_tpu_torch import analyze_dataset, analyze_dataset_pipelined

        torch = self.torch
        trials = [d.emg for d in datas]
        n_chunks = -(-len(paths) // chunk_files)
        trace = os.path.join(work, "pipelined_trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            piped, counts = self.main_path(
                f"analyze_dataset_pipelined ({len(paths)} captures, {n_chunks} chunks "
                f"of {chunk_files}, prefetch 2)",
                lambda: analyze_dataset_pipelined(paths, chunk_files=chunk_files,
                                                  prefetch=2))
        prof.export_chrome_trace(trace)
        assert counts["sosfiltfilt"] == n_chunks, counts  # one K3 launch a chunk
        assert counts["cd_nmf_warp"] > 0 and counts["cd_nmf"] == 0, counts
        assert sum(counts.values()) == n_chunks + counts["cd_nmf_warp"], counts
        self.check_rank_sweep("pipelined", piped)
        one, counts = self.main_path("analyze_dataset on the same captures, one shot",
                                     lambda: analyze_dataset(trials, FS))
        assert counts["sosfiltfilt"] == 1 and counts["cd_nmf"] == 0, counts
        gaps = {k: float(np.abs(getattr(piped, k).astype(np.float64)
                                - getattr(one, k).astype(np.float64)).max())
                for k in ("vaf_overall", "vaf_per_channel", "w", "h", "n_iter")}
        log(f"pipelined vs one shot (float32, card): largest gaps {gaps} "
            f"(bar 1e-4 on the VAFs)")
        assert gaps["vaf_overall"] <= 1e-4 and gaps["vaf_per_channel"] <= 1e-4, gaps
        assert piped.channel_names == one.channel_names
        assert piped.sampling_frequency == FS

        # (b) what crossed between host and card during the pipelined call
        copies = self.memcpy_events(trace)
        d2h = [(n, b, st) for n, b, st in copies if "DtoH" in n]
        h2d = [(n, b, st) for n, b, st in copies if "HtoD" in n]
        results = sum(getattr(piped, k).nbytes for k in (
            "w", "h", "vaf_overall", "vaf_per_channel", "n_iter", "converged"))
        emg_bytes = sum(t.array.nbytes for t in trials)
        scalars = [b for _, b, _ in d2h if b <= 64]
        arrays = sum(b for _, b, _ in d2h) - sum(scalars)
        kinds = {}
        for name, nbytes, stream in h2d:
            kinds.setdefault((name, stream), [0, 0])
            kinds[(name, stream)][0] += 1
            kinds[(name, stream)][1] += nbytes
        log(f"pipelined copies: device->host {len(d2h)} copies, {arrays} bytes in "
            f"copies over 64 bytes and {len(scalars)} of at most 64 bytes "
            f"({sum(scalars)} bytes), against {results} bytes of results and "
            f"{emg_bytes} bytes of EMG (float64 on the host)")
        for (name, stream), (n, nbytes) in sorted(kinds.items(), key=str):
            log(f"pipelined copies: host->device {name!r} on stream {stream}: {n} "
                f"copies, {nbytes} bytes")
        assert h2d, "the profiler saw no host->device copy: no trace of the card"
        assert arrays <= results, "trial data came back to the host"
        assert sum(b for _, b, _ in d2h) < emg_bytes / 100

        # float64, 4 captures, chunked against one shot.  K3 takes float32
        # only (a float64 envelope on the card raises), so the float64
        # chain runs the plain versions on the host, where each trial of a
        # distinct length is filtered alone, one sample at a time.  Each
        # capture is cut by the same count from its end, so the captures
        # keep their real differences in length, and both the chunks and
        # the one-shot batch pad as many samples as the full captures do;
        # max_iter 2,000 on both sides, as the JAX test caps it: at the
        # config's 100,000 the float64 rank-1 fits stop on rounding noise
        # too and each sweep runs minutes on the host
        short = min(d.emg.array.shape[0] for d in datas[:4])
        four = {p: d.emg.array[: d.emg.array.shape[0] - short + F64_BASE]
                for p, d in zip(paths[:4], datas)}
        kw = dict(ranks=(1, 2, 3, 4), max_iter=2000, dtype=torch.float64, device="cpu")
        t0 = time.perf_counter()
        chunked = analyze_dataset_pipelined(list(four), FS, chunk_files=2,
                                            loader=four.__getitem__, **kw)
        whole = analyze_dataset(list(four.values()), FS, **kw)
        vaf_gap = float(np.abs(chunked.vaf_overall - whole.vaf_overall).max())
        w_gap = float(np.abs(chunked.w - whole.w).max())
        log(f"pipelined vs one shot (float64, host, 4 captures cut to "
            f"{[len(a) for a in four.values()]} samples from "
            f"{[d.emg.array.shape[0] for d in datas[:4]]}, 2 chunks, max_iter "
            f"2,000): VAF {vaf_gap:.3e} (bar 1e-6), w {w_gap:.3e} (bar 1e-5), "
            f"n_iter max by rank {whole.n_iter.max(axis=1).tolist()} "
            f"({time.perf_counter() - t0:.1f} s)")
        assert vaf_gap <= 1e-6 and w_gap <= 1e-5
        return one

    def pipeline_overlap(self, paths, datas):
        """(c) wall times of the pipelined path against parsing then
        analysing, and the parse time inside its producer; no bar."""
        from muscle_synergies_tpu_torch import analyze_dataset, analyze_dataset_pipelined
        from muscle_synergies_tpu_torch.dataset import _default_capture_loader
        from muscle_synergies_tpu_torch.io import load_vicon_files

        torch = self.torch
        parse_s = []

        def timed_loader(path):
            t = time.perf_counter()
            out = _default_capture_loader(path)
            parse_s.append(time.perf_counter() - t)
            return out

        def wall(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t, out

        for chunk_files in (2, 4, len(paths)):
            parse_s.clear()
            secs, res = wall(lambda: analyze_dataset_pipelined(
                paths, chunk_files=chunk_files, prefetch=2, loader=timed_loader))
            log(f"overlap: pipelined, chunk_files {chunk_files} "
                f"({-(-len(paths) // chunk_files)} chunks): {secs:.3f} s; parse inside "
                f"the producer {sum(parse_s):.3f} s; n_iter max by rank "
                f"{res.n_iter.max(axis=1).tolist()}  [{self.smi}]")
        serial, _ = wall(lambda: analyze_dataset(
            [d.emg for d in load_vicon_files(paths)], FS))
        parse, parsed = wall(lambda: load_vicon_files(paths))
        analyse, _ = wall(lambda: analyze_dataset([d.emg for d in parsed], FS))
        log(f"overlap: parse all (load_vicon_files, threads) then analyze_dataset "
            f"{serial:.3f} s; parse alone {parse:.3f} s + analyze_dataset alone "
            f"{analyse:.3f} s = {parse + analyse:.3f} s  [{self.smi}]")
        # what the consumer's side costs alone: the parsed captures analysed
        # chunk by chunk, each chunk paying its own init and rank-1 tail
        emg = [d.emg for d in parsed]
        for chunk_files in (2, 4):
            secs, _ = wall(lambda: [analyze_dataset(emg[lo:lo + chunk_files], FS)
                                    for lo in range(0, len(emg), chunk_files)])
            log(f"overlap: analyze_dataset alone, chunk by chunk of {chunk_files} "
                f"parsed captures: {secs:.3f} s  [{self.smi}]")

    def cli_checks(self, paths, datas, work, one):
        """(d) the CLI in-process through ``main()``, (e) one real
        subprocess of it with no ``--platform``."""
        from muscle_synergies_tpu_torch import preprocess_trials
        from muscle_synergies_tpu_torch.__main__ import main as cli
        from muscle_synergies_tpu_torch.models.export import load_transform
        from muscle_synergies_tpu_torch.models.persist import _load_run_models

        def run(label, argv, out=None):
            argv = argv + (["-o", out] if out else [])
            code, counts = self.main_path(f"CLI {label}", lambda: cli(argv))
            assert code == 0, (label, code)
            if out is None:
                return None, counts
            with open(out) as fh:
                return json.load(fh), counts

        def vafs(report):
            return np.array([[r[k] for k in sorted(r)] for r in report["vaf_overall"]])

        _, counts = run("describe", ["describe", paths[0]])
        assert sum(counts.values()) == 0, counts
        saved = os.path.join(work, "run.npz")
        rep, counts = run("analyze --ranks 1:4 --save-model",
                          ["analyze", paths[0], "--ranks", "1:4", "--save-model", saved],
                          os.path.join(work, "analyze.json"))
        assert counts["sosfiltfilt"] == 1 and counts["cd_nmf_warp"] == 1, counts
        assert sorted(rep["ranks"]) == ["1", "2", "3", "4"]
        assert all(0 < rep["ranks"][k]["vaf_overall"] <= 1 for k in rep["ranks"])
        # the whole capture, not time-normalised: over one block's shared
        # memory, so the rank sweep is one launch of K2's cluster entry
        full, counts = run("analyze --ranks 1:4 --reduce-to 0",
                           ["analyze", paths[0], "--ranks", "1:4", "--reduce-to", "0"],
                           os.path.join(work, "analyze_full.json"))
        assert counts["sosfiltfilt"] == 1 and counts["cd_nmf_cluster"] == 1, counts
        assert sum(counts.values()) == 2, counts
        assert all(0 < full["ranks"][k]["vaf_overall"] <= 1 for k in full["ranks"])
        log("CLI analyze --reduce-to 0: VAF by rank "
            f"{[round(full['ranks'][k]['vaf_overall'], 6) for k in sorted(full['ranks'])]}")
        plain, counts = run(f"analyze-dataset ({len(paths)} captures)",
                            ["analyze-dataset", *paths], os.path.join(work, "ds.json"))
        assert counts["sosfiltfilt"] == 1 and counts["cd_nmf_warp"] > 0, counts
        piped, counts = run("analyze-dataset --prefetch 2 --chunk-files 4",
                            ["analyze-dataset", *paths, "--prefetch", "2",
                             "--chunk-files", "4"], os.path.join(work, "ds_piped.json"))
        assert counts["sosfiltfilt"] == 4 and counts["cd_nmf_warp"] > 0, counts
        gap = float(np.abs(vafs(piped) - vafs(plain)).max())
        log(f"CLI: analyze-dataset with and without --prefetch: VAF gap {gap:.3e} "
            "(bar 1e-4)")
        assert gap <= 1e-4
        subjects = ",".join(f"s{i // 4}" for i in range(len(paths)))
        grouped, counts = run("analyze-dataset --subjects (4) --cluster-subjects 4",
                              ["analyze-dataset", *paths, "--subjects", subjects,
                               "--cluster-subjects", "4"],
                              os.path.join(work, "ds_subjects.json"))
        assert counts["sosfiltfilt"] == 1 and counts["cd_nmf_warp"] > 0, counts
        assert sorted(grouped["subject_mean_vaf"]) == ["s0", "s1", "s2", "s3"]
        assert grouped["synergy_clusters"]["rank"] == 4
        artifact = os.path.join(work, "run.transform")
        run("export-transform --rank 4 --shape b,200,8 --platforms cuda",
            ["export-transform", saved, "--rank", "4", "--shape", "b,200,8",
             "--platforms", "cuda", "-o", artifact])
        xs = preprocess_trials([d.emg for d in datas], FS)
        model = _load_run_models(saved, device=self.dev)[4]
        want = model.transform(xs)
        got = load_transform(artifact)(xs)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"CLI: exported rank-4 transform replayed on {xs.shape[0]} trials vs the "
            f"eager transform {err:.3e} relative (bar 1e-5)")
        assert err <= 1e-5

        # (e) a real process, as a user runs it: no --platform
        out = os.path.join(work, "cli_subprocess.json")
        cmd = [sys.executable, "-X", "importtime", "-m", "muscle_synergies_tpu_torch",
               "analyze-dataset", *paths, "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-3000:]
        imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                    for line in proc.stderr.splitlines() if line.startswith("import time:")}
        assert len(imported) > 10, "no -X importtime lines: the check would be blind"
        assert not imported & {"pandas", "matplotlib"}, imported & {"pandas", "matplotlib"}
        with open(out) as fh:
            child = json.load(fh)
        gap = float(np.abs(vafs(child) - vafs(plain)).max())
        log(f"CLI subprocess: python -m muscle_synergies_tpu_torch analyze-dataset "
            f"({len(paths)} captures) exited 0 in {secs:.2f} s, imported "
            f"{len(imported)} top-level modules, neither pandas nor matplotlib; VAF "
            f"gap to the in-process report {gap:.3e} (bar 1e-4)  [{self.smi}]")
        assert gap <= 1e-4
        one_vaf = np.array([[one.vaf_overall[i, b] for i in range(len(one.ranks))]
                            for b in range(len(paths))])
        gap = float(np.abs(vafs(plain)[:, :len(one.ranks)] - one_vaf).max())
        log(f"CLI: analyze-dataset's VAF vs the one-shot analyze_dataset of (a) "
            f"{gap:.3e} (its max_iter is 10,000, the config's 100,000)")

    def space_by_time_main(self, emg):
        """``analyze_dataset_space_by_time`` (one K3 launch, then NM3F in
        batched torch products); 20 NM3F updates and the whole fit held
        against float64 on the host; the NM3F loop's time, iterations and
        launches an iteration.  Returns the preprocessed stack for 17."""
        from muscle_synergies_tpu_torch import (
            PipelineConfig,
            analyze_dataset_space_by_time,
            preprocess_trials,
        )
        from muscle_synergies_tpu_torch.models import nm3f

        torch, dev = self.torch, self.dev
        config = PipelineConfig()
        p, q, inits = 4, 3, 4
        res, counts = self.main_path("analyze_dataset_space_by_time", lambda: (
            analyze_dataset_space_by_time(emg, FS, n_temporal=p, n_spatial=q,
                                          n_inits=inits)))
        assert counts["sosfiltfilt"] == 1 and sum(counts.values()) == 1, counts
        b = emg.shape[0]
        assert res.w.shape == (200, p) and res.s.shape == (q, N_CHANNELS)
        assert res.coefficients.shape == (b, p, q) and (res.coefficients >= 0).all()
        assert np.allclose(np.linalg.norm(res.w, axis=0), 1.0, atol=1e-5)
        assert np.allclose(np.linalg.norm(res.s, axis=1), 1.0, atol=1e-5)
        vafs = np.append(res.vaf_per_trial, res.vaf_overall)
        assert np.isfinite(vafs).all() and (vafs <= 1).all(), "bad VAF"
        assert np.isfinite(res.vaf_per_channel).all() and (res.vaf_per_channel <= 1).all()
        log(f"main space-by-time: VAF {res.vaf_overall:.6f} (per trial min "
            f"{res.vaf_per_trial.min():.6f}), winner n_iter {res.n_iter}, restart "
            f"errors {np.round(res.restart_errors, 6).tolist()}")

        xs = self.timed("space-by-time preprocess (K3)",
                        lambda: preprocess_trials(emg, FS, config))
        xs_host = xs.cpu().numpy()

        # 20 updates at 1024 x 200 x 8 in float32 on the card against float64
        big = np.tile(xs_host, (4, 1, 1))
        start = nm3f.init_nm3f(big, p, q, seed=0)
        host = [torch.from_numpy(a).double() for a in (big,) + start]
        for _ in range(20):
            host[1:] = nm3f.nm3f_update(*host)
        for precision, bar in ((None, 1e-4), ("high", 5e-2)):
            card = [torch.from_numpy(a).to(dev) for a in (big,) + start]

            def updates():
                for _ in range(20):
                    card[1:] = nm3f.nm3f_update(*card, precision=precision)

            self.timed(f"nm3f 20 updates at {big.shape}, precision={precision}", updates)
            err = max(rel_err(got.cpu()[None], want[None])  # over the whole factor
                      for got, want in zip(card[1:], host[1:]))
            log(f"nm3f fixed: 20 updates, precision={precision}: max rel factor error "
                f"{err:.3e} (bar {bar:g})")
            assert err <= bar, f"nm3f updates at precision={precision} disagree"

        # the whole fit from the same inits: the card in float32, the host in
        # float64, both at max_iter 2,000
        stacked = [np.stack(f) for f in zip(*[nm3f.init_nm3f(xs_host, p, q, seed=r)
                                              for r in range(inits)])]

        def fit_and_vaf(x, max_iter):
            st = nm3f._fit_restarts(x, *(torch.from_numpy(a).to(x.device, x.dtype)
                                         for a in stacked), max_iter, config.tol, 10,
                                    True, True, None)
            best = int(st.previous_error.argmin())
            w, a, s = nm3f.normalize_modules(st.w[best], st.a[best], st.s[best])
            rec = nm3f.nm3f_reconstruct(w, a, s)
            err2 = ((x - rec) ** 2).sum(dim=(1, 2))
            tot2 = (x * x).sum(dim=(1, 2))
            return (float(1 - err2.sum() / tot2.sum()),
                    (1 - err2 / tot2).cpu().double().numpy(), st.n_iter.cpu())

        card_vaf, card_trials, card_iters = self.timed(
            "nm3f fit, max_iter 2,000 (card, float32)", lambda: fit_and_vaf(xs, 2000))
        t0 = time.perf_counter()
        host_vaf, host_trials, host_iters = fit_and_vaf(xs.cpu().double(), 2000)
        log(f"nm3f fit, max_iter 2,000 on the host in float64: "
            f"{time.perf_counter() - t0:.1f} s")
        diff = max(abs(card_vaf - host_vaf), float(np.abs(card_trials - host_trials).max()))
        log(f"nm3f fit vs float64: VAF {card_vaf:.6f} vs {host_vaf:.6f}, max VAF diff "
            f"(overall and per trial) {diff:.3e} (bar 1e-3); n_iter card "
            f"{card_iters.tolist()} host {host_iters.tolist()}")
        assert diff <= 1e-3, "the space-by-time fit disagrees with float64"

        # the NM3F stage of the default path on its own: time, iterations,
        # and the kernels one iteration launches
        w0, a0, s0 = (torch.from_numpy(a).to(dev) for a in stacked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = nm3f._fit_restarts(xs, w0, a0, s0, config.max_iter, config.tol, 10, True,
                                True, None)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        iters = int(st.n_iter.max())
        log(f"stage nm3f fit: {ms:.2f} ms for {iters} iterations (n_iter "
            f"{st.n_iter.tolist()}), {ms / iters * 1e3:.2f} us an iteration  [{self.smi}]")
        self.nm3f_launches(xs, w0, a0, s0)
        return xs

    def nm3f_launches(self, xs, w, a, s, iters: int = 50):
        """Kernels and device time of ``iters`` NM3F updates of the 4
        stacked restarts, from the torch profiler."""
        from torch.profiler import ProfilerActivity, profile

        from muscle_synergies_tpu_torch.models import nm3f

        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                w, a, s = nm3f._update(xs, w, a, s, True, True)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3  # us -> ms
        if kernels:
            log(f"stage nm3f update: {len(kernels) / iters:.1f} kernels an iteration, "
                f"device busy {busy / iters * 1e3:.2f} us an iteration (torch profiler)"
                f"  [{self.smi}]")
        else:
            log("stage nm3f update: the profiler saw no device kernels; launches an "
                "iteration not measured")

    # ---- 17. the per-capture convolutive and space-by-time models ----
    def per_capture_models(self, xs):
        """``CNMFModel`` (one K5 launch) and ``NM3FModel`` on preprocessed
        trials, their transforms (plain torch) against float64; returns
        the two fitted models for phase 19."""
        from muscle_synergies_tpu_torch.models import CNMFModel, NM3FModel, cnmf, nm3f

        torch = self.torch
        frame, others = xs[0], xs[1:17]

        def cnmf_fit():
            model = CNMFModel(4, 10, n_inits=4)
            return model, model.fit_transform(frame)

        (model, c), counts = self.main_path("CNMFModel 200x8 fit_transform", cnmf_fit)
        assert counts["cnmf"] == 1 and sum(counts.values()) == 1, counts
        assert c.shape == (200, 4) and np.isfinite(c).all() and (c >= 0).all()
        assert model.synergies_.shape == (4, 10, N_CHANNELS)
        ref = CNMFModel(4, 10, n_inits=4, device="cpu", dtype=torch.float64)
        c_ref = ref.fit_transform(frame.cpu().double())
        vafs = [float(cnmf.tvaf(frame.cpu().double(), torch.as_tensor(cc).double(),
                                torch.as_tensor(m.synergies_).double()))
                for cc, m in ((c, model), (c_ref, ref))]
        log(f"CNMFModel: n_iter {model.n_iter_} (float64 on the host {ref.n_iter_}), "
            f"VAF {vafs[0]:.6f} vs {vafs[1]:.6f}")
        assert abs(vafs[0] - vafs[1]) <= 1e-3, "CNMFModel on the card disagrees"
        c_new, counts = self.main_path("CNMFModel transform of 16 trials",
                                       lambda: model.transform(others))
        assert sum(counts.values()) == 0 and c_new.shape == (16, 200, 4), counts
        assert np.isfinite(c_new).all() and (c_new >= 0).all()
        # the default start: the card's draw is the host's
        s_card = torch.as_tensor(model.synergies_, device=self.dev)
        c0 = cnmf._init_c(others, 4, 10, 0)
        c0_host = cnmf._init_c(others.cpu(), 4, 10, 0)
        gap = rel_err(c0.cpu(), c0_host)
        assert gap <= 1e-6, f"the card's default start is not the host's draw ({gap:.2e})"
        kw = dict(c0=c0, max_iter=200, tol=0.0)
        got = self.timed("cnmf_transform 16x200x8, 200 iterations (plain, card)",
                         lambda: cnmf.cnmf_transform(others, s_card, **kw).c)
        want = cnmf.cnmf_transform(others.cpu().double(), s_card.cpu().double(),
                                   c0=c0.cpu().double(), max_iter=200, tol=0.0).c
        err = rel_err(got.cpu(), want)
        log(f"cnmf_transform: default start vs the host's {gap:.1e}; 200 iterations vs "
            f"float64 max rel error {err:.3e} (bar 1e-3)")
        assert err <= 1e-3, "cnmf_transform on the card disagrees with float64"

        def nm3f_fit():
            m = NM3FModel(4, 3)
            return m.fit(xs[:64])

        nm, counts = self.main_path("NM3FModel fit, 64x200x8", nm3f_fit)
        assert sum(counts.values()) == 0, counts
        new = xs[64:80]
        a_new, counts = self.main_path("NM3FModel transform of 16 trials",
                                       lambda: nm.transform(new))
        assert sum(counts.values()) == 0 and a_new.shape == (16, 4, 3), counts
        assert np.isfinite(a_new).all() and (a_new >= 0).all()
        w, s = (torch.as_tensor(m, device=self.dev)
                for m in (nm.temporal_modules_, nm.spatial_modules_))
        a0 = torch.as_tensor(np.random.default_rng(7).random((16, 4, 3)), device=self.dev,
                             dtype=torch.float32)
        got = self.timed("nm3f_transform 16x200x8, 200 iterations (plain, card)",
                         lambda: nm3f.nm3f_transform(new, w, s, a0=a0, max_iter=200,
                                                     tol=0.0).a)
        want = nm3f.nm3f_transform(new.cpu().double(), w.cpu().double(), s.cpu().double(),
                                   a0=a0.cpu().double(), max_iter=200, tol=0.0).a
        err = rel_err(got.cpu(), want)
        log(f"NM3FModel: n_iter {nm.n_iter_}, VAF {nm.vaf_:.6f}; nm3f_transform 200 "
            f"iterations vs float64 max rel error {err:.3e} (bar 1e-3)")
        assert err <= 1e-3, "nm3f_transform on the card disagrees with float64"
        return model, nm

    # ---- 18. stability, held-out rank selection and group-level matching ----
    def stability_phase(self, xs, emg):
        """The bootstraps (one K1 or K5 launch each), the cross-validations
        (plain torch, no launch) and the group-level matching, each held
        against the same call in float64 on the host."""
        from muscle_synergies_tpu_torch import analyze_dataset
        from muscle_synergies_tpu_torch.models import stability

        torch = self.torch
        host = dict(device="cpu", dtype=torch.float64)
        subject = xs[:12].reshape(-1, N_CHANNELS)  # 12 gait cycles, 2,400 x 8
        trial = xs[0]

        def against_host(label, fn, x):
            """``fn`` on the card (counted) and in float64 on the host."""
            t0 = time.perf_counter()
            got, counts = self.main_path(label, lambda: fn(x))
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = fn(x.cpu().double(), **host)
            host_s = time.perf_counter() - t0
            log(f"{label}: card {card_s:.3f} s, float64 host {host_s:.1f} s")
            return got, want, counts

        def same_components(label, got, want, bar=0.999):
            cos = [float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
                   for a, b in zip(got, want)]
            log(f"{label}: reference components' cosine to float64 min {min(cos):.6f} "
                f"(bar {bar})")
            assert min(cos) >= bar, f"{label}: the reference components disagree"

        def same_similarities(label, got, want, bar=2e-3):
            gap = float(np.abs(got.similarities - want.similarities).max())
            log(f"{label}: mean similarity {np.round(got.mean, 4).tolist()}; max gap to "
                f"float64 {gap:.3e} (bar {bar:g})")
            assert gap <= bar, f"{label}: the similarities disagree with float64"

        # bootstraps: one K1 launch (the grid entry at 2,400 rows, 51 fits on
        # two blocks each; the warp entry at 200)
        for label, x, entry in (("bootstrap_synergies 2400x8", subject, "mu_nmf_cluster"),
                                ("bootstrap_synergies 200x8", trial, "mu_nmf_warp")):
            got, want, counts = against_host(
                label, lambda v, **kw: stability.bootstrap_synergies(v, 4, **kw), x)
            assert counts[entry] == 1 and sum(counts.values()) == 1, counts
            self.phase18.setdefault("bootstrap_synergies", got)  # the 2400 x 8 one
            same_similarities(label, got, want)
            same_components(label, got.reference_components, want.reference_components)
        big = xs[:25].reshape(-1, N_CHANNELS)  # 5,000 x 8: over one block's memory
        got, counts = self.main_path("bootstrap_synergies 5000x8 (cluster entry)",
                                     lambda: stability.bootstrap_synergies(big, 4))
        assert counts["mu_nmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        assert np.isfinite(got.similarities).all()
        got, counts = self.main_path(
            "bootstrap_time_varying_synergies 5000x8 (cluster entry)",
            lambda: stability.bootstrap_time_varying_synergies(big, 4, 10, n_boot=2))
        assert counts["cnmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        assert np.isfinite(got.similarities).all()

        # 20 resamples: the float64 host run of the default 50 took 40-60 s
        label = "bootstrap_time_varying_synergies 2400x8 (20 resamples)"
        got, want, counts = against_host(label, lambda v, **kw: (
            stability.bootstrap_time_varying_synergies(v, 4, 10, n_boot=20, **kw)), subject)
        assert counts["cnmf"] == 1 and sum(counts.values()) == 1, counts
        same_similarities(label, got, want)
        same_components(label, got.reference_synergies, want.reference_synergies)
        self.bootstrap_launches(subject)

        # cross-validations: plain torch, no launch
        for label, fn in (
                ("cv_rank_selection 2400x8, ranks 1-8",
                 lambda v, **kw: stability.cv_rank_selection(v, range(1, 9), **kw)),
                ("cv_time_varying_rank_selection 2400x8",
                 lambda v, **kw: stability.cv_time_varying_rank_selection(
                     v, (2, 3, 4, 5), 10, n_repeats=3, **kw))):
            got, want, counts = against_host(label, fn, subject)
            self.phase18[label.split()[0]] = got
            assert sum(counts.values()) == 0, counts
            gap = float(np.abs(got.test_error / want.test_error - 1).max())
            means = np.round(got.mean_test_error.astype(float), 5).tolist()
            log(f"{label}: best rank {got.best_rank} (float64 {want.best_rank}), mean "
                f"held-out error {means}, max relative gap {gap:.3e} (bar 1e-3)")
            assert got.best_rank == want.best_rank and gap <= 1e-3, label

        # space-by-time on 64 trials
        stack = xs[:64]
        label = "bootstrap_space_by_time 64x200x8"
        got, want, counts = against_host(label, lambda v, **kw: (
            stability.bootstrap_space_by_time(v, 4, 3, n_boot=20, **kw)), stack)
        assert sum(counts.values()) == 0, counts
        for side, g, w in zip(("temporal", "spatial"), got, want):
            same_similarities(f"{label} {side}", g, w)
            same_components(f"{label} {side}", g.reference_components,
                            w.reference_components)
        label = "cv_space_by_time_selection 64x200x8"
        pairs = [(2, 2), (3, 3), (4, 3)]
        got, want, counts = against_host(label, lambda v, **kw: (
            stability.cv_space_by_time_selection(v, pairs, n_repeats=2, **kw)), stack)
        assert sum(counts.values()) == 0, counts
        gap = float(np.abs(got.test_error / want.test_error - 1).max())
        log(f"{label}: best {got.best} (float64 {want.best}), max relative gap "
            f"{gap:.3e} (bar 1e-3)")
        assert got.best == want.best and gap <= 1e-3, label
        self.masked_loop(stack, pairs)

        # group level: 64 trials as 8 subjects of 8, clustered at rank 4
        subjects = [f"s{i // 8}" for i in range(64)]
        res, counts = self.main_path(
            "analyze_dataset, 8 subjects x 8 trials",
            lambda: analyze_dataset(emg[:64], FS, subjects=subjects))
        assert counts["sosfiltfilt"] > 0 and counts["cd_nmf_warp"] > 0, counts
        clusters = self.timed("cluster_subjects(4)", lambda: res.cluster_subjects(4))
        sets = [res._subject_mean(4, s) for s in dict.fromkeys(subjects)]
        on_card = [torch.as_tensor(s, dtype=torch.float32, device=self.dev) for s in sets]
        want = stability.cluster_synergies(sets)
        for label, got in (("cluster_subjects", clusters),
                           ("cluster_synergies of card tensors",
                            stability.cluster_synergies(on_card))):
            assert all((g == w).all() for g, w in zip(got.labels, want.labels)), label
            assert (got.membership == want.membership).all(), label
            gap = float(np.abs(got.consensus - want.consensus).max())
            log(f"{label}: {got.n_clusters} clusters, shared {got.shared.tolist()}, "
                f"coverage {np.round(got.coverage, 3).tolist()}; consensus gap {gap:.1e} "
                "(bar 1e-6)")
            assert gap <= 1e-6, label
        got = stability.match_synergies(on_card[0], on_card[1])
        want = stability.match_synergies(sets[0], sets[1])
        gap = float(np.abs(got.similarities - want.similarities).max())
        log(f"match_synergies s0-s1: pairs {got.pairs}, mean {got.mean:.6f}; gap to "
            f"float64 {gap:.1e}")
        assert got.pairs == want.pairs and gap <= 1e-6, "match_synergies disagrees"

    # ---- 19. resume, persistence, export, profiling ----
    def serving_phase(self, xs, cnmf_model, nm3f_model):
        """Checkpointed bootstraps and CV resumed on the card (exact K1
        and K5 launch counts, equal to the one-shot calls), three models
        saved and loaded (bit-equal factors and transforms), their
        transforms exported and replayed in a process without the
        package, and the profiling scopes."""
        import shutil
        import tempfile

        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
        os.makedirs(root, exist_ok=True)
        work = tempfile.mkdtemp(prefix="chip_smoke_serving_", dir=root)
        server = self.serving_process(work)
        try:
            subject = xs[:12].reshape(-1, N_CHANNELS)  # 12 gait cycles, 2,400 x 8
            self.resume_checks(subject, work)
            models = self.persist_checks(xs, cnmf_model, nm3f_model, work)
            self.export_checks(xs, models, work, server)
            self.profiling_checks(xs)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait()
            shutil.rmtree(work, ignore_errors=True)

    def serving_process(self, work):
        """Start the process that serves the exported transforms: it has
        torch and NumPy, not this package (``export.py`` is loaded from
        its file alone).  It imports torch, opens the card's context and
        warms ``torch.export``'s serialisation on a one-op program while
        the phase runs, then waits for a line on its standard input
        before it loads the artifacts and calls them."""
        from muscle_synergies_tpu_torch.models import export

        child = f"""
import importlib.util, io, json, sys, time
import numpy as np
import torch
torch.zeros(1, device="cuda")
buf = io.BytesIO()
torch.export.save(torch.export.export(torch.nn.ReLU(), (torch.ones(2),)), buf)
torch.export.load(io.BytesIO(buf.getvalue()))
spec = importlib.util.spec_from_file_location("_serving_export", {export.__file__!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.stdin.readline()
out = {{}}
for name in ("NMFModel", "CNMFModel", "NM3FModel"):
    t0 = time.perf_counter()
    fn = mod.load_transform({work!r} + "/" + name + ".transform")
    out[name] = {{"load_ms": (time.perf_counter() - t0) * 1e3}}
    for b in (16, 3):
        x = torch.as_tensor(np.load({work!r} + f"/x{{b}}.npy"), device="cuda")
        if b == 16:
            fn(x)  # the program's first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn(x)
        out[name][f"call_ms_{{b}}"] = (time.perf_counter() - t0) * 1e3
        np.save({work!r} + f"/{{name}}_y{{b}}.npy", y)
out["port_imported"] = sorted(m for m in sys.modules if m.startswith("muscle_synergies"))
print(json.dumps(out))
"""
        return subprocess.Popen([sys.executable, "-c", child], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def resume_checks(self, subject, work):
        from muscle_synergies_tpu_torch.models import resume, stability
        from muscle_synergies_tpu_torch.utils import GridCheckpoint

        def same_as_one_shot(label, got, want, ref_attr):
            gap = float(np.abs(got.similarities - want.similarities).max())
            ref = float(np.abs(getattr(got, ref_attr) - getattr(want, ref_attr)).max())
            log(f"{label}: similarities vs the one-shot call on the card max gap "
                f"{gap:.3e}, reference {ref:.3e} (bar 1e-6)")
            assert gap <= 1e-6 and ref <= 1e-6, f"{label}: differs from the one-shot call"

        t0 = time.perf_counter()
        want = stability.bootstrap_synergies(subject, 4, n_boot=50)
        log(f"stage one-shot bootstrap_synergies (reference for 19a): "
            f"{time.perf_counter() - t0:.3f} s  [{self.smi}]")
        ck = os.path.join(work, "bootstrap")
        run = lambda: resume.bootstrap_synergies_checkpointed(  # noqa: E731
            subject, 4, ck, n_boot=50, chunk_size=10)
        for label, drop, launches in (("from empty", (), 5),
                                      ("fully restored", (), 1),
                                      ("two chunks deleted", ("chunk_00010_00020",
                                                              "chunk_00030_00040"), 2)):
            for key in drop:
                os.remove(os.path.join(ck, f"{key}.npz"))
            got, counts = self.main_path(f"bootstrap_synergies_checkpointed {label}", run)
            assert counts["mu_nmf_cluster"] == launches and sum(counts.values()) == launches, \
                counts
            same_as_one_shot(f"bootstrap_synergies_checkpointed {label}", got, want,
                             "reference_components")
        grid = GridCheckpoint(ck)
        keys = grid.completed_keys()
        t0 = time.perf_counter()
        for key in keys:
            grid.load(key)
        load_ms = (time.perf_counter() - t0) * 1e3 / len(keys)
        t0 = time.perf_counter()
        grid.save("probe", {"sims": want.similarities[:10]}, meta={"range": [0, 10]})
        save_ms = (time.perf_counter() - t0) * 1e3
        log(f"stage checkpoint chunk: save {save_ms:.3f} ms, restore {load_ms:.3f} ms a "
            f"chunk ({len(keys)} chunks)  [{self.smi}]")

        want = stability.bootstrap_time_varying_synergies(subject, 4, 10, n_boot=20)
        got, counts = self.main_path(
            "bootstrap_time_varying_synergies_checkpointed from empty",
            lambda: resume.bootstrap_time_varying_synergies_checkpointed(
                subject, 4, 10, os.path.join(work, "tv"), n_boot=20, chunk_size=10))
        assert counts["cnmf"] == 2 and sum(counts.values()) == 2, counts
        same_as_one_shot("bootstrap_time_varying_synergies_checkpointed", got, want,
                         "reference_synergies")

        # the CV columns are held to the one-shot grid's at 1e-6 in float64;
        # in float32 (the default on the card) a candidate's unconverged
        # masked fits amplify the rounding of batched products shared with
        # fewer fits than in the grid, so that gap is logged, not held
        for dtype, bar in ((self.torch.float64, 1e-6), (self.torch.float32, None)):
            kw = dict(dtype=dtype)
            want = stability.cv_rank_selection(subject, range(1, 9), **kw)
            ck = os.path.join(work, f"cv_{str(dtype)[6:]}")
            for label, drop in (("from empty", ()), ("three candidates deleted",
                                                     ("rank_2", "rank_5", "rank_8"))):
                for key in drop:
                    os.remove(os.path.join(ck, f"{key}.npz"))
                label = f"cv_rank_selection_checkpointed {str(dtype)[6:]} {label}"
                got, counts = self.main_path(label, lambda: (
                    resume.cv_rank_selection_checkpointed(subject, range(1, 9), ck, **kw)))
                assert sum(counts.values()) == 0, counts
                gap = float(np.abs(got.test_error / want.test_error - 1).max())
                log(f"{label}: best rank {got.best_rank} (one-shot {want.best_rank}), "
                    f"held-out errors' max relative gap {gap:.3e} "
                    f"({'bar 1e-6' if bar else 'logged'})")
                assert got.best_rank == want.best_rank, label
                assert bar is None or gap <= bar, label

    def persist_checks(self, xs, cnmf_model, nm3f_model, work):
        """Returns the three fitted models, for the export checks."""
        from muscle_synergies_tpu_torch import NMFModel, load_model

        frame, others = xs[0], xs[1:17]

        def fit():
            model = NMFModel(4)
            model.fit_transform(frame)
            return model

        nmf_model, counts = self.main_path("NMFModel 200x8 fit (to save)", fit)
        assert counts["cd_nmf_warp"] == 1 and sum(counts.values()) == 1, counts
        models = {"NMFModel": nmf_model, "CNMFModel": cnmf_model, "NM3FModel": nm3f_model}
        for name, model in models.items():
            path = os.path.join(work, f"{name}.npz")
            t0 = time.perf_counter()
            model.save(path)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            loaded = type(model).load(path)
            load_ms = (time.perf_counter() - t0) * 1e3
            factors, again = model._transform_factors(), loaded._transform_factors()
            assert all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(factors, again)), f"{name}: factors changed"
            got, want = loaded.transform(others), model.transform(others)
            assert np.array_equal(got, want), f"{name}: the reloaded transform differs"
            host = load_model(path, device="cpu")
            assert host.device == "cpu" and all(
                np.array_equal(a, b) for a, b in zip(factors, host._transform_factors()))
            log(f"{name}: saved in {save_ms:.2f} ms ({os.path.getsize(path)} bytes), "
                f"loaded in {load_ms:.2f} ms; factors and the transform of 16 trials "
                f"{want.shape} equal bit for bit; loads with device='cpu'  [{self.smi}]")
        return models

    def export_checks(self, xs, models, work, server):
        from muscle_synergies_tpu_torch.models import export

        batches = {16: xs[1:17], 3: xs[17:20]}
        for b, x in batches.items():
            np.save(os.path.join(work, f"x{b}.npy"), x.cpu().numpy())
        eager = {}
        for name, model in models.items():
            path = os.path.join(work, f"{name}.transform")
            t0 = time.perf_counter()
            export.export_transform(model, ("b", 200, N_CHANNELS), platforms=("cuda",),
                                    path=path)
            log(f"stage export_transform {name}: {time.perf_counter() - t0:.2f} s, "
                f"{os.path.getsize(path)} bytes  [{self.smi}]")
            for b, x in batches.items():  # warm: the persistence checks ran it
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                eager[name, b] = model.transform(x)
                ms = (time.perf_counter() - t0) * 1e3
                log(f"stage eager transform {name}, {b} trials: {ms:.2f} ms  [{self.smi}]")
        t0 = time.perf_counter()
        stdout, stderr = server.communicate("go\n", timeout=300)
        assert server.returncode == 0, stderr[-4000:]
        served = json.loads(stdout.strip().splitlines()[-1])
        log(f"stage serving process after the go (3 loads, 9 calls): "
            f"{time.perf_counter() - t0:.2f} s  [{self.smi}]")
        assert served.pop("port_imported") == [], "the serving process imported the package"
        for name in models:
            for b in batches:
                got = np.load(os.path.join(work, f"{name}_y{b}.npy"))
                want = eager[name, b]
                assert got.shape == want.shape, (name, b, got.shape, want.shape)
                err = float(np.abs(got - want).max() / np.abs(want).max())
                log(f"load_transform {name}, {b} trials: max rel error to the eager "
                    f"transform {err:.2e} (bar 1e-5); call {served[name][f'call_ms_{b}']:.2f}"
                    f" ms, load {served[name]['load_ms']:.1f} ms  [{self.smi}]")
                assert err <= 1e-5, f"{name}: the exported transform disagrees"

    def profiling_checks(self, xs):
        from torch.profiler import ProfilerActivity, profile

        from muscle_synergies_tpu_torch import NMFModel
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models.kernels import mu_cuda
        from muscle_synergies_tpu_torch.utils import annotate, debug_nans, solver_report

        torch, dev = self.torch, self.dev
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with annotate("phase19"):
                NMFModel(4).fit_transform(xs[0])
            torch.cuda.synchronize()
        device_us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                        for e in prof.key_averages() if e.key == "phase19")
        log(f"annotate('phase19') around one CD fit: {device_us:.1f} us of device time "
            f"in the torch profiler's trace  [{self.smi}]")
        assert device_us > 0, "the annotation shows no device time"

        with debug_nans():
            try:
                torch.log(-torch.ones(4, device=dev))
            except FloatingPointError as exc:
                log(f"debug_nans, torch op: {exc}")
            else:
                raise AssertionError("debug_nans let a NaN from a torch op through")
        x = xs[:4].clone()
        x[0, 0, 0] = float("nan")
        w0, h0 = mb.init_batch(xs[:4], 4)
        with debug_nans():
            try:
                mu_cuda.mu_iterations_cuda(x, w0, h0, 5)
            except FloatingPointError as exc:
                assert "mu_nmf" in str(exc), exc
                log(f"debug_nans, kernel wrapper: {exc}")
            else:
                raise AssertionError("debug_nans let a NaN out of K1")
        mu_cuda.mu_iterations_cuda(x, w0, h0, 5)  # off again: no check

        st = mb.fit_mu_batch(xs[:4], w0, h0, max_iter=200, tol=1e-4)
        rep = solver_report(st, xs[:4])
        w, h = (t.cpu().double().numpy() for t in (st.w, st.h))
        want = np.sqrt(((xs[:4].cpu().double().numpy() - w @ h) ** 2).sum(axis=(1, 2)))
        assert (rep["n_iter"] == st.n_iter.cpu().numpy()).all()
        assert (rep["converged"] == st.converged.cpu().numpy()).all()
        assert rep["converged_fraction"] == float(st.converged.float().mean())
        assert np.array_equal(rep["error_at_last_check"], st.previous_error.cpu().numpy())
        err = float(np.abs(rep["final_error"] - want).max() / want.max())
        log(f"solver_report on a card MUState: n_iter {rep['n_iter'].tolist()}, final "
            f"error vs NumPy float64 max rel {err:.2e} (bar 1e-5)")
        assert err <= 1e-5, "solver_report's final error disagrees with NumPy"

    def bootstrap_launches(self, x, n_boot: int = 50):
        """The bootstraps' one K1 and one K5 launch alone, on the batch
        they build (the full matrix, then its resamples), against their
        bounds at the iterations their fits ran."""
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models import cnmf, stability
        from muscle_synergies_tpu_torch.models.init import initialize_nmf
        from muscle_synergies_tpu_torch.models.kernels import mu_cuda

        torch, dev = self.torch, self.dev
        n, l = x.shape
        host = x.cpu().double().numpy()
        rng = np.random.default_rng(0)
        rows = torch.as_tensor(rng.integers(0, n, size=(n_boot, n)), device=dev)
        xs = torch.cat([x[None], x[rows]])
        w0, h0 = initialize_nmf(xs, 4)
        blocks = stability._block_bootstrap_indices(n, 40, n_boot,
                                                    np.random.default_rng(0))
        cx = torch.cat([x[None], x[torch.as_tensor(blocks, device=dev)]])
        c0, s0 = (torch.as_tensor(np.concatenate([a[None], b]), dtype=torch.float32,
                                  device=dev)
                  for a, b in zip(cnmf.init_cnmf(host, 4, 10),
                                  cnmf.init_cnmf(host[blocks], 4, 10)))
        for kname, fit, k, d, sizes in (
                ("mu_nmf", lambda: mb.fit_mu_batch(xs, w0, h0, max_iter=500, tol=1e-6),
                 4, 1, n * l + 2 * (n * 4 + 4 * l)),
                ("cnmf", lambda: cnmf.fit_cnmf_batch(cx, c0, s0, max_iter=300, tol=1e-5),
                 4, 10, n * l + 2 * (n * 4 + 4 * 10 * l))):
            before = mu_cuda.cluster_launches
            st = fit()
            ms = cuda_ms(fit, reps=3)
            log(f"stage {kname} launch of the bootstrap ({n_boot + 1} fits of {n}x{l}): "
                f"{ms:.3f} ms  [{self.smi}]")
            if kname == "mu_nmf":
                # K1's bootstrap of a subject's matrix runs on its grid entry
                assert mu_cuda.cluster_launches > before, "K1's bootstrap took another entry"
                log(f"mu_nmf bootstrap: grid plan {mu_cuda.last_plan}, "
                    f"{mu_cuda.blocks_per_sm['mu_nmf']} blocks a SM")
            fit_bound(kname, st.n_iter, n, l, k, 4 * (n_boot + 1) * sizes, d=d)

    def masked_loop(self, stack, pairs, n_repeats: int = 2, iters: int = 20):
        """The space-by-time CV's batched masked loop on its own: its time,
        iterations, and kernels an iteration from the torch profiler."""
        from torch.profiler import ProfilerActivity, profile

        from muscle_synergies_tpu_torch.models import nm3f, stability

        torch = self.torch
        host = stack.cpu().double().numpy()
        masks_host, masks = stability._holdout_masks(
            np.random.default_rng(0), (n_repeats,) + host.shape, 0.1, stack)
        inits = [stability._padded(*nm3f.init_nm3f(host * masks_host[r], p, q, seed=r),
                                   4, 3) for r in range(n_repeats) for p, q in pairs]
        gm = masks.repeat_interleave(len(pairs), dim=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = stability._fit_stack(stack, inits, 400, 1e-6, mask=gm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        most = int(st.n_iter.max())
        log(f"stage masked nm3f loop ({len(inits)} fits): {ms:.2f} ms for {most} "
            f"iterations (n_iter {st.n_iter.tolist()}), {ms / most * 1e3:.2f} us an "
            f"iteration  [{self.smi}]")
        w, a, s = st.w, st.a, st.s
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                w, a, s = nm3f._masked_update(stack, w, a, s, True, True, gm)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        if kernels:
            log(f"stage masked nm3f update: {len(kernels) / iters:.1f} kernels an "
                f"iteration, device busy {busy / iters * 1e3:.2f} us an iteration "
                f"(torch profiler)  [{self.smi}]")
        else:
            log("stage masked nm3f update: the profiler saw no device kernels; launches "
                "an iteration not measured")

    def lone_fit(self, kname, n_iter, fit):
        """Time the path's longest fit alone on the card: the latency of
        one fit's iteration, which sets the path's tail."""
        torch = self.torch
        i = int(n_iter.argmax())
        idx = torch.tensor([i], device=n_iter.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lone = fit(idx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        iters = int(lone.n_iter[0])
        log(f"stage {kname} longest fit alone ({iters} iterations): {ms:.2f} ms, "
            f"{ms / iters * 1e3:.3f} us an iteration  [{self.smi}]")

    def stage_breakdown(self, emg):
        """Per-stage device times of the Frobenius path (preprocess, init,
        fit, VAF)."""
        from muscle_synergies_tpu_torch import PipelineConfig
        from muscle_synergies_tpu_torch.dataset import preprocess_trials
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models.cnmf import (
            cnmf_reconstruct,
            fit_cnmf_batch,
            init_cnmf,
            normalize_synergies,
        )

        torch, dev = self.torch, self.dev
        config = PipelineConfig()

        xs = self.timed("host->device 1 GiB", lambda: torch.from_numpy(emg).to(dev))
        from muscle_synergies_tpu_torch import FilterSpec
        from muscle_synergies_tpu_torch.ops import filter_cuda, filters

        self.timed("preprocess causal (K6 inside)", lambda: preprocess_trials(
            xs, FS, PipelineConfig(envelope=FilterSpec(zero_lag=False))))
        self.timed("preprocess rms (equal lengths)",
                   lambda: preprocess_trials(xs, FS, PipelineConfig(use_rms=True)))
        rect = (xs - xs.mean(dim=1, keepdim=True)).abs()
        sos = filters.sos_design(4, 4.0, FS)
        ms = cuda_ms(lambda: filter_cuda.sosfilt_cuda(sos, rect))
        cols = rect.shape[0] * N_CHANNELS
        ms_b, by = bound(len(sos) * 10 * cols * rect.shape[1],
                         2 * rect.numel() * 4 + 2 * len(sos) * 2 * cols * 8, "f64")
        log(f"stage K6 at {tuple(rect.shape)}: {ms:.3f} ms, bound {ms_b:.4f} ms "
            f"({by})  [{self.smi}]")
        del rect
        xs = self.timed("preprocess (envelope, resample, normalize)",
                        lambda: preprocess_trials(xs, FS, config))
        stop = dict(max_iter=config.max_iter, tol=config.tol)
        self.grid_fits(xs, {
            "cd_nmf": lambda x, w, h: mb.fit_cd_batch(x, w, h, **stop),
            "mu_nmf": lambda x, w, h: mb.fit_mu_batch(x, w, h, **stop),
            "beta_nmf_kl": lambda x, w, h: mb.fit_mu_beta_batch(x, w, h, beta=1.0,
                                                                **stop),
        })
        n, l = xs.shape[1:]

        # the time-varying path's own stages: 4 restarts of every trial
        c0, s0 = self.timed("init cnmf on the host + copy (1024 restarts)",
                            lambda: [torch.from_numpy(a).to(dev) for a in init_cnmf(
                                np.repeat(xs.cpu().numpy(), 4, axis=0), 4, 10)])
        gx = xs.repeat_interleave(4, dim=0)
        st = self.timed("fit cnmf (kernel, 1024 fits)",
                        lambda: fit_cnmf_batch(gx, c0, s0, max_iter=config.max_iter,
                                               tol=config.tol))
        fit_bound("cnmf", st.n_iter, n, l, 4,
                  4 * gx.shape[0] * (n * l + 2 * (n * 4 + 4 * 10 * l)), d=10)
        self.lone_fit("cnmf", st.n_iter, lambda i: fit_cnmf_batch(
            gx[i], c0[i], s0[i], max_iter=config.max_iter, tol=config.tol))

        def tv_finish():
            errs = st.previous_error.view(-1, 4)
            best = torch.arange(errs.shape[0], device=dev) * 4 + errs.argmin(dim=1)
            c, s = normalize_synergies(st.c[best], st.s[best])
            err2 = ((xs - cnmf_reconstruct(c, s)) ** 2).sum(dim=(1, 2))
            return 1.0 - err2 / (xs * xs).sum(dim=(1, 2))

        self.timed("winners, normalize, vaf (time-varying)", tv_finish)


    # ---- 21. the device mesh (torch.distributed) at world size 1 ----
    def mesh_phase(self, emg, xs):
        """Phase 21: the sharded code path of ``parallel`` over a real NCCL
        communicator of one process (the card's machine has one card)."""
        import shutil

        import torch.distributed as dist

        from muscle_synergies_tpu_torch import PipelineConfig, analyze_dataset, parallel
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models import cnmf, nm3f, stability
        from muscle_synergies_tpu_torch.ops import filters
        from muscle_synergies_tpu_torch.parallel._spmd import full
        from muscle_synergies_tpu_torch.utils.checkpoint import GridCheckpoint

        torch, dev = self.torch, self.dev
        t0 = time.perf_counter()
        assert parallel.init_distributed() == 1
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = parallel.make_mesh((1, 1))
        mesh_tp = parallel.make_mesh((1, 1), axis_names=("data", "model"))
        log(f"mesh: NCCL, world size 1, {mesh} and {mesh_tp} in "
            f"{time.perf_counter() - t0:.2f} s")

        def on_card(state):
            for f in state:
                local = getattr(f, "to_local", lambda: f)()
                assert local.device == dev, f"a shard on {local.device}"
            return type(state)(*(full(f) for f in state))

        # (a) the meshed dataset path against phase 5's kernel path
        def gaps(label, got, mesh_s, want, want_s):
            vaf = float(np.abs(got.vaf_overall - want.vaf_overall).max())
            w_gap = float(np.abs(got.w - want.w).max() / np.abs(want.w).max())
            h_gap = float(np.abs(got.h - want.h).max() / np.abs(want.h).max())
            iters = int(got.n_iter.max())
            log(f"mesh {label}: VAF gap {vaf:.3e} (bar 1e-3), w {w_gap:.3e}, h "
                f"{h_gap:.3e} relative to max; n_iter max {int(got.n_iter.max())} "
                f"(kernel {int(want.n_iter.max())}); wall {mesh_s:.3f} s, "
                f"{mesh_s / iters * 1e6:.1f} us an iteration of the longest fit, "
                f"against the kernel path's {want_s:.3f} s, "
                f"{want_s / int(want.n_iter.max()) * 1e6:.1f} us  [{self.smi}]")
            assert vaf <= 1e-3, f"mesh {label}: the VAF disagrees"

        def meshed(label, **kw):
            res, counts = self.main_path(f"analyze_dataset {label} mesh=(1, 1)",
                                         lambda: analyze_dataset(emg, FS, mesh=mesh, **kw))
            assert counts["sosfiltfilt"] == 1, counts  # time_shards 1: the local K3
            assert sum(counts.values()) == 1, f"a kernel on the meshed solve: {counts}"
            self.check_rank_sweep(f"mesh {label}", res)
            return res

        res = meshed("solver=mu", solver="mu")
        gaps("solver=mu", res, self.last_seconds, *self.phase5["mu"])
        probe = meshed("solver=cd max_iter=2000 (probe)", solver="cd", max_iter=2000)
        probe_s = self.last_seconds
        full_iter = PipelineConfig().max_iter
        projected = probe_s * full_iter / 2000
        if projected > 60:
            log(f"mesh solver=cd: the probe projects {projected:.0f} s at max_iter "
                f"{full_iter:,}: both sides compared at max_iter 2,000")
            ref, _ = self.main_path("analyze_dataset solver=cd max_iter=2000 (K2)",
                                    lambda: analyze_dataset(emg, FS, solver="cd",
                                                            max_iter=2000))
            gaps("solver=cd max_iter=2000", probe, probe_s, ref, self.last_seconds)
        else:
            cd = meshed("solver=cd", solver="cd")
            gaps("solver=cd", cd, self.last_seconds, *self.phase5["cd"])

        # (b) the sequence-parallel filters (K6 inside) against K3 and K6
        sos = filters.sos_design(4, 4.0, FS)
        sub = emg[:64]
        sub = np.abs(sub - sub.mean(axis=1, keepdims=True))
        folded = torch.from_numpy(sub).to(dev).transpose(0, 1).reshape(N_SAMPLES, -1)
        folded = folded.contiguous()
        del sub
        for label, sharded, plain, launches, kname, kernel_ms in (
                ("sharded_sosfiltfilt", parallel.sharded_sosfiltfilt, filters.sosfiltfilt,
                 7, "K3", 0.747),
                ("sharded_sosfilt", parallel.sharded_sosfilt, filters.sosfilt, 2, "K6",
                 0.399)):
            y, counts = self.main_path(f"{label} 124,460 x 512 mesh=(1, 1)",
                                       lambda: sharded(sos, folded, mesh))
            assert counts["sosfilt"] == launches and sum(counts.values()) == launches, \
                counts
            assert y.to_local().device == dev
            ref = plain(sos, folded)
            gap = float((y.full_tensor() - ref).abs().max() / ref.abs().max())
            ms = cuda_ms(lambda: sharded(sos, folded, mesh))
            ref_ms = cuda_ms(lambda: plain(sos, folded))
            log(f"mesh {label}: {launches} K6 launches, gap to {kname} "
                f"{gap:.3e} x max|y| (bar "
                f"5e-4); {ms:.3f} ms against the kernel's {ref_ms:.3f} ms here "
                f"({kernel_ms} ms in the PERF.md table)  [{self.smi}]")
            assert gap <= 5e-4, f"mesh {label} disagrees"
        del folded, y, ref

        # (c) the other sharded solvers against the port's plain functions
        g = torch.Generator(device=dev).manual_seed(21)
        x = xs[:64].contiguous()
        b, k, iters = x.shape[0], 4, 30
        w0 = torch.rand((b, 200, k), device=dev, generator=g)
        h0 = torch.rand((b, k, N_CHANNELS), device=dev, generator=g)
        fixed = dict(max_iter=iters, tol=0.0)
        cases = [
            ("sharded_fit_cd", lambda: parallel.sharded_fit_cd(x, w0, h0, mesh, **fixed),
             lambda: mb.cd_iterations_batch(x, w0, h0, iters, impl="torch"),
             lambda s: (s.w, s.ht.transpose(-1, -2))),
            ("sharded_fit_kl", lambda: parallel.sharded_fit_kl(x + 1e-3, w0, h0, mesh,
                                                               **fixed),
             lambda: mb.beta_mu_iterations_batch(x + 1e-3, w0, h0, iters, beta=1.0,
                                                 impl="torch"),
             lambda s: (s.w, s.h)),
            ("sharded_fit_mu_tp", lambda: parallel.sharded_fit_mu_tp(x, w0, h0, mesh_tp,
                                                                     **fixed),
             lambda: mb.mu_iterations_batch(x, w0, h0, iters, impl="torch"),
             lambda s: (s.w, s.h)),
        ]
        c0 = torch.rand((b, 200, k), device=dev, generator=g)
        s0 = torch.rand((b, k, 10, N_CHANNELS), device=dev, generator=g)
        cases.append(("sharded_fit_cnmf",
                      lambda: parallel.sharded_fit_cnmf(x, c0, s0, mesh, **fixed),
                      lambda: cnmf.cnmf_iterations_batch(x, c0, s0, iters, impl="torch"),
                      lambda s: (s.c, s.s)))
        w_t = torch.rand((200, 4), device=dev, generator=g)
        a_t = torch.rand((b, 4, 3), device=dev, generator=g)
        s_t = torch.rand((3, N_CHANNELS), device=dev, generator=g)
        cases.append(("sharded_fit_nm3f",
                      lambda: parallel.sharded_fit_nm3f(x, w_t, a_t, s_t, mesh, **fixed),
                      lambda: nm3f.fit_nm3f(x, w_t, a_t, s_t, **fixed),
                      lambda s: (s.w, s.a, s.s)))
        for label, sharded, plain, factors in cases:
            got, counts = self.main_path(f"{label} {b} x 200 x 8, {iters} iterations",
                                         lambda: on_card(sharded()))
            assert sum(counts.values()) == 0, counts
            want = plain()
            want = factors(want) if hasattr(want, "_fields") else want
            gap = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(factors(got), want))
            log(f"mesh {label}: {iters} iterations from the same start, float32 on the "
                f"card: max factor gap to the plain function {gap:.3e} (bar 1e-4)")
            assert gap <= 1e-4, f"mesh {label} disagrees with the plain function"

        # (d) the meshed stability calls against phase 18's
        subject = xs[:12].reshape(-1, N_CHANNELS)
        got, counts = self.main_path("bootstrap_synergies 2400x8 mesh=(1, 1)",
                                     lambda: stability.bootstrap_synergies(subject, 4,
                                                                           mesh=mesh))
        assert sum(counts.values()) == 0, counts
        want = self.phase18["bootstrap_synergies"]
        sim_gap = float(np.abs(got.similarities - want.similarities).max())
        cos = [float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
               for a, b in zip(got.reference_components, want.reference_components)]
        log(f"mesh bootstrap_synergies: similarity gap to phase 18 {sim_gap:.3e} (bar "
            f"2e-3), reference cosine min {min(cos):.6f} (bar 0.999)")
        assert sim_gap <= 2e-3 and min(cos) >= 0.999, "mesh bootstrap disagrees"
        got, counts = self.main_path(
            "cv_rank_selection 2400x8, ranks 1-8 mesh=(1, 1)",
            lambda: stability.cv_rank_selection(subject, range(1, 9), mesh=mesh))
        assert sum(counts.values()) == 0, counts
        want = self.phase18["cv_rank_selection"]
        gap = float(np.abs(got.test_error / want.test_error - 1).max())
        log(f"mesh cv_rank_selection: best rank {got.best_rank} (phase 18 "
            f"{want.best_rank}), max relative gap {gap:.3e} (bar 1e-3)")
        assert got.best_rank == want.best_rank and gap <= 1e-3, "mesh CV disagrees"

        # (e) the orbax store round trip
        root = os.path.join("build", "phase21_orbax")
        shutil.rmtree(root, ignore_errors=True)
        chunk = {"h": res.h, "vaf": res.vaf_overall, "n_iter": res.n_iter}
        try:
            store = GridCheckpoint(root, backend="orbax")
            t = time.perf_counter()
            store.save("chunk_0", chunk, meta={"phase": 21})
            save_s = time.perf_counter() - t
            back = GridCheckpoint(root, backend="orbax").load("chunk_0")
            same = all(np.array_equal(back["arrays"][k], v) for k, v in chunk.items())
            log(f"mesh orbax store: {sorted(chunk)} saved in {save_s * 1e3:.1f} ms, "
                f"restored bit-equal {same}")
            assert same and back["meta"] == {"phase": 21}, "the orbax store disagrees"
        finally:
            shutil.rmtree(root, ignore_errors=True)
    # ---- 22. large frames: the cluster entries of K1 and K2 ----
    def large_frames(self, emg, xs):
        """Phase 22: frames over one block's shared memory, on the cluster
        entries of K1 and K2 (one fit spread over many blocks): fixed
        iterations and fits against float64, the calls that run them under
        default arguments, and a lone capture-length fit's iteration."""
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models import select, stability
        from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda
        from muscle_synergies_tpu_torch.models.mu import mu_update
        from muscle_synergies_tpu_torch.ops import batched

        torch, dev, rng = self.torch, self.dev, self.rng
        entries = {
            "mu_nmf_cluster": (mu_cuda, mu_cuda.mu_iterations_cuda,
                               mu_cuda.mu_iterations_plain, mu_cuda.fit_mu_cuda,
                               mu_cuda.fit_mu_plain, mu_update,
                               "muscle_synergies_tpu/models/kernels/mu_pallas.py:269",
                               "muscle_synergies_tpu/models/kernels/mu_pallas.py:205"),
            "cd_nmf_cluster": (cd_cuda, cd_cuda.cd_iterations_cuda,
                               cd_cuda.cd_iterations_plain, cd_cuda.fit_cd_cuda,
                               cd_cuda.fit_cd_plain, self._cd_step,
                               "muscle_synergies_tpu/models/kernels/cd_pallas.py:168",
                               "muscle_synergies_tpu/models/kernels/cd_pallas.py:248"),
        }
        for shape in ((6_000, 8, 4), (20_000, 8, 4), (20_000, 16, 4), (N_SAMPLES, 8, 8)):
            assert mu_cuda.route(*shape) == cd_cuda.route(*shape) == "cluster", shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        # (a) 50 fixed iterations against the plain version in float64
        def problem(b, n, l, k):
            return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.random((b, n, l)), np.abs(rng.standard_normal((b, n, k))),
                np.abs(rng.standard_normal((b, k, l))))]

        iters = 50
        cases = (problem(4, 20_000, N_CHANNELS, 4), problem(2, N_SAMPLES, N_CHANNELS, 8))
        for kname, (mod, kern, plain, _, _, _, replaces, also) in entries.items():
            errs = []
            for x, w, h in cases:
                b, n, l = x.shape
                k = w.shape[-1]
                before = mod.cluster_launches
                wk, hk = kern(x, w, h, iters)
                assert mod.cluster_launches == before + 1, f"{kname} took another entry"
                wp, hp = plain(x.double(), w.double(), h.double(), iters)
                errs.append((abs_err([(wk, wp), (hk, hp)]), max(rel_err(wk, wp), rel_err(hk, hp))))
                plan = mod.last_plan
                assert plan == mu_cuda.grid_plan(b, n, l, k, sms), plan
                log(f"{kname}: {iters} iterations at {b}x{n}x{l} k={k}: rel err "
                    f"{errs[-1][1]:.3e} (bar 1e-3); plan {plan.blocks} blocks a fit of "
                    f"{plan.rows} rows, {'resident' if plan.resident else 'streamed'}")
                assert errs[-1][1] <= 1e-3, f"{kname} fixed iterations disagree"
            ms = cuda_ms(lambda: kern(x, w, h, iters), reps=3)
            plain_ms = cuda_ms(lambda: plain(x, w, h, iters), reps=2)
            log(f"{kname}: {iters} iterations at {b}x{n}x{l} k={k}: kernel {ms:.3f} ms, "
                f"plain f32 {plain_ms:.3f} ms")
            self.record(kname, replaces, (max(e[0] for e in errs), max(e[1] for e in errs),
                                          1e-3),
                        ms, plain_ms, b * iters * nmf_flops(kname[:6], n, l, k),
                        4 * b * (n * l + 2 * (n * k + k * l)), source=kname[:6],
                        shape=f"{b}x{n}x{l}, k={k}", also_replaces=also,
                        **({"block_range": self.small_grid[kname]}
                           if kname in self.small_grid else {}))
        del cases

        # (b) rank sweeps 1-4 with the stop on against float64 (phase 4's
        # method); CD at rank 1 starts at its optimum and stops on rounding
        # noise, so its stopping iteration is exempt
        def envelopes(trials):
            """The default envelope of whole trials, not time-normalised."""
            x = batched.zero_center_batch(torch.from_numpy(trials).to(dev))
            x = batched.linear_envelope_batch(x, critical_freqs=4.0, sampling_frequency=FS,
                                              order=4, zero_center_=False)
            return batched.normalize_batch(x.abs())

        env = envelopes(emg[:2])
        # a subject's 30 gait cycles; two trials' first 20,000 envelope rows
        # side by side as one 16-channel frame
        frames = (xs[:30].reshape(-1, N_CHANNELS),
                  env[:, :20_000].permute(1, 0, 2).reshape(-1, 2 * N_CHANNELS))
        for x in frames:
            label = f"{x.shape[0]:,} x {x.shape[1]}"
            ws, hs = [], []
            for kk in (1, 2, 3, 4):
                w0, h0 = mb.init_batch(x[None], kk)
                ws.append(torch.nn.functional.pad(w0, (0, 4 - kk)))
                hs.append(torch.nn.functional.pad(h0, (0, 0, 0, 4 - kk)))
            gx, gw, gh = x[None].repeat(4, 1, 1).contiguous(), torch.cat(ws), torch.cat(hs)
            gx64, gw64, gh64 = gx.double(), gw.double(), gh.double()
            for kname, (mod, _, _, fit, plain, step, _, _) in entries.items():
                before = mod.cluster_launches
                t0 = time.perf_counter()
                sk = fit(gx, gw, gh, max_iter=500, tol=1e-4)
                torch.cuda.synchronize()
                fit_ms = (time.perf_counter() - t0) * 1e3
                assert mod.cluster_launches == before + 1, f"{kname} took another entry"
                sp = plain(gx64, gw64, gh64, max_iter=500, tol=1e-4)
                gap = (sk.n_iter - sp.n_iter).cpu().numpy()
                held = gap[1:] if kname.startswith("cd") else gap
                hk = sk.h if kname.startswith("mu") else sk.ht.transpose(-1, -2)
                wr, hr = plain_snapshot(step, gx64, gw64, gh64, sk.n_iter)
                err = max(rel_err(sk.w, wr), rel_err(hk, hr))
                log(f"{kname}: ranks 1-4 on {label} at tol 1e-4: n_iter "
                    f"{sk.n_iter.tolist()} (float64 {sp.n_iter.tolist()}), stopping gap "
                    f"median {np.median(held):g}; factor err at the kernel's stop "
                    f"{err:.3e} (bar 1e-3); kernel wall {fit_ms:.2f} ms")
                assert np.median(held) == 0, f"{kname} fit stops elsewhere than float64"
                assert err <= 1e-3, f"{kname} fit disagrees"
        del env

        # (c) the entry points under default arguments
        host = envelopes(emg[:1])[0].cpu().numpy()
        run, counts = self.main_path(
            "find_synergies 124,460x8 ranks 1-4 batched (array core)",
            lambda: select._find_synergies_arrays(host, 1, 4, sweep="batched"))
        assert counts["cd_nmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        self.log_plan("find_synergies 124,460x8", cd_cuda.last_plan,
                      mu_cuda.grid_plan(4, N_SAMPLES, N_CHANNELS, 4, sms))
        vaf = run.vaf_rows[:, 0]
        log(f"find_synergies 124,460x8: VAF by rank {np.round(vaf, 6).tolist()}, n_iter "
            f"{[run.models[k].n_iter_ for k in run.ranks]}")
        assert np.isfinite(run.vaf_rows).all() and (vaf <= 1).all()
        assert (np.diff(vaf) > -1e-6).all(), "VAF falls with rank"

        subject = xs[:30].reshape(-1, N_CHANNELS)  # 30 gait cycles, 6,000 x 8
        got, counts = self.main_path("bootstrap_synergies 6000x8",
                                     lambda: stability.bootstrap_synergies(subject, 4))
        assert counts["mu_nmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        self.log_plan("bootstrap_synergies 6000x8", mu_cuda.last_plan,
                      mu_cuda.grid_plan(51, subject.shape[0], N_CHANNELS, 4, sms))
        t0 = time.perf_counter()
        want = stability.bootstrap_synergies(subject.double(), 4, dtype=torch.float64,
                                             impl="torch")
        gap = float(np.abs(got.similarities - want.similarities).max())
        cos = [float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
               for a, b in zip(got.reference_components, want.reference_components)]
        log(f"bootstrap_synergies 6000x8: float64 plain on the card "
            f"{time.perf_counter() - t0:.2f} s; similarity gap {gap:.3e} (bar 2e-3), "
            f"reference cosines min {min(cos):.6f} (bar 0.999)")
        assert gap <= 2e-3 and min(cos) >= 0.999, "the 6,000 x 8 bootstrap disagrees"

        # the dataset grid at full length: analyze_dataset needs reduce_to
        # (so do the JAX package's, and preprocess_trials), so the batch
        # goes through what it calls, without the time normalisation: the
        # envelope of 4 whole trials (one K3 launch), then ranks 1-4 of
        # every trial as one batch of 16 fits (one K2 launch)
        def full_grid(impl="auto"):
            env = envelopes(emg[:4])
            ws, hs = [], []
            for kk in (1, 2, 3, 4):
                w0, h0 = mb.init_batch(env, kk)
                ws.append(torch.nn.functional.pad(w0, (0, 4 - kk)))
                hs.append(torch.nn.functional.pad(h0, (0, 0, 0, 4 - kk)))
            gx = env.repeat(4, 1, 1)
            st = mb.fit_cd_batch(gx, torch.cat(ws), torch.cat(hs), max_iter=2000,
                                 tol=1e-6, impl=impl)
            vaf, _ = mb.vaf_batch(gx, st.w, st.ht.transpose(-1, -2))
            return vaf.view(4, 4).cpu().numpy(), st.n_iter.view(4, 4).cpu().numpy()

        (vaf, n_iter), counts = self.main_path(
            "dataset grid, 4 full-length trials x ranks 1-4, max_iter 2,000", full_grid)
        assert counts["sosfiltfilt"] == 1 and counts["cd_nmf_cluster"] == 1, counts
        assert sum(counts.values()) == 2, counts
        self.log_plan("dataset grid at full length", cd_cuda.last_plan,
                      mu_cuda.grid_plan(16, N_SAMPLES, N_CHANNELS, 4, sms))
        assert np.isfinite(vaf).all() and (vaf <= 1).all()
        t0 = time.perf_counter()
        plain_vaf, plain_iter = full_grid(impl="torch")
        plain_s = time.perf_counter() - t0
        diff = float(np.abs(plain_vaf - vaf).max())
        log(f"dataset grid at full length: mean VAF by rank "
            f"{np.round(vaf.mean(axis=1), 6).tolist()}, n_iter median by rank "
            f"{np.median(n_iter, axis=1).tolist()} (plain {np.median(plain_iter, axis=1).tolist()}); "
            f"impl='torch' {plain_s:.2f} s, max VAF diff {diff:.3e} (bar 1e-3)  [{self.smi}]")
        assert diff <= 1e-3, "the full-length grid disagrees with impl='torch'"

        # (d) a lone capture-length fit's iteration, and 4 at once, against
        # the plain loop, with the plan each launch took
        nbytes = 4 * (N_SAMPLES * N_CHANNELS + 2 * (N_SAMPLES * 4 + 4 * N_CHANNELS))
        lone = 200
        for b in (1, 4):
            x1, w1, h1 = problem(b, N_SAMPLES, N_CHANNELS, 4)
            for kname, (mod, kern, plain, *_rest) in entries.items():
                us = cuda_ms(lambda: kern(x1, w1, h1, lone), reps=3) / lone * 1e3
                plan = mod.last_plan
                assert plan == mu_cuda.grid_plan(b, N_SAMPLES, N_CHANNELS, 4, sms), plan
                # every SM, not one cluster of at most 16, rows kept in shared memory
                assert plan.resident and plan.blocks * b > 16, plan
                bound_ms, bound_by = bound(
                    b * lone * nmf_flops(kname[:6], N_SAMPLES, N_CHANNELS, 4), b * nbytes)
                label = "lone fit" if b == 1 else f"{b} fits at once"
                if b == 1:
                    plain_us = cuda_ms(lambda: plain(x1, w1, h1, lone), reps=1) / lone * 1e3
                    plain_note = f"plain f32 {plain_us:.2f} us; "
                    self.kernels[kname].update(lone_us_per_iteration=us,
                                               lone_plain_us_per_iteration=plain_us,
                                               lone_bound_us_per_iteration=bound_ms / lone * 1e3)
                else:
                    plain_note = ""
                self.kernels[kname][f"plan_{b}x{N_SAMPLES}x{N_CHANNELS}"] = plan._asdict()
                if b == 4:
                    self.kernels[kname]["four_us_per_iteration"] = us
                log(f"stage {kname} {label} {b}x{N_SAMPLES}x{N_CHANNELS} k=4: {us:.2f} us an "
                    f"iteration ({plain_note}bound {bound_ms / lone * 1e3:.3f} us, {bound_by}); "
                    f"plan {plan.blocks} blocks a fit of {plan.rows} rows, "
                    f"{'resident' if plan.resident else f'streamed in tiles of {plan.tile}'}, "
                    f"{plan.smem} B shared memory a block  [{self.smi}]")
            del x1, w1, h1

    @staticmethod
    def log_plan(label, plan, want):
        """Print a cluster-entry launch's plan, held to its mirror's."""
        log(f"{label}: plan {plan.blocks} blocks a fit of {plan.rows} rows, "
            f"{'resident' if plan.resident else f'streamed in tiles of {plan.tile}'}")
        assert plan == want, (plan, want)

    def large_frames_beta_cnmf(self, emg, xs):
        """Phase 23: frames over one block's shared memory, on the cluster
        entries of K4 (beta-MU) and K5 (cNMF), each fit spread over many
        blocks of the card: fixed iterations and fits against float64, the
        four calls that raised before them under default arguments, and
        a capture-length fit's iteration alone and 4 at once, every plan
        held to its mirror."""
        from muscle_synergies_tpu_torch.models import CNMFModel, select, stability
        from muscle_synergies_tpu_torch.models import batch as mb
        from muscle_synergies_tpu_torch.models import cnmf as mc
        from muscle_synergies_tpu_torch.models.beta import mu_update_beta
        from muscle_synergies_tpu_torch.models.kernels import beta_cuda, cnmf_cuda
        from muscle_synergies_tpu_torch.ops import batched

        torch, dev, rng = self.torch, self.dev, self.rng
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for shape in ((6_000, 8, 4), (20_000, 8, 4), (N_SAMPLES, 8, 8)):
            for beta in (1.0, 0.0, 1.5, -0.5):
                assert beta_cuda.route(*shape, beta) == "cluster", (shape, beta)
        for shape in ((6_000, 8, 4, 10), (N_SAMPLES, 8, 4, 10)):
            assert cnmf_cuda.route(*shape) == "cluster", shape

        def positive(*shape):
            return torch.from_numpy((rng.random(shape) + 0.05).astype(np.float32)).to(dev)

        # (a) 50 fixed iterations against the plain version in float64 at
        # the plans the main paths take: 4 x 6,000 x 8 (a subject), 4 x
        # 124,460 x 8 (K4's sweep resident on 33 blocks a fit, K5's 4
        # restarts of CNMFModel streamed through L2), and a lone 124,460 x 8
        # fit (both resident on every SM), the plan of each logged
        iters = 50
        errs = {"beta_nmf_cluster": [], "cnmf_cluster": []}
        for b, n in ((4, 6_000), (4, N_SAMPLES), (1, N_SAMPLES)):
            x, w, h = positive(b, n, N_CHANNELS), positive(b, n, 4), positive(b, 4, N_CHANNELS)
            for beta in (1.0, 0.0, 1.5, -0.5):
                before = beta_cuda.cluster_launches
                wk, hk = beta_cuda.beta_iterations_cuda(x, w, h, iters, beta)
                assert beta_cuda.cluster_launches == before + 1, "beta_nmf took another entry"
                wp, hp = beta_cuda.beta_iterations_plain(x.double(), w.double(), h.double(),
                                                         iters, beta)
                errs["beta_nmf_cluster"].append((abs_err([(wk, wp), (hk, hp)]),
                                                 max(rel_err(wk, wp), rel_err(hk, hp))))
                log(f"beta_nmf_cluster: {iters} iterations at {b}x{n}x{N_CHANNELS} k=4, "
                    f"beta={beta:g}: rel err {errs['beta_nmf_cluster'][-1][1]:.3e} (bar 1e-3)")
                assert errs["beta_nmf_cluster"][-1][1] <= 1e-3, "beta_nmf_cluster disagrees"
                self.log_plan(f"beta_nmf_cluster {b}x{n}x{N_CHANNELS} beta={beta:g}",
                              beta_cuda.last_plan,
                              beta_cuda.grid_plan(b, n, N_CHANNELS, 4, sms, beta == 1.0))
            c, s = positive(b, n, 4), positive(b, 4, 10, N_CHANNELS)
            before = cnmf_cuda.cluster_launches
            ck, sk = cnmf_cuda.cnmf_iterations_cuda(x, c, s, iters)
            assert cnmf_cuda.cluster_launches == before + 1, "cnmf took another entry"
            cp, sp = cnmf_cuda.cnmf_iterations_plain(x.double(), c.double(), s.double(), iters)
            errs["cnmf_cluster"].append((abs_err([(ck, cp), (sk, sp)]),
                                         max(rel_err(ck, cp), rel_err(sk, sp))))
            log(f"cnmf_cluster: {iters} iterations at {b}x{n}x{N_CHANNELS} K=4 D=10: rel err "
                f"{errs['cnmf_cluster'][-1][1]:.3e} (bar 1e-3)")
            assert errs["cnmf_cluster"][-1][1] <= 1e-3, "cnmf_cluster disagrees"
            self.log_plan(f"cnmf_cluster {b}x{n}x{N_CHANNELS}", cnmf_cuda.last_plan,
                          cnmf_cuda.grid_plan(b, n, N_CHANNELS, 4, 10, sms))
        # timed at the lone capture-length fit: KL for K4, the kind the main
        # paths run
        b, n = x.shape[:2]
        ms = cuda_ms(lambda: beta_cuda.beta_iterations_cuda(x, w, h, iters, 1.0), reps=3)
        plain_ms = cuda_ms(lambda: beta_cuda.beta_iterations_plain(x, w, h, iters, 1.0), reps=1)
        log(f"beta_nmf_cluster: {iters} KL iterations at {b}x{n}x{N_CHANNELS} k=4: kernel "
            f"{ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
        err = errs["beta_nmf_cluster"]
        self.record("beta_nmf_cluster", "muscle_synergies_tpu/models/kernels/beta_pallas.py:231",
                    (max(e[0] for e in err), max(e[1] for e in err), 1e-3), ms, plain_ms,
                    b * iters * nmf_flops("beta_nmf_kl", n, N_CHANNELS, 4),
                    4 * b * (n * N_CHANNELS + 2 * (n * 4 + 4 * N_CHANNELS)),
                    source="beta_nmf", shape=f"{b}x{n}x{N_CHANNELS}, k=4, KL",
                    also_replaces="muscle_synergies_tpu/models/kernels/beta_pallas.py:292",
                    block_range={key.split(" ", 1)[1]: v for key, v in self.small_grid.items()
                                 if key.startswith("beta_nmf_cluster")})
        ms = cuda_ms(lambda: cnmf_cuda.cnmf_iterations_cuda(x, c, s, iters), reps=3)
        plain_ms = cuda_ms(lambda: cnmf_cuda.cnmf_iterations_plain(x, c, s, iters), reps=1)
        log(f"cnmf_cluster: {iters} iterations at {b}x{n}x{N_CHANNELS} K=4 D=10: kernel "
            f"{ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
        err = errs["cnmf_cluster"]
        self.record("cnmf_cluster", "muscle_synergies_tpu/models/kernels/cnmf_pallas.py:147",
                    (max(e[0] for e in err), max(e[1] for e in err), 1e-3), ms, plain_ms,
                    b * iters * nmf_flops("cnmf", n, N_CHANNELS, 4, 10),
                    4 * b * (2 * n * N_CHANNELS + 2 * (n * 4 + 40 * N_CHANNELS)),
                    source="cnmf", shape=f"{b}x{n}x{N_CHANNELS}, K=4, D=10")
        del x, w, h, c, s, wk, hk, wp, hp, ck, sk, cp, sp

        # (b) fits with the stop on against float64 on a subject's 30 gait
        # cycles (6,000 x 8): K4 at ranks 1-4 batched, KL and IS (tol
        # 1e-4); K5 with 4 restarts (tol 1e-3, where its stop fires before
        # max_iter); the bars of phase 7: |median stopping gap| <= 10
        # iterations, factor error at the kernel's own stop <= 2e-3
        subject = xs[:30].reshape(-1, N_CHANNELS).contiguous()
        positive_subject = subject + 1e-3  # IS refuses zeros
        ws, hs = [], []
        for kk in (1, 2, 3, 4):
            w0, h0 = mb.init_batch(positive_subject[None], kk)
            ws.append(torch.nn.functional.pad(w0, (0, 4 - kk)))
            hs.append(torch.nn.functional.pad(h0, (0, 0, 0, 4 - kk)))
        gx = positive_subject[None].repeat(4, 1, 1).contiguous()
        gw, gh = torch.cat(ws), torch.cat(hs)
        gx64, gw64, gh64 = gx.double(), gw.double(), gh.double()
        for beta in (1.0, 0.0):
            before = beta_cuda.cluster_launches
            sk = beta_cuda.fit_beta_cuda(gx, gw, gh, beta, max_iter=500, tol=1e-4)
            assert beta_cuda.cluster_launches == before + 1, "beta_nmf took another entry"
            sp = beta_cuda.fit_beta_plain(gx64, gw64, gh64, beta, max_iter=500, tol=1e-4)
            gap = (sk.n_iter - sp.n_iter).cpu().numpy()
            wr, hr = plain_snapshot(lambda x_, w_, h_: mu_update_beta(x_, w_, h_, beta),
                                    gx64, gw64, gh64, sk.n_iter)
            err = max(rel_err(sk.w, wr), rel_err(sk.h, hr))
            log(f"beta_nmf_cluster: ranks 1-4 on 6,000 x 8 at tol 1e-4, beta={beta:g}: "
                f"n_iter {sk.n_iter.tolist()} (float64 {sp.n_iter.tolist()}); factor err at "
                f"the kernel's stop {err:.3e} (bar 2e-3)")
            assert abs(np.median(gap)) <= 10, "beta_nmf_cluster fit stops far from float64"
            assert err <= 2e-3, "beta_nmf_cluster fit disagrees"
            self.log_plan(f"beta_nmf_cluster ranks 1-4 on 6000x8 beta={beta:g}",
                          beta_cuda.last_plan,
                          beta_cuda.grid_plan(4, gx.shape[1], N_CHANNELS, 4, sms, beta == 1.0))
        c0, s0 = mc.init_cnmf(np.repeat(subject.cpu().numpy()[None], 4, axis=0), 4, 10)
        c0, s0 = (torch.as_tensor(a).to(dev) for a in (c0, s0))
        gx = subject[None].repeat(4, 1, 1).contiguous()
        gx64, c064, s064 = gx.double(), c0.double(), s0.double()
        before = cnmf_cuda.cluster_launches
        sk = cnmf_cuda.fit_cnmf_cuda(gx, c0, s0, max_iter=500, tol=1e-3)
        assert cnmf_cuda.cluster_launches == before + 1, "cnmf took another entry"
        sp = cnmf_cuda.fit_cnmf_plain(gx64, c064, s064, max_iter=500, tol=1e-3)
        gap = (sk.n_iter - sp.n_iter).cpu().numpy()
        cr, sr = plain_snapshot(lambda x_, c_, s_: mc.cnmf_update(x_, c_, s_), gx64, c064,
                                s064, sk.n_iter)
        err = max(rel_err(sk.c, cr), rel_err(sk.s, sr))
        log(f"cnmf_cluster: 4 restarts on 6,000 x 8 at tol 1e-3: n_iter {sk.n_iter.tolist()} "
            f"(float64 {sp.n_iter.tolist()}); factor err at the kernel's stop {err:.3e} "
            f"(bar 2e-3)")
        assert abs(np.median(gap)) <= 10, "cnmf_cluster fit stops far from float64"
        assert err <= 2e-3, "cnmf_cluster fit disagrees"
        self.log_plan("cnmf_cluster 4 restarts on 6000x8", cnmf_cuda.last_plan,
                      cnmf_cuda.grid_plan(4, gx.shape[1], N_CHANNELS, 4, 10, sms))

        # (c) the calls that raised before these entries, under default
        # arguments: each one cluster launch and no other launch
        x = batched.zero_center_batch(torch.from_numpy(emg[:1]).to(dev))
        x = batched.linear_envelope_batch(x, critical_freqs=4.0, sampling_frequency=FS,
                                          order=4, zero_center_=False)
        capture = batched.normalize_batch(x.abs())[0] + 1e-4  # a whole trial, positive
        host = capture.cpu().numpy()
        kl = dict(solver="mu", beta_loss="kullback-leibler")
        model, counts = self.main_path(
            "NMFModel(4, KL).fit on 30 cycles (6000x8)",
            lambda: select.NMFModel(n_components=4, **kl).fit(positive_subject))
        assert counts["beta_nmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        self.log_plan("NMFModel(4, KL) 6000x8", beta_cuda.last_plan,
                      beta_cuda.grid_plan(1, positive_subject.shape[0], N_CHANNELS, 4, sms, True))
        assert np.isfinite(model.components_).all()
        run, counts = self.main_path(
            "find_synergies KL 124,460x8 ranks 1-4 batched (array core)",
            lambda: select._find_synergies_arrays(host, 1, 4, sweep="batched",
                                                  max_iter=2000, **kl))
        assert counts["beta_nmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        self.log_plan("find_synergies KL 124,460x8", beta_cuda.last_plan,
                      beta_cuda.grid_plan(4, N_SAMPLES, N_CHANNELS, 4, sms, True))
        vaf = run.vaf_rows[:, 0]
        log(f"find_synergies KL 124,460x8: VAF by rank {np.round(vaf, 6).tolist()}, n_iter "
            f"{[run.models[k].n_iter_ for k in run.ranks]}")
        assert np.isfinite(run.vaf_rows).all() and (vaf <= 1).all()
        model, counts = self.main_path("CNMFModel(4, 10).fit on a whole trial (124,460x8)",
                                       lambda: CNMFModel(4, 10).fit(capture))
        assert counts["cnmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        self.log_plan("CNMFModel(4, 10) 124,460x8", cnmf_cuda.last_plan,
                      cnmf_cuda.grid_plan(4, N_SAMPLES, N_CHANNELS, 4, 10, sms))
        tvaf = 1.0 - model.reconstruction_err_ ** 2 / float((capture.double() ** 2).sum())
        log(f"CNMFModel(4, 10) on 124,460x8: {model.n_iter_} iterations, restart errors "
            f"{np.round(model.restart_errors_, 4).tolist()}, VAF {tvaf:.6f}")
        assert np.isfinite(model.synergies_).all() and 0.5 < tvaf <= 1.0
        got, counts = self.main_path(
            "bootstrap_time_varying_synergies 6000x8 (30 cycles)",
            lambda: stability.bootstrap_time_varying_synergies(subject, 4, 10, n_boot=10))
        assert counts["cnmf_cluster"] == 1 and sum(counts.values()) == 1, counts
        self.log_plan("bootstrap_time_varying_synergies 6000x8 (the full fit and 10)",
                      cnmf_cuda.last_plan,
                      cnmf_cuda.grid_plan(11, subject.shape[0], N_CHANNELS, 4, 10, sms))
        t0 = time.perf_counter()
        want = stability.bootstrap_time_varying_synergies(subject.double(), 4, 10, n_boot=10,
                                                          dtype=torch.float64, impl="torch")
        gap = float(np.abs(got.similarities - want.similarities).max())
        a, bb = (r.reference_synergies.reshape(4, -1) for r in (got, want))
        cos = (a * bb).sum(1) / np.sqrt((a * a).sum(1) * (bb * bb).sum(1))
        log(f"bootstrap_time_varying_synergies 6000x8: float64 plain on the card "
            f"{time.perf_counter() - t0:.2f} s; similarity gap {gap:.3e} (bar 2e-3), "
            f"reference cosines min {cos.min():.6f} (bar 0.999)")
        assert gap <= 2e-3 and cos.min() >= 0.999, "the 6,000 x 8 convolutive bootstrap disagrees"

        # (d) a lone capture-length fit's iteration, and 4 at once, against
        # the plain loop, with the plan each launch took
        lone = 100
        for b in (1, 4):
            x1, w1, h1 = (positive(b, N_SAMPLES, N_CHANNELS), positive(b, N_SAMPLES, 4),
                          positive(b, 4, N_CHANNELS))
            c1, s1 = positive(b, N_SAMPLES, 4), positive(b, 4, 10, N_CHANNELS)
            runs = [(f"beta_nmf_cluster beta={beta:g}", "beta_nmf_kl" if beta == 1.0 else "beta_nmf",
                     beta_cuda, beta_cuda.grid_plan(b, N_SAMPLES, N_CHANNELS, 4, sms, beta == 1.0),
                     lambda it, bt=beta: beta_cuda.beta_iterations_cuda(x1, w1, h1, it, bt),
                     lambda it, bt=beta: beta_cuda.beta_iterations_plain(x1, w1, h1, it, bt))
                    for beta in (1.0, 0.0, 1.5)]
            runs.append(("cnmf_cluster", "cnmf", cnmf_cuda,
                         cnmf_cuda.grid_plan(b, N_SAMPLES, N_CHANNELS, 4, 10, sms),
                         lambda it: cnmf_cuda.cnmf_iterations_cuda(x1, c1, s1, it),
                         lambda it: cnmf_cuda.cnmf_iterations_plain(x1, c1, s1, it)))
            for label, kind, mod, want, kern, plain in runs:
                us = cuda_ms(lambda: kern(lone), reps=3) / lone * 1e3
                plan = mod.last_plan
                assert plan == want, (label, plan, want)
                d = 10 if kind == "cnmf" else 1
                nbytes = 4 * b * (N_SAMPLES * N_CHANNELS + 2 * (N_SAMPLES * 4 + 4 * d * N_CHANNELS))
                bound_ms, bound_by = bound(
                    b * lone * nmf_flops(kind, N_SAMPLES, N_CHANNELS, 4, d), nbytes)
                name = label.split()[0]
                record = name == "cnmf_cluster" or label.endswith("=1")
                if b == 1:
                    plain_us = cuda_ms(lambda: plain(10), reps=1) / 10 * 1e3
                    plain_note = f"plain f32 {plain_us:.2f} us; "
                    if record:
                        self.kernels[name].update(lone_us_per_iteration=us,
                                                  lone_plain_us_per_iteration=plain_us,
                                                  lone_bound_us_per_iteration=bound_ms / lone * 1e3)
                else:
                    plain_note = ""
                    if record:
                        self.kernels[name]["four_us_per_iteration"] = us
                if record:
                    self.kernels[name][f"plan_{b}x{N_SAMPLES}x{N_CHANNELS}"] = plan._asdict()
                log(f"stage {label} {'lone fit' if b == 1 else f'{b} fits at once'} "
                    f"{b}x{N_SAMPLES}x{N_CHANNELS} k=4: {us:.2f} us an iteration ({plain_note}"
                    f"bound {bound_ms / lone * 1e3:.3f} us, {bound_by}); plan {plan.blocks} "
                    f"blocks a fit of {plan.rows} rows, "
                    f"{'resident' if plan.resident else f'streamed in tiles of {plan.tile}'}, "
                    f"{plan.smem} B shared memory a block  [{self.smi}]")
            del x1, w1, h1, c1, s1

    @staticmethod
    def _cd_step(x_, w_, h_):
        """One CD outer iteration on (X, W, H) in the JAX layouts."""
        from muscle_synergies_tpu_torch.models.hals import cd_pass

        w_, _ = cd_pass(x_, w_, h_.transpose(-1, -2))
        ht, _ = cd_pass(x_.transpose(-1, -2), h_.transpose(-1, -2), w_)
        return w_, ht.transpose(-1, -2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from muscle_synergies_tpu_torch import (
        FilterSpec,
        PipelineConfig,
        _build,
        analyze_dataset,
        analyze_dataset_space_by_time,
        analyze_dataset_time_varying,
    )

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    run_t0 = time.perf_counter()

    # ---- 1. build: one nvcc per source, all started together ----
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports)}")
    for kname, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"  ptxas {kname}: {line.strip()}")

    smoke = Smoke(dev, smi)
    smoke.filter_phase()                                     # 2
    smoke.nmf_phases()                                       # 3, 4
    smoke.beta_phases()                                      # 6, 7
    smoke.cnmf_phases()                                      # 8
    t0 = time.perf_counter()
    smoke.causal_filter_phase()                              # 11
    smoke.stage("phase 11 (K6 alone)", time.perf_counter() - t0)

    t0 = time.perf_counter()
    emg = synthetic_emg(MAIN_TRIALS, seed=2)
    log(f"main: synthetic data {emg.shape} float32 ({emg.nbytes / 2**30:.2f} GiB) "
        f"made in {time.perf_counter() - t0:.1f} s")
    # first calls load cuSOLVER/cuBLAS and the kernels; keep that apart
    t0 = time.perf_counter()
    for solver, loss in (("cd", "frobenius"), ("mu", "frobenius"),
                         ("mu", "kullback-leibler")):
        analyze_dataset(emg[:2, :4000], FS, ranks=(1, 2), solver=solver,
                        beta_loss=loss, max_iter=100)
    for config in (PipelineConfig(envelope=FilterSpec(zero_lag=False)),
                   PipelineConfig(use_rms=True)):
        analyze_dataset(emg[:2, :4000], FS, ranks=(1, 2), config=config,
                        max_iter=100)
    analyze_dataset_time_varying(emg[:2, :4000], FS, n_synergies=2, n_lags=5,
                                 n_inits=2, max_iter=100)
    analyze_dataset_space_by_time(emg[:2, :4000], FS, n_temporal=2, n_spatial=2,
                                  n_inits=2, max_iter=100)
    smoke.stage("cold start (first calls of each path, 2 small trials)",
                time.perf_counter() - t0)
    smoke.frobenius_main(emg)                                # 5
    smoke.kl_main(emg)                                       # 9
    smoke.time_varying_main(emg)                             # 10
    for label, phase in (("12 (causal main path)", smoke.causal_main),
                         ("13 (RMS main path)", smoke.rms_main),
                         ("14 (per-capture API)", smoke.per_capture_api)):
        t0 = time.perf_counter()
        phase(emg)                                           # 12, 13, 14
        smoke.stage(f"phase {label}", time.perf_counter() - t0)
    smoke.stage_breakdown(emg)
    t0 = time.perf_counter()
    xs = smoke.space_by_time_main(emg)                       # 16
    smoke.stage("phase 16 (space-by-time dataset path)", time.perf_counter() - t0)
    t0 = time.perf_counter()
    models = smoke.per_capture_models(xs)                    # 17
    smoke.stage("phase 17 (per-capture convolutive and space-by-time models)",
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    smoke.stability_phase(xs, emg)                           # 18
    smoke.stage("phase 18 (stability, held-out rank selection, group level)",
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    smoke.serving_phase(xs, *models)                         # 19
    smoke.stage("phase 19 (resume, persistence, export, profiling)",
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    smoke.mesh_phase(emg, xs)                                # 21
    smoke.stage("phase 21 (device mesh: NCCL at world size 1)", time.perf_counter() - t0)
    import torch.distributed as dist

    dist.destroy_process_group()
    t0 = time.perf_counter()
    smoke.large_frames(emg, xs)                              # 22
    smoke.stage("phase 22 (large frames: K1's and K2's cluster entries)",
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    smoke.large_frames_beta_cnmf(emg, xs)                    # 23
    smoke.stage("phase 23 (large frames: K4's and K5's cluster entries)",
                time.perf_counter() - t0)
    del emg, xs
    smoke.capture_main(then=smoke.pipeline_cli_phase)        # 15, 20
    smoke.stage("whole script", time.perf_counter() - run_t0)

    for kname, entry in smoke.kernels.items():
        entry["launches"] = smoke.launches[kname]
    assert set(smoke.kernels) == set(smoke.launches)
    assert all(v > 0 for v in smoke.launches.values()), smoke.launches
    print(json.dumps({"kernels": [{"name": k, **v} for k, v in smoke.kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
