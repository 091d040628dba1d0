#!/usr/bin/env python3
"""Where an iteration of the sharded solvers' plain loops goes, on one card.

On a ``(1, 1)`` NCCL mesh (the one-card machine's only mesh) this times,
at 1,024 fits of 200 x 8 and rank 4 in float32: ``sharded_fit_mu`` and
``sharded_fit_cd`` against the unsharded plain loops they follow
(``models.mu.fit_mu``, ``models.hals.fit_cd``) at fixed iterations, the
one-process ``all_reduce`` alone, a ``torch.profiler`` table of a short
window of each sharded loop, and the MU solve of chip_smoke's phase-5
grid (1,024 fits at ``tol`` 1e-6) sharded and plain, chunk by chunk.  From the repository root::

    python3 scripts/torch_mesh_profile.py

Without a CUDA card it exits with code 2 and runs nothing.
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from muscle_synergies_tpu_torch import parallel
    from muscle_synergies_tpu_torch.models.hals import fit_cd
    from muscle_synergies_tpu_torch.models.mu import fit_mu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    parallel.init_distributed()
    mesh = parallel.make_mesh((1, 1))
    g = torch.Generator(device="cuda").manual_seed(0)
    x, w, h = (torch.rand(s, device="cuda", generator=g) for s in
               ((1024, 200, 8), (1024, 200, 4), (1024, 4, 8)))

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps

    for label, sharded, plain, iters in (
            ("MU", lambda n: parallel.sharded_fit_mu(x, w, h, mesh, max_iter=n, tol=0.0),
             lambda n: fit_mu(x, w, h, max_iter=n, tol=0.0), 200),
            ("CD", lambda n: parallel.sharded_fit_cd(x, w, h, mesh, max_iter=n, tol=0.0),
             lambda n: fit_cd(x, w, h, max_iter=n, tol=0.0), 100)):
        s_t, p_t = wall(lambda: sharded(iters)), wall(lambda: plain(iters))
        print(f"{label}: sharded {s_t / iters * 1e6:.1f} us an iteration, the plain "
              f"loop {p_t / iters * 1e6:.1f} us, {iters} iterations of 1,024 fits "
              f"[{smi}]", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sharded(20)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=14),
              flush=True)

    # the grid of chip_smoke phase 5 / 21 (ranks 1-4 of 256 preprocessed
    # trials, NNDSVDA, tol 1e-6): the whole solve, chunk by chunk
    import chip_smoke as cs
    from muscle_synergies_tpu_torch import preprocess_trials
    from muscle_synergies_tpu_torch.models import batch as mb
    from muscle_synergies_tpu_torch.models import mu as mu_mod

    xs = preprocess_trials(cs.synthetic_emg(cs.MAIN_TRIALS, seed=2), cs.FS)
    ws, hs = [], []
    for k in (1, 2, 3, 4):
        w0, h0 = mb.init_batch(xs, k)
        ws.append(torch.nn.functional.pad(w0, (0, 4 - k)))
        hs.append(torch.nn.functional.pad(h0, (0, 0, 0, 4 - k)))
    gx, gw, gh = xs.repeat(4, 1, 1), torch.cat(ws), torch.cat(hs)
    chunks = []
    original = mu_mod.fit_chunked

    def traced(x, w0, h0, step, error, *args, **kw):
        def timed_error(*a):
            torch.cuda.synchronize()
            chunks.append((time.perf_counter(), a[0].shape[0]))
            return error(*a)
        return original(x, w0, h0, step, timed_error, *args, **kw)

    for label, run in (
            ("sharded_fit_mu", lambda: parallel.sharded_fit_mu(gx, gw, gh, mesh,
                                                               max_iter=100_000,
                                                               tol=1e-6)),
            ("fit_mu (plain)", lambda: fit_mu(gx, gw, gh, max_iter=100_000, tol=1e-6))):
        import muscle_synergies_tpu_torch.parallel.nmf as pnmf
        chunks.clear()
        mu_mod.fit_chunked = pnmf.fit_chunked = traced
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        mu_mod.fit_chunked = pnmf.fit_chunked = original
        n_iter = parallel._spmd.full(st.n_iter)
        marks = [c[0] for c in chunks]
        gaps = np.diff(marks) * 1e3
        sizes = [c[1] for c in chunks]
        print(f"{label} on the phase-5 grid: {total:.3f} s, n_iter max "
              f"{int(n_iter.max())}, {len(chunks)} checks; ms a chunk: first 5 "
              f"{np.round(gaps[:5], 2).tolist()}, median {np.median(gaps):.2f}, "
              f"last 5 {np.round(gaps[-5:], 2).tolist()}; fits active: first "
              f"{sizes[:3]}, last {sizes[-3:]} [{smi}]", flush=True)

    group = mesh.get_group(1)
    for shape in ((1024, 4, 8), (1024,)):
        y = torch.rand(shape, device="cuda")
        for sync in (False, True):
            def reduce():
                for _ in range(200):
                    out = y.clone()
                    dist.all_reduce(out, group=group)
                    if sync:
                        torch.cuda.synchronize()
            t = wall(reduce, reps=2)
            print(f"all_reduce {shape}{' + synchronize' if sync else ''}: "
                  f"{t / 200 * 1e6:.1f} us each [{smi}]", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
