#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 21 (the device mesh) alone on one card.

Phase 21 holds the meshed paths against phase 5's kernel path and phase
18's stability results; this script builds the kernels, warms the
dataset path once, runs phase 5's MU and CD main paths and phase 18's
``bootstrap_synergies`` / ``cv_rank_selection`` on the card (without
their plain and float64 checks), then phase 21, and prints each stage's
time beside the card's name and power limit.  About three minutes,
against about thirteen for the whole script.  From the repository root::

    python3 scripts/torch_phase21.py

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
        print("torch_phase21: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_synergies_tpu_torch import _build, analyze_dataset, preprocess_trials
    from muscle_synergies_tpu_torch.models import stability

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)  # first calls load cuSOLVER/cuBLAS and the kernels
    analyze_dataset([rng.standard_normal((4000 + 10 * i, 8)) for i in range(2)], cs.FS,
                    ranks=(1, 2), max_iter=100)
    smoke = cs.Smoke(torch.device("cuda", 0), smi)
    emg = cs.synthetic_emg(cs.MAIN_TRIALS, seed=2)
    for solver in ("cd", "mu"):
        res, _ = smoke.main_path(f"analyze_dataset solver={solver}",
                                 lambda: analyze_dataset(emg, cs.FS, solver=solver))
        smoke.phase5[solver] = (res, smoke.last_seconds)
    xs = preprocess_trials(emg, cs.FS)
    subject = xs[:12].reshape(-1, cs.N_CHANNELS)
    smoke.phase18["bootstrap_synergies"] = stability.bootstrap_synergies(subject, 4)
    smoke.phase18["cv_rank_selection"] = stability.cv_rank_selection(subject,
                                                                     range(1, 9))
    t0 = time.perf_counter()
    smoke.mesh_phase(emg, xs)
    smoke.stage("phase 21 (device mesh: NCCL at world size 1)", time.perf_counter() - t0)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
