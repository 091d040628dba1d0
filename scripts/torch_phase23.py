#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 23 (large frames on K4 and K5) alone on one card.

Phase 23 fits beta-divergence and convolutive frames over one block's
shared memory on the cluster entries of K4 and K5.  This script builds
the kernels, warms the dataset path once, makes 32 of the script's
synthetic trials (the first 32 of its 256), preprocesses them and runs
phase 23 on them, and prints each stage's time beside the card's name
and power limit, then the two cluster entries' records.  About two
minutes, against about fifteen for the whole script.  From the
repository root::

    python3 scripts/torch_phase23.py

Without a CUDA card it exits with code 2 and runs nothing.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_phase23: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_synergies_tpu_torch import _build, analyze_dataset, preprocess_trials

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
    emg = cs.synthetic_emg(32, seed=2)
    xs = preprocess_trials(emg, cs.FS)
    t0 = time.perf_counter()
    smoke.large_frames_beta_cnmf(emg, xs)
    smoke.stage("phase 23 (large frames: K4's and K5's cluster entries)",
                time.perf_counter() - t0)
    for name in ("beta_nmf_cluster", "cnmf_cluster"):
        entry = dict(smoke.kernels[name], launches=smoke.launches[name])
        entry.pop("library_note", None)
        print(json.dumps({name: entry}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
