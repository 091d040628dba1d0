#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 17 and 19 alone on one card.

Phase 19 (resume, persistence, export and profiling) needs phase 17's
fitted ``CNMFModel`` and ``NM3FModel``; this script builds the kernels,
preprocesses ``N_TRIALS`` synthetic full-length trials (80 by default,
so the ``2,400 x 8`` subject is their first 12 cycles, as in the whole
script), runs phase 17 and then phase 19, and prints each stage's time
beside the card's name and power limit.  It is the quick way to check
the phase on the card after a change to it: about two minutes, against
about ten for the whole script.  From the repository root::

    python3 scripts/torch_phase19.py [N_TRIALS]

Without a CUDA card it exits with code 2 and runs nothing.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_phase19: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_synergies_tpu_torch import PipelineConfig, _build, preprocess_trials

    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    xs = preprocess_trials(cs.synthetic_emg(n_trials, seed=2), cs.FS, PipelineConfig())
    smoke = cs.Smoke(torch.device("cuda", 0), smi)
    t0 = time.perf_counter()
    models = smoke.per_capture_models(xs)
    smoke.stage("phase 17 (per-capture convolutive and space-by-time models)",
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    smoke.serving_phase(xs, *models)
    smoke.stage("phase 19 (resume, persistence, export, profiling)",
                time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
