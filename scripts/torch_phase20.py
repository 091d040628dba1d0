#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 15 and 20 alone on one card.

Phase 20 (the pipelined dataset path, its overlap, and the command line
in-process and as a subprocess) runs on phase 15's 16 written captures;
this script builds the kernels, warms the dataset path once, runs phase
15 and then phase 20, and prints each stage's time beside the card's
name and power limit.  It is the quick way to check the phase on the
card after a change to it: about two minutes, against about ten for the
whole script.  From the repository root::

    python3 scripts/torch_phase20.py

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
        print("torch_phase20: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_synergies_tpu_torch import _build, analyze_dataset

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
    smoke.capture_main(then=smoke.pipeline_cli_phase)
    return 0


if __name__ == "__main__":
    sys.exit(main())
