#!/usr/bin/env python3
"""Split an iteration of K1's cluster entry into its phases on one card.

Copies the package to ``build/grid_profile/`` (git-ignored), adds
``clock64()`` marks to the copy's grid entry (``csrc/nmf_common.cuh``,
``csrc/mu_nmf.cu``): thread 0 of block 0 adds the cycles since the last
mark to one counter a phase, in order: the loop and the partial set's
zeroing, H H^T, the W pass, the Gram pass, writing the block's set, the
fit's barrier, reading and adding the P sets, the H update.  It builds
the copy, runs 1,000 fixed iterations of each case and prints one JSON
line a case: the cycles an iteration of each phase on block 0, their
sum, the microseconds an iteration (CUDA events) and the plan, beside
the card's name and power limit.  K2's cluster entry shares every phase
but its W pass.  The marks cost a few cycles each; the repository's
sources are not touched::

    python3 scripts/torch_grid_profile.py

Without a CUDA card it exits with code 2 and runs nothing.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "grid_profile")
CASES = [(1, 124_460, 8, 4), (4, 124_460, 8, 4), (1, 20_000, 8, 4), (1, 124_460, 8, 8)]
PHASES = ["loop and zeroing", "H H^T", "W pass", "Gram pass", "set written",
          "barrier", "sets read and added", "H update"]

MARKS = """__device__ unsigned long long nmf_prof[16];
__device__ unsigned long long nmf_prof_last;
__device__ __forceinline__ void nmf_mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long t = clock64();
    nmf_prof[i] += t - nmf_prof_last;
    nmf_prof_last = t;
  }
}
"""

READER = """
extern "C" int mu_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, nmf_prof, sizeof(unsigned long long) * 16);
  const unsigned long long zero[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nmf_prof, zero, sizeof(zero));
  return (int)e;
}
"""


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old[:60]!r}")
    return text.replace(old, new)


def marked_copy(dst: str = COPY) -> str:
    """Copy the package to ``dst`` and add the phase marks; returns ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "muscle_synergies_tpu_torch"),
                    os.path.join(dst, "muscle_synergies_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "muscle_synergies_tpu_torch", "csrc")
    path = os.path.join(csrc, "nmf_common.cuh")
    s = open(path).read()
    s = _patch(s, "#define NMF_GRID_THREADS ", MARKS + "#define NMF_GRID_THREADS ")
    barrier = "    nmf_grid_barrier(g.counter, syncs * g.blocks);\n"
    s = _patch(s, "    syncs += 1;\n" + barrier,
               "    syncs += 1;\n    nmf_mark(4);\n" + barrier + "    nmf_mark(5);\n")
    s = _patch(s, "  __syncthreads();\n  return g.bpart[g.nq];\n}",
               "  __syncthreads();\n  nmf_mark(6);\n  return g.bpart[g.nq];\n}")
    open(path, "w").write(s)
    path = os.path.join(csrc, "mu_nmf.cu")
    s = open(path).read()
    zero = "  for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) g.bpart[q] = 0.0f;\n"
    chunks = "  nmf_grid_chunks<true>(g, xf, wf, [&](const NmfGridRows& c) {\n"
    w_pass = "    nmf_grid_w_pass<KMAX>(b, c, MuClusterRows<KMAX>{inner_iter, pen});\n"
    s = _patch(s, zero + "  nmf_hht(b);  // its closing barrier also orders the zeroing\n"
               + chunks + w_pass + "    nmf_grid_gram_pass(g, c);\n",
               "  nmf_mark(0);\n" + zero + "  nmf_hht(b);\n  nmf_mark(1);\n" + chunks
               + w_pass + "    __syncthreads();\n    nmf_mark(2);\n"
               "    nmf_grid_gram_pass(g, c);\n    nmf_mark(3);\n")
    s = _patch(s, "  mu_cluster_cols<KMAX>(b, inner_iter, pen);\n}",
               "  mu_cluster_cols<KMAX>(b, inner_iter, pen);\n  nmf_mark(7);\n}")
    s = _patch(s, "  unsigned syncs = 0;\n  int parity = 0;\n  if (WITH_STOP) {\n"
                  "    // sklearn's loop, as the block entry runs it",
               "  if (blockIdx.x == 0 && threadIdx.x == 0) nmf_prof_last = clock64();\n"
               "  unsigned syncs = 0;\n  int parity = 0;\n  if (WITH_STOP) {\n"
               "    // sklearn's loop, as the block entry runs it")
    open(path, "w").write(s + READER)
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_grid_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, marked_copy())
    import muscle_synergies_tpu_torch as pkg
    from muscle_synergies_tpu_torch import _build
    from muscle_synergies_tpu_torch.models.kernels import mu_cuda

    assert os.path.abspath(pkg.__file__).startswith(COPY)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    lib = _build.load("mu_nmf")
    lib.mu_prof_read.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    iters = 1000
    for b, n, l, k in CASES:
        x, w, h = (torch.tensor(rng.random(shape), dtype=torch.float32, device=dev)
                   for shape in ((b, n, l), (b, n, k), (b, k, l)))
        mu_cuda.mu_iterations_cuda(x, w, h, 10)
        torch.cuda.synchronize()
        assert lib.mu_prof_read(counts) == 0
        events[0].record()
        mu_cuda.mu_iterations_cuda(x, w, h, iters)
        events[1].record()
        torch.cuda.synchronize()
        assert lib.mu_prof_read(counts) == 0
        cycles = {p: counts[i] / iters for i, p in enumerate(PHASES)}
        us = events[0].elapsed_time(events[1]) / iters * 1e3
        print(json.dumps({"shape": f"{b}x{n}x{l}", "k": k, "us_per_iteration": us,
                          "cycles_per_iteration_block0": cycles,
                          "cycles_total": sum(cycles.values()),
                          "plan": mu_cuda.last_plan._asdict(), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
