#!/usr/bin/env python3
"""Split an iteration of the grid entries of K1, K4 and K5 into their phases on one card.

Copies the package to ``build/grid_profile/`` (git-ignored) and adds
``clock64()`` marks to the copy's cluster entries (the grid entries of
``csrc/nmf_common.cuh``, ``csrc/mu_nmf.cu``, ``csrc/beta_nmf.cu`` and
``csrc/cnmf.cu``): thread 0 of block 0 adds the cycles since the last
mark to one counter a phase.  The phases, in order:

- K1 (MU): the loop and the partial set's zeroing, H H^T, the W pass,
  the Gram pass, writing the block's set, the fit's barrier, reading
  and adding the P sets, the H update (K2 shares all but its W pass);
- K4 (beta-MU): the loop, the zeroing and KL's row sums of H, the W pass
  with the first tile of the weights' sums, the other tiles, writing
  the set, the barrier, reading and adding the P sets, the H update;
- K5 (cNMF): the loop, the halo (the owners' flags waited for and the
  rows read), the tiles' loads and carried rows, the reconstruction of
  the S pass, the S sums, writing the set, the barrier, reading and
  adding the P sets, the S update, the reconstruction of the C pass, the
  C update, the edges' flag.

It builds the copy, runs fixed iterations of each case and prints one
JSON line a case: the cycles an iteration of each phase on block 0,
their sum, the microseconds an iteration (CUDA events) and the plan,
beside the card's name and power limit.  The marks cost a few cycles
each; the repository's sources are not touched::

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
CAPTURE = 124_460
# (kernel, batch, rows, channels, rank, beta or lags)
CASES = [("mu", 1, CAPTURE, 8, 4, None), ("mu", 4, CAPTURE, 8, 4, None),
         ("mu", 1, 20_000, 8, 4, None), ("mu", 1, CAPTURE, 8, 8, None),
         ("beta", 1, CAPTURE, 8, 4, 1.0), ("beta", 1, CAPTURE, 8, 4, 0.0),
         ("beta", 1, CAPTURE, 8, 4, 1.5), ("beta", 4, CAPTURE, 8, 4, 1.0),
         ("cnmf", 1, CAPTURE, 8, 4, 10), ("cnmf", 4, CAPTURE, 8, 4, 10)]
PHASES = {
    "mu": ["loop and zeroing", "H H^T", "W pass", "Gram pass", "set written", "barrier",
           "sets read and added", "H update"],
    "beta": ["loop", "zeroing and row sums", "W pass and tile 0", "other tiles",
             "set written", "barrier", "sets read and added", "H update"],
    "cnmf": ["loop", "halo", "tile loads and carries", "reconstruct (S pass)", "S sums",
             "set written", "barrier", "sets read and added", "S update",
             "reconstruct (C pass)", "C update", "edges' flag"],
}

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
extern "C" int {name}_prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, nmf_prof, sizeof(unsigned long long) * 16);
  const unsigned long long zero[16] = {{0}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nmf_prof, zero, sizeof(zero));
  return (int)e;
}}
"""
START = "  if (blockIdx.x == 0 && threadIdx.x == 0) nmf_prof_last = clock64();\n"


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old[:60]!r}")
    return text.replace(old, new)


def _mu(s: str) -> str:
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
    return _patch(s, "  unsigned syncs = 0;\n  int parity = 0;\n  if (WITH_STOP) {\n"
                     "    // sklearn's loop, as the block entry runs it",
                  START + "  unsigned syncs = 0;\n  int parity = 0;\n  if (WITH_STOP) {\n"
                  "    // sklearn's loop, as the block entry runs it")


def _beta(s: str) -> str:
    s = _patch(s, "  const NmfGrid& g = bg.g;\n  for (int q = threadIdx.x; q < g.nq; q += blockDim.x)"
                  " g.bpart[q] = 0.0f;\n",
               "  const NmfGrid& g = bg.g;\n  nmf_mark(0);\n"
               "  for (int q = threadIdx.x; q < g.nq; q += blockDim.x) g.bpart[q] = 0.0f;\n")
    s = _patch(s, "    __syncthreads();\n  }\n  const int tiles = g.nq / 64;\n",
               "    __syncthreads();\n  }\n  nmf_mark(1);\n  const int tiles = g.nq / 64;\n")
    s = _patch(s, "    beta_grid_w_pass<KIND, KMAX>(bg, c);\n"
                  "    for (int t = 1; t < tiles; ++t) beta_grid_tile_pass<KIND, KMAX>(bg, c, t);\n",
               "    beta_grid_w_pass<KIND, KMAX>(bg, c);\n    nmf_mark(2);\n"
               "    for (int t = 1; t < tiles; ++t) beta_grid_tile_pass<KIND, KMAX>(bg, c, t);\n"
               "    nmf_mark(3);\n")
    barrier = "    nmf_grid_barrier(g.counter, syncs * g.blocks);\n    for (int q = threadIdx.x;"
    s = _patch(s, "    syncs += 1;\n" + barrier,
               "    syncs += 1;\n    nmf_mark(4);\n" + barrier.replace(
                   "    for", "    nmf_mark(5);\n    for"))
    s = _patch(s, "  beta_grid_sum<KIND>(bg, parity, syncs);\n"
                  "  beta_update_h<KIND>(g.b, bg.nd, bg.beta, bg.gamma, bg.pen);\n}",
               "  beta_grid_sum<KIND>(bg, parity, syncs);\n  nmf_mark(6);\n"
               "  beta_update_h<KIND>(g.b, bg.nd, bg.beta, bg.gamma, bg.pen);\n"
               "  nmf_mark(7);\n}")
    return _patch(s, "  unsigned syncs = 0;\n  int parity = 0;\n  // sklearn's loop",
                  START + "  unsigned syncs = 0;\n  int parity = 0;\n  // sklearn's loop")


def _cnmf(s: str) -> str:
    s = _patch(s, "  for (int i = threadIdx.x; i < cg.nq; i += blockDim.x) cg.bpart[i] = 0.0f;\n"
                  "  cnmf_grid_halo(cg, parity, ver);  // its barriers also order the zeroing\n",
               "  nmf_mark(0);\n"
               "  for (int i = threadIdx.x; i < cg.nq; i += blockDim.x) cg.bpart[i] = 0.0f;\n"
               "  cnmf_grid_halo(cg, parity, ver);\n  nmf_mark(1);\n")
    s = _patch(s, "    cnmf_grid_tile(cg, xf, cf, a, n + cg.h1, n);\n    cnmf_grid_reconstruct(cg, n);\n"
                  "    cnmf_grid_s_sums(cg, n);\n    if (!cg.resident) cnmf_grid_carry(cg, n);\n",
               "    cnmf_grid_tile(cg, xf, cf, a, n + cg.h1, n);\n    nmf_mark(2);\n"
               "    cnmf_grid_reconstruct(cg, n);\n    nmf_mark(3);\n"
               "    cnmf_grid_s_sums(cg, n);\n    nmf_mark(4);\n"
               "    if (!cg.resident) cnmf_grid_carry(cg, n);\n    nmf_mark(2);\n")
    barrier = "    nmf_grid_barrier(cg.counter, syncs * cg.blocks);\n    for (int q = threadIdx.x;"
    s = _patch(s, "    syncs += 1;\n" + barrier,
               "    syncs += 1;\n    nmf_mark(5);\n" + barrier.replace(
                   "    for", "    nmf_mark(6);\n    for"))
    s = _patch(s, "      own[q] = cnmf_grid_sum4(sets + 4 * q, cg.blocks, cg.pstride);\n"
                  "    }\n    __syncthreads();\n  }\n",
               "      own[q] = cnmf_grid_sum4(sets + 4 * q, cg.blocks, cg.pstride);\n"
               "    }\n    __syncthreads();\n  }\n  nmf_mark(7);\n")
    s = _patch(s, "  cnmf_grid_update_s(cg, parity, syncs);\n",
               "  cnmf_grid_update_s(cg, parity, syncs);\n  nmf_mark(8);\n")
    s = _patch(s, "    cnmf_grid_tile(cg, xf, cf, a, n + 2 * cg.h1, n + cg.h1);\n"
                  "    cnmf_grid_reconstruct(cg, n + cg.h1);\n",
               "    cnmf_grid_tile(cg, xf, cf, a, n + 2 * cg.h1, n + cg.h1);\n    nmf_mark(2);\n"
               "    cnmf_grid_reconstruct(cg, n + cg.h1);\n    nmf_mark(9);\n")
    s = _patch(s, "    cnmf_grid_update_c(cg, cf, a, n, parity ^ 1);\n  }\n",
               "    cnmf_grid_update_c(cg, cf, a, n, parity ^ 1);\n    nmf_mark(10);\n  }\n")
    s = _patch(s, "  ver += 1;\n  cnmf_grid_publish(cg, ver);\n}",
               "  ver += 1;\n  cnmf_grid_publish(cg, ver);\n  nmf_mark(11);\n}")
    return _patch(s, "  unsigned ver = 1, syncs = 0;\n  cnmf_grid_publish(cg, ver);\n",
                  "  unsigned ver = 1, syncs = 0;\n  cnmf_grid_publish(cg, ver);\n" + START)


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
    s = _patch(s, "    syncs += 1;\n" + barrier + "    for (int q = threadIdx.x; q <= g.nq;",
               "    syncs += 1;\n    nmf_mark(4);\n" + barrier + "    nmf_mark(5);\n"
               "    for (int q = threadIdx.x; q <= g.nq;")
    s = _patch(s, "  __syncthreads();\n  return g.bpart[g.nq];\n}",
               "  __syncthreads();\n  nmf_mark(6);\n  return g.bpart[g.nq];\n}")
    open(path, "w").write(s)
    for name, patch in (("mu_nmf", _mu), ("beta_nmf", _beta), ("cnmf", _cnmf)):
        path = os.path.join(csrc, f"{name}.cu")
        s = patch(open(path).read())
        open(path, "w").write(s + READER.format(name=name.split("_")[0]))
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_grid_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, marked_copy())
    import muscle_synergies_tpu_torch as pkg
    from muscle_synergies_tpu_torch import _build
    from muscle_synergies_tpu_torch.models.kernels import beta_cuda, cnmf_cuda, mu_cuda

    assert os.path.abspath(pkg.__file__).startswith(COPY)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    _build.build_all(("mu_nmf", "beta_nmf", "cnmf"))
    readers = {}
    for name in ("mu_nmf", "beta_nmf", "cnmf"):
        short = name.split("_")[0]
        fn = getattr(_build.load(name), f"{short}_prof_read")
        fn.argtypes = [ctypes.c_void_p]
        readers[short] = fn
    counts = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for kind, b, n, l, k, extra in CASES:
        x = torch.tensor(rng.random((b, n, l)) + 0.05, dtype=torch.float32, device=dev)
        if kind == "cnmf":
            mod, iters = cnmf_cuda, 200
            c = torch.tensor(rng.random((b, n, k)), dtype=torch.float32, device=dev)
            s = torch.tensor(rng.random((b, k, extra, l)), dtype=torch.float32, device=dev)

            def call(it):
                return cnmf_cuda.cnmf_iterations_cuda(x, c, s, it)
        else:
            mod, iters = (mu_cuda, 1000) if kind == "mu" else (beta_cuda, 500)
            w = torch.tensor(rng.random((b, n, k)), dtype=torch.float32, device=dev)
            h = torch.tensor(rng.random((b, k, l)), dtype=torch.float32, device=dev)

            def call(it):
                if kind == "mu":
                    return mu_cuda.mu_iterations_cuda(x, w, h, it)
                return beta_cuda.beta_iterations_cuda(x, w, h, it, extra)
        call(10)
        torch.cuda.synchronize()
        assert readers[kind](counts) == 0
        events[0].record()
        call(iters)
        events[1].record()
        torch.cuda.synchronize()
        assert readers[kind](counts) == 0
        cycles = {p: counts[i] / iters for i, p in enumerate(PHASES[kind])}
        us = events[0].elapsed_time(events[1]) / iters * 1e3
        line = {"kernel": kind, "shape": f"{b}x{n}x{l}", "k": k, "us_per_iteration": us,
                "cycles_per_iteration_block0": cycles, "cycles_total": sum(cycles.values()),
                "plan": mod.last_plan._asdict(), "card": smi}
        if kind == "beta":
            line["beta"] = extra
        elif kind == "cnmf":
            line["d"] = extra
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
