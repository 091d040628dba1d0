#!/usr/bin/env python3
"""Split an iteration of the warp entries of K1, K2 and K4 (KL) into their phases on one card.

The warp entries (``csrc/mu_nmf.cu``, ``csrc/cd_nmf.cu``,
``csrc/beta_nmf.cu``: one warp a fit, its rows in registers) set the
tail of the main paths: a path's longest fit runs alone on one warp for
thousands of iterations.  This script copies the kernels' sources (from
the repository, or from ``--root``, an unpacked ``git archive`` of
another commit) to ``build/warp_profile/<label>/`` (git-ignored) and
adds ``clock64()`` marks to the copy's warp entries: lane 0 of the first
fit adds the cycles since the last mark to one counter a phase, in
shared memory, flushed to device memory when the fit ends.  The phases,
in order:

- K2 (CD): the stop and the loop, H H^T, X H^T and the W cyclic loop,
  the W^T W / W^T X partial sums, the reduce-scatter, the H pass, the
  violation's warp sum;
- K1 (MU): the loop, H H^T, X H^T and the W update, the partial sums,
  the butterflies, the H update, the error (every 10th iteration);
- K4 (KL): the loop, the W pass (H's row sums, W H, the update), W H
  rebuilt and the weights' partial sums, the butterflies, W's column
  sums, the H update, the divergence (every 10th iteration).

It builds the marked copy and the same sources unmarked (one ``nvcc``
each, all started together), prints the unmarked warp kernels'
registers and spills (``-Xptxas -v``) and, where ``cuobjdump`` is
found, a count of their SASS instructions by kind.  Then on the main
path's frames (``chip_smoke.py``'s synthetic trials, preprocessed under
the default ``PipelineConfig``; 16 trials, ranks 1-4 zero-padded to 4,
as ``rank_sweep_batch`` pads them) it finds each kernel's longest rank-1
and rank-4 fit and runs it alone, with the path's stop (tol 1e-6,
max_iter 100,000): unmarked (CUDA events, best of 3) and marked. K2's
rank-1 fit also runs launched at k = 1, and on the marked copy both
launches must return the same bits.  One JSON line a case: iterations,
us an iteration, cycles an iteration of each phase on the fit's warp and
their sum, beside the card's name and power limit::

    python3 scripts/torch_warp_profile.py [--root DIR] [--label NAME]

Without a CUDA card it exits with code 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KERNELS = ("cd_nmf", "mu_nmf", "beta_nmf")
PHASES = {
    "cd_nmf": ["stop and loop", "H H^T", "X H^T and W cyclic loop", "partial sums",
               "reduce-scatter", "H pass", "violation sum"],
    "mu_nmf": ["loop", "H H^T", "X H^T and W update", "partial sums", "butterflies",
               "H update", "error (stop)"],
    "beta_nmf": ["loop", "W pass", "W H and weight partials", "butterflies",
                 "column sums of W", "H update", "divergence (stop)"],
}
TRIALS = 16

MARKS = """
__device__ unsigned long long nmf_wprof[16];
__shared__ unsigned long long nmf_wacc[16];
__shared__ unsigned long long nmf_wlast;
__device__ __forceinline__ bool nmf_wowner() { return blockIdx.x == 0 && threadIdx.x == 0; }
__device__ __forceinline__ void nmf_wmark(int i) {
  if (nmf_wowner()) {
    const unsigned long long t = clock64();
    nmf_wacc[i] += t - nmf_wlast;
    nmf_wlast = t;
  }
}
__device__ __forceinline__ void nmf_wstart() {
  if (nmf_wowner()) {
    for (int i = 0; i < 16; ++i) nmf_wacc[i] = 0;
    nmf_wlast = clock64();
  }
}
__device__ __forceinline__ void nmf_wflush() {
  if (nmf_wowner()) {
    for (int i = 0; i < 16; ++i) nmf_wprof[i] += nmf_wacc[i];
  }
}
"""

READER = """
extern "C" int {name}_wprof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, nmf_wprof, sizeof(unsigned long long) * 16);
  const unsigned long long zero[16] = {{0}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nmf_wprof, zero, sizeof(zero));
  return (int)e;
}}
"""


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old[:70]!r}")
    return text.replace(old, new)


def _bracket(s: str, load: str, store: str) -> str:
    """nmf_wstart() after the kernel's load, nmf_wflush() before its store."""
    s = _patch(s, load, load + "  nmf_wstart();\n")
    return _patch(s, store, "  nmf_wflush();\n" + store)


WARP_LOAD = ("  nmf_warp_load<KMAX, LMAX>(x + fit * n * l, w0 + fit * n * k,\n"
             "                            h0 + fit * k * l, n, l, k, lane, xr, wr, sl.h);\n")
WARP_STORE = "  nmf_warp_store<KMAX, LMAX>(w + fit * n * k, h + fit * k * l, n, l, k, lane,\n"


def _common(s: str) -> str:
    s = _patch(s, "#define NMF_WARP_FITS ", MARKS + "#define NMF_WARP_FITS ")
    # K1's partial sums and their butterflies (shared with K2 before its
    # warp entry took each fit's own rank)
    if "BLOCK_ORDER" in s:
        s = _patch(s, "      a[v] = s;\n    }\n    if constexpr (BLOCK_ORDER) {\n",
                   "      a[v] = s;\n    }\n    nmf_wmark(3);\n    if constexpr (BLOCK_ORDER) {\n")
        return _patch(s, "        sl.wtx[q - NWW] = a[0];\n      }\n    }\n  }\n}",
                      "        sl.wtx[q - NWW] = a[0];\n      }\n    }\n    nmf_wmark(4);\n  }\n}")
    s = _patch(s, "      a[v] = s;\n    }\n    nmf_warp_allsum(a);\n",
               "      a[v] = s;\n    }\n    nmf_wmark(3);\n    nmf_warp_allsum(a);\n")
    return _patch(s, "        sl.wtx[q - NWW] = a[v];\n      }\n    }\n  }\n}",
                  "        sl.wtx[q - NWW] = a[v];\n      }\n    }\n    nmf_wmark(4);\n  }\n}")


def _cd(s: str) -> str:
    if "cd_warp_rank" in s:  # the warp entry over each fit's own rank
        s = _patch(s, "  // ---- H H^T: its", "  nmf_wmark(0);\n  // ---- H H^T: its")
        s = _patch(s, "  // ---- W pass on the", "  nmf_wmark(1);\n  // ---- W pass on the")
        s = _patch(s, "  // ---- W^T W and W^T X: the", "  nmf_wmark(2);\n  // ---- W^T W and W^T X: the")
        s = _patch(s, "    // ---- the reduce-scatter", "    nmf_wmark(3);\n    // ---- the reduce-scatter")
        s = _patch(s, "sl.gw[rk.sm16] = a[0];\n    }\n  }\n",
                   "sl.gw[rk.sm16] = a[0];\n    }\n    nmf_wmark(4);\n  }\n")
        s = _patch(s, "  // ---- the violation", "  nmf_wmark(5);\n  // ---- the violation")
        s = _patch(s, "  return viol;\n}", "  nmf_wmark(6);\n  return viol;\n}")
        start = "  const CdWarpRank<KMAX, LMAX> rk = cd_warp_rank(sl, wr, lane);\n"
        return _bracket(s, start, WARP_STORE)
    s = _patch(s, "  float part = 0.0f;\n\n  // ---- H H^T, K*K sums over L ----\n"
                  "  nmf_warp_hht(sl, lane);\n  __syncwarp();\n",
               "  float part = 0.0f;\n  nmf_wmark(0);\n  nmf_warp_hht(sl, lane);\n"
               "  __syncwarp();\n  nmf_wmark(1);\n")
    s = _patch(s, "  // ---- W^T W and W^T X: partial sums",
               "  nmf_wmark(2);\n  // ---- W^T W and W^T X: partial sums")
    s = _patch(s, "  __syncwarp();\n  return WITH_VIOL ? nmf_warp_sum(part) : 0.0f;\n}",
               "  __syncwarp();\n  nmf_wmark(5);\n"
               "  const float viol_ = WITH_VIOL ? nmf_warp_sum(part) : 0.0f;\n"
               "  nmf_wmark(6);\n  return viol_;\n}")
    return _bracket(s, WARP_LOAD, WARP_STORE)


def _mu(s: str) -> str:
    s = _patch(s, "  // ---- W: X H^T and H H^T are fixed while H is ----\n"
                  "  nmf_warp_hht(sl, lane);\n  __syncwarp();\n",
               "  nmf_wmark(0);\n  nmf_warp_hht(sl, lane);\n  __syncwarp();\n  nmf_wmark(1);\n")
    s = _patch(s, "  // ---- H: W^T X and W^T W are fixed while W is ----\n"
                  "  nmf_warp_wtw_wtx",
               "  nmf_wmark(2);\n  nmf_warp_wtw_wtx")
    s = _patch(s, "    for (int i = 0; i < KMAX; ++i) sl.h[i * LMAX + lane] = hc[i];\n"
                  "  }\n  __syncwarp();\n}",
               "    for (int i = 0; i < KMAX; ++i) sl.h[i * LMAX + lane] = hc[i];\n"
               "  }\n  __syncwarp();\n  nmf_wmark(5);\n}")
    s = _patch(s, "        const float err = mu_warp_error(sl, xr, wr);\n",
               "        nmf_wmark(0);\n        const float err = mu_warp_error(sl, xr, wr);\n"
               "        nmf_wmark(6);\n")
    return _bracket(s, WARP_LOAD, WARP_STORE)


def _beta(s: str) -> str:
    s = _patch(s, "  // ---- W: the lane's rows, weights in registers ----\n",
               "  nmf_wmark(0);\n")
    s = _patch(s, "  // ---- H: W^T (weights of the fresh WH), then one lane per entry ----\n",
               "  nmf_wmark(1);\n")
    s = _patch(s, "      nmf_warp_allsum(a);\n      float* out = ",
               "      nmf_wmark(2);\n      nmf_warp_allsum(a);\n      float* out = ")
    s = _patch(s, "      for (int v = 0; v < 32; ++v) out[v] = a[v];\n    }\n  }\n",
               "      for (int v = 0; v < 32; ++v) out[v] = a[v];\n      nmf_wmark(3);\n"
               "    }\n  }\n")
    s = _patch(s, "    for (int i = 0; i < KMAX; ++i) sl.den[i] = a[i];\n  }\n}",
               "    for (int i = 0; i < KMAX; ++i) sl.den[i] = a[i];\n  }\n  nmf_wmark(4);\n}")
    s = _patch(s, "    sl.h[q] = v;\n  }\n  __syncwarp();\n}",
               "    sl.h[q] = v;\n  }\n  __syncwarp();\n  nmf_wmark(5);\n}")
    s = _patch(s, "        const double err = beta_warp_divergence(sl, xr, wr, lane, n, l, beta);\n",
               "        nmf_wmark(0);\n"
               "        const double err = beta_warp_divergence(sl, xr, wr, lane, n, l, beta);\n"
               "        nmf_wmark(6);\n")
    return _bracket(s, WARP_LOAD, WARP_STORE)


def copies(csrc: Path, out: Path) -> tuple[Path, Path]:
    """``out/plain`` (the sources as they are) and ``out/marked``."""
    shutil.rmtree(out, ignore_errors=True)
    plain, marked = out / "plain", out / "marked"
    for d in (plain, marked):
        d.mkdir(parents=True)
        for src in list(csrc.glob("*.cuh")) + [csrc / f"{n}.cu" for n in KERNELS]:
            shutil.copy(src, d / src.name)
    path = marked / "nmf_common.cuh"
    path.write_text(_common(path.read_text()))
    for name, patch in (("cd_nmf", _cd), ("mu_nmf", _mu), ("beta_nmf", _beta)):
        path = marked / f"{name}.cu"
        path.write_text(patch(path.read_text()) + READER.format(name=name))
    return plain, marked


def build(dirs) -> dict:
    """One nvcc a (directory, kernel), all started together; returns
    {(dir, name): (CDLL, ptxas report)}."""
    from muscle_synergies_tpu_torch import _build

    procs = {}
    for d in dirs:
        for name in KERNELS:
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                   str(d / f"lib{name}.so"), str(d / f"{name}.cu")]
            procs[(d, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
    out = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key[0]}/{key[1]}.cu:\n{log}")
        out[key] = (ctypes.CDLL(str(key[0] / f"lib{key[1]}.so")), log)
    return out


def warp_ptxas(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) of each warp kernel."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        if name and "warp" in name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.append((name, int(m.group(1)), *spill))
                name = None
    return rows


def sass_counts(lib: Path) -> dict:
    """Per warp kernel: its SASS instructions and a count of some kinds."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.is_file():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    kinds = ("FFMA", "FADD", "FMUL", "MUFU.RCP", "FCHK", "CALL", "BRA", "SHFL", "WARPSYNC",
             "LDS", "STS", "LDL", "STL", "SEL", "FSEL")
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "warp" in m.group(1) else None
            if name:
                out[name] = dict.fromkeys(("instructions",) + kinds, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9._]*)", line)
        if name and m:
            op = m.group(2)
            out[name]["instructions"] += 1
            for kind in kinds:
                if op == kind or op.startswith(kind + "."):
                    out[name][kind] += 1
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_warp_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="tree whose csrc/ is profiled (default: this repository)")
    parser.add_argument("--label", default="current")
    args = parser.parse_args(argv)

    from chip_smoke import FS, synthetic_emg
    from muscle_synergies_tpu_torch import PipelineConfig, preprocess_trials
    from muscle_synergies_tpu_torch.models import batch as mb
    from muscle_synergies_tpu_torch.models.kernels import beta_cuda, cd_cuda, mu_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    csrc = args.root.resolve() / "muscle_synergies_tpu_torch" / "csrc"
    plain_dir, marked_dir = copies(csrc, ROOT / "build" / "warp_profile" / args.label)
    libs = build((plain_dir, marked_dir))
    for name in KERNELS:
        for kernel, regs, st, ld in warp_ptxas(libs[(plain_dir, name)][1]):
            print(json.dumps({"label": args.label, "ptxas": kernel, "registers": regs,
                              "spill_stores": st, "spill_loads": ld}), flush=True)
        for kernel, regs, st, ld in warp_ptxas(libs[(marked_dir, name)][1]):
            print(json.dumps({"label": args.label, "ptxas_marked": kernel, "registers": regs,
                              "spill_stores": st, "spill_loads": ld}), flush=True)
        for kernel, counts in sass_counts(plain_dir / f"lib{name}.so").items():
            print(json.dumps({"label": args.label, "sass": kernel, **counts}), flush=True)

    mods = {"cd_nmf": cd_cuda, "mu_nmf": mu_cuda, "beta_nmf": beta_cuda}

    def use(which):
        d = plain_dir if which == "plain" else marked_dir
        for name, mod in mods.items():
            mod.load = lambda n, d=d: libs[(d, n)][0]

    readers = {}
    for name in KERNELS:
        fn = getattr(libs[(marked_dir, name)][0], f"{name}_wprof_read")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        readers[name] = fn
    counts = (ctypes.c_ulonglong * 16)()

    config = PipelineConfig()
    stop = dict(max_iter=config.max_iter, tol=config.tol)
    xs = preprocess_trials(synthetic_emg(TRIALS, seed=2), FS, config)
    ws, hs = [], []
    for k in (1, 2, 3, 4):
        w, h = mb.init_batch(xs, k)
        ws.append(torch.nn.functional.pad(w, (0, 4 - k)))
        hs.append(torch.nn.functional.pad(h, (0, 0, 0, 4 - k)))
    gx, gw, gh = xs.repeat(4, 1, 1).contiguous(), torch.cat(ws), torch.cat(hs)
    fits = {"cd_nmf": lambda x, w, h: mb.fit_cd_batch(x, w, h, **stop),
            "mu_nmf": lambda x, w, h: mb.fit_mu_batch(x, w, h, **stop),
            "beta_nmf": lambda x, w, h: mb.fit_mu_beta_batch(x, w, h, beta=1.0, **stop)}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    reps = 3

    def timed(fn):
        best, out = None, None
        for _ in range(reps):
            events[0].record()
            out = fn()
            events[1].record()
            torch.cuda.synchronize()
            ms = events[0].elapsed_time(events[1])
            best = ms if best is None else min(best, ms)
        return best, out

    use("plain")
    for name in KERNELS:
        fit = fits[name]
        n_iter = fit(gx, gw, gh).n_iter.view(4, TRIALS)
        cases = []
        for rank in (1, 4):
            i = (rank - 1) * TRIALS + int(n_iter[rank - 1].argmax())
            cases.append((f"rank {rank} padded to 4, longest of {TRIALS}", gx[i:i + 1],
                          gw[i:i + 1], gh[i:i + 1]))
            if name == "cd_nmf" and rank == 1:
                cases.append(("rank 1 launched at k = 1", gx[i:i + 1],
                              gw[i:i + 1, :, :1].contiguous(), gh[i:i + 1, :1].contiguous()))
        outs = {}
        for label, x, w, h in cases:
            use("plain")
            ms, st = timed(lambda: fit(x, w, h))
            iters = int(st.n_iter[0])
            use("marked")
            fit(x, w, h)
            torch.cuda.synchronize()
            assert readers[name](counts) == 0
            ms_marked, st_m = timed(lambda: fit(x, w, h))
            assert readers[name](counts) == 0
            outs[label] = st_m
            cycles = {p: counts[j] / (reps * iters) for j, p in enumerate(PHASES[name])}
            print(json.dumps({
                "label": args.label, "kernel": name, "case": label, "n_iter": iters,
                "us_per_iteration": ms / iters * 1e3,
                "us_per_iteration_marked": ms_marked / iters * 1e3,
                "cycles_per_iteration": cycles, "cycles_total": sum(cycles.values()),
                "card": smi}), flush=True)
        use("plain")
        if name == "cd_nmf":
            a, b = (outs[c] for c in ("rank 1 padded to 4, longest of 16",
                                      "rank 1 launched at k = 1"))
            same = (torch.equal(a.w[..., :1], b.w) and torch.equal(a.ht[..., :1], b.ht)
                    and int(a.n_iter[0]) == int(b.n_iter[0]))
            print(json.dumps({"label": args.label, "kernel": name,
                              "rank 1 padded equals k = 1, bit for bit": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
