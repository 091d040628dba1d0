#!/usr/bin/env python3
"""Split an iteration of K5's one-block entries into their phases on one card.

K5 (``csrc/cnmf.cu``) fits each 200 x 8 convolutive problem of the
time-varying path in one thread block, and the path's tail is its longest
fit, alone on its SM for tens of thousands of iterations.  This script
copies the kernel's sources (from the repository, or from ``--root``, an
unpacked ``git archive`` of another commit, whose package then runs them)
to
``build/cnmf_profile/<label>/`` (git-ignored), once as they are and once
with ``clock64()`` marks: thread 0 of the first block adds the cycles
since the last mark to one counter a phase, in shared memory, flushed to
device memory when the fit ends.  Every phase ends at a barrier of the
block, so its cycles are the block's.  The phases, in order:

- the loop (the stop's test and the iteration's start);
- the first reconstruction (Xh from the old C and S);
- the S sums (each thread's time slice of the numerators and
  denominators);
- the S partials and the S update (the slices added in order, the
  quotients);
- the second reconstruction (with the new S);
- the C update;
- the error (every ``check_every`` iterations, in float64).

A source whose entries carry ``CNMF_MARK`` (empty unless defined) gets its
marks there; an earlier one, which has only the narrow block entry, gets
them by text patches.  Both copies are built (one ``nvcc`` each, all
started together) and the ptxas lines of the entries' kernels printed.
Then, on ``chip_smoke.py``'s synthetic trials under the default
``PipelineConfig`` (256 trials; the time-varying path's 1,024 fits, 4
restarts a trial), it runs the path's longest fit alone at the path's stop
(tol 1e-6, max_iter 100,000), and one fit of a bootstrap of a 2,400 x 8
subject (12 cycles; max_iter 300, tol 1e-5), on each entry the source
has (``--entries``): unmarked (CUDA events, best of 3) and marked.  One
JSON line a case: iterations, us an iteration, cycles an iteration of
each phase and their sum, beside the card's name, power limit and
clock.  ``--variants "w256:-DCNMF_WIDE_THREADS=256;w1024:-DCNMF_WIDE_THREADS=1024"``
also builds the wide entry with those compile-time settings (a macro
the source defines itself, such as its width, is rewritten in the
variant's copy), marked and unmarked, prints their ptxas lines, and runs
the same fits on each variant's wide entry, with their digests.  Every build prints its nvcc
seconds (the builds start together).  Where ``cuobjdump`` is found, each
unmarked library's SASS is written beside it (``cnmf.sass``)::

    python3 scripts/torch_cnmf_profile.py [--root DIR] [--label NAME] [--entries block,wide]
                                          [--variants "NAME:FLAGS;..."]

Without a CUDA card it exits with code 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASES = ["loop", "reconstruct 1", "S sums", "S partials and apply", "reconstruct 2",
          "C update", "error (stop)"]
TRIALS = 256

MARKS = """
__device__ unsigned long long cnmf_prof[16];
__shared__ unsigned long long cnmf_pacc[16];
__shared__ unsigned long long cnmf_plast;
__device__ __forceinline__ bool cnmf_powner() { return blockIdx.x == 0 && threadIdx.x == 0; }
__device__ __forceinline__ void cnmf_pmark(int i) {
  if (cnmf_powner()) {
    const unsigned long long t = clock64();
    cnmf_pacc[i] += t - cnmf_plast;
    cnmf_plast = t;
  }
}
__device__ __forceinline__ void cnmf_pstart() {
  if (cnmf_powner()) {
    for (int i = 0; i < 16; ++i) cnmf_pacc[i] = 0;
    cnmf_plast = clock64();
  }
}
__device__ __forceinline__ void cnmf_pflush() {
  if (cnmf_powner()) {
    for (int i = 0; i < 16; ++i) cnmf_prof[i] += cnmf_pacc[i];
  }
}
#define CNMF_MARK(i) cnmf_pmark(i)
#define CNMF_MARK_START() cnmf_pstart()
#define CNMF_MARK_FLUSH() cnmf_pflush()
"""

READER = """
extern "C" int cnmf_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, cnmf_prof, sizeof(unsigned long long) * 16);
  const unsigned long long zero[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(cnmf_prof, zero, sizeof(zero));
  return (int)e;
}
"""


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old[:70]!r}")
    return text.replace(old, new)


def _narrow_patches(s: str) -> str:
    """Marks in a source without ``CNMF_MARK``: the narrow block entry."""
    s = _patch(s, "  cnmf_reconstruct(b);\n  cnmf_update_s(b);\n  cnmf_reconstruct(b);\n"
                  "  cnmf_update_c(b);\n}",
               "  CNMF_MARK(0);\n  cnmf_reconstruct(b);\n  CNMF_MARK(1);\n  cnmf_update_s(b);\n"
               "  CNMF_MARK(3);\n  cnmf_reconstruct(b);\n  CNMF_MARK(4);\n"
               "  cnmf_update_c(b);\n  CNMF_MARK(5);\n}")
    s = _patch(s, "    __syncthreads();\n    if (g == 0) {\n",
               "    __syncthreads();\n    CNMF_MARK(2);\n    if (g == 0) {\n")
    s = _patch(s, "      const double err = cnmf_error(b);\n",
               "      CNMF_MARK(0);\n      const double err = cnmf_error(b);\n"
               "      CNMF_MARK(6);\n")
    s = _patch(s, "  cnmf_load(b, x + fit * t * l, c0 + fit * t * k, s0 + fit * k * d * l);\n",
               "  cnmf_load(b, x + fit * t * l, c0 + fit * t * k, s0 + fit * k * d * l);\n"
               "  CNMF_MARK_START();\n")
    return _patch(s, "  cnmf_store(b, c + fit * t * k, s + fit * k * d * l);\n}",
                  "  CNMF_MARK_FLUSH();\n  cnmf_store(b, c + fit * t * k, s + fit * k * d * l);\n}")


def copies(csrc: Path, out: Path) -> tuple[Path, Path]:
    """``out/plain`` (the sources as they are) and ``out/marked``."""
    shutil.rmtree(out, ignore_errors=True)
    plain, marked = out / "plain", out / "marked"
    for d in (plain, marked):
        d.mkdir(parents=True)
        for src in list(csrc.glob("*.cuh")) + [csrc / "cnmf.cu"]:
            shutil.copy(src, d / src.name)
    path = marked / "cnmf.cu"
    s = path.read_text()
    if "CNMF_MARK(" not in s:
        s = _narrow_patches(s)
    s = _patch(s, '#include "nmf_common.cuh"\n', '#include "nmf_common.cuh"\n' + MARKS)
    path.write_text(s + READER)
    return plain, marked


def redefine(path: Path, opts: list) -> list:
    """``-DNAME=VALUE`` of a macro the source defines itself (such as
    ``CNMF_WIDE_THREADS``) rewritten into its ``#define`` line in the copy
    at ``path``; the other flags returned for nvcc."""
    text, rest = path.read_text(), []
    for opt in opts:
        m = re.fullmatch(r"-D(\w+)=(\S+)", opt)
        line = m and re.search(rf"^#define {m.group(1)} .*$", text, re.M)
        if line:
            text = text.replace(line.group(0), f"#define {m.group(1)} {m.group(2)}")
        else:
            rest.append(opt)
    path.write_text(text)
    return rest


def build(dirs, defines=None) -> dict:
    """One nvcc a directory (with its ``-D`` flags from ``defines``), all
    started together, each one's seconds printed; returns {dir: (CDLL,
    ptxas report)}."""
    from muscle_synergies_tpu_torch import _build

    procs, t0 = {}, time.perf_counter()
    for d in dirs:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *(defines or {}).get(d, []), "-I",
               str(d), "-o", str(d / "libcnmf.so"), str(d / "cnmf.cu")]
        procs[d] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    out = {}
    for d, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d}/cnmf.cu:\n{log}")
        print(json.dumps({"nvcc": d.name, "seconds": time.perf_counter() - t0}), flush=True)
        out[d] = (ctypes.CDLL(str(d / "libcnmf.so")), log)
    return out


def ptxas(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) of each kernel."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_cnmf_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="tree whose package and csrc/ are profiled (default: this "
                        "repository)")
    parser.add_argument("--label", default="current")
    parser.add_argument("--entries", default="block,wide",
                        help="the entries to run, of those the source has")
    parser.add_argument("--variants", default="",
                        help="NAME:FLAGS;... wide-entry variants to build and run")
    args = parser.parse_args(argv)

    from chip_smoke import FS, cnmf_entry, digest, synthetic_emg

    sys.path.insert(0, str(args.root.resolve()))  # the tree's own package
    from muscle_synergies_tpu_torch import PipelineConfig, preprocess_trials
    from muscle_synergies_tpu_torch.models import cnmf
    from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    csrc = args.root.resolve() / "muscle_synergies_tpu_torch" / "csrc"
    plain_dir, marked_dir = copies(csrc, ROOT / "build" / "cnmf_profile" / args.label)
    has_wide = "cnmf_wide_f32" in (plain_dir / "cnmf.cu").read_text()
    entries = [e for e in args.entries.split(",") if e == "block" or has_wide]
    variants, flags = {}, {}
    for item in filter(None, args.variants.split(";")):
        name, _, opts = item.partition(":")
        if has_wide:
            variants[name] = (plain_dir.parent / f"{name}_plain",
                              plain_dir.parent / f"{name}_marked")
            for d, src in zip(variants[name], (plain_dir, marked_dir)):
                shutil.copytree(src, d)
                flags[d] = redefine(d / "cnmf.cu", opts.split())
    libs = build([plain_dir, marked_dir, *(d for v in variants.values() for d in v)], flags)
    dirs = [("ptxas", plain_dir), ("ptxas_marked", marked_dir)]
    dirs += [(f"ptxas_{name}", v[0]) for name, v in variants.items()]
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    for _, d in dirs:
        if tool.is_file():
            (d / "cnmf.sass").write_text(subprocess.run(
                [str(tool), "-sass", str(d / "libcnmf.so")], capture_output=True,
                text=True).stdout)
    for which, d in dirs:
        for kernel, regs, st, ld in ptxas(libs[d][1]):
            if "cluster" not in kernel:
                print(json.dumps({"label": args.label, which: kernel, "registers": regs,
                                  "spill_stores": st, "spill_loads": ld}), flush=True)
    readers = {}
    for d in [marked_dir] + [v[1] for v in variants.values()]:
        readers[d] = libs[d][0].cnmf_prof_read
        readers[d].argtypes = [ctypes.c_void_p]
        readers[d].restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 16)()

    def use(d):
        """The library built in ``d``."""
        lib = libs[d][0]
        cnmf_cuda.load = lambda n: lib
        width = getattr(lib, "cnmf_wide_threads", None)  # a variant's own width
        if width is not None:
            cnmf_cuda.WIDE_THREADS = width()

    def on(entry):
        """Every fit on ``entry`` in one launch (a tree without the wide
        entry has only the block entry)."""
        return cnmf_entry(entry) if has_wide else contextlib.nullcontext()

    config = PipelineConfig()
    dev = torch.device("cuda", 0)
    xs = preprocess_trials(synthetic_emg(TRIALS, seed=2), FS, config)
    gx = xs.repeat_interleave(4, dim=0)
    c0, s0 = (torch.from_numpy(a).to(dev) for a in cnmf.init_cnmf(
        np.repeat(xs.cpu().numpy(), 4, axis=0), 4, 10))
    path_stop = dict(max_iter=config.max_iter, tol=config.tol)
    use(plain_dir)
    with on("block"):
        longest = int(cnmf.fit_cnmf_batch(gx, c0, s0, **path_stop).n_iter.argmax())
    subject = xs[:12].reshape(-1, xs.shape[-1])
    bc, bs = (torch.from_numpy(a.astype(np.float32)).to(dev)[None] for a in cnmf.init_cnmf(
        subject.cpu().double().numpy(), 4, 10))
    cases = [
        (f"time-varying path's longest fit (fit {longest} of 1,024), 200x8 K=4 D=10",
         gx[longest:longest + 1], c0[longest:longest + 1], s0[longest:longest + 1],
         path_stop),
        ("one bootstrap fit of a 2,400x8 subject, K=4 D=10", subject[None], bc, bs,
         dict(max_iter=300, tol=1e-5)),
    ]
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

    runs = [(entry, plain_dir, marked_dir) for entry in entries]
    runs += [(f"wide {name}", *v) for name, v in variants.items()]
    for label, x, c, s, stop in cases:
        for entry, plain, marked in runs:
            fit = lambda: cnmf.fit_cnmf_batch(x, c, s, **stop)  # noqa: E731
            with on("block" if entry == "block" else "wide"):
                use(plain)
                ms, st = timed(fit)
                iters = int(st.n_iter[0])
                use(marked)
                fit()
                torch.cuda.synchronize()
                assert readers[marked](counts) == 0
                ms_marked, st_m = timed(fit)
                assert readers[marked](counts) == 0
            same = digest(*st) == digest(*st_m)
            cycles = {p: counts[j] / (reps * iters) for j, p in enumerate(PHASES)}
            print(json.dumps({
                "label": args.label, "entry": entry, "case": label, "n_iter": iters,
                "us_per_iteration": ms / iters * 1e3,
                "us_per_iteration_marked": ms_marked / iters * 1e3,
                "marked_same_bits": same, "digest": digest(*st),
                "cycles_per_iteration": cycles, "cycles_total": sum(cycles.values()),
                "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
