#!/usr/bin/env python3
"""Time the hand-written kernels K1 (``mu_nmf.cu``), K2 (``cd_nmf.cu``),
K4 (``beta_nmf.cu``), K5 (``cnmf.cu``), and K3 and K6
(``sosfiltfilt.cu``) against an earlier version of their CUDA sources,
in turns, on one card.

Put the earlier sources in a git-ignored directory and pass it::

    mkdir -p build/parent
    for f in cd_nmf.cu cnmf.cu mu_nmf.cu beta_nmf.cu nmf_common.cuh sosfiltfilt.cu; do
        git show <commit>:muscle_synergies_tpu_torch/csrc/$f > build/parent/$f
    done
    python3 scripts/torch_ab_parent_kernels.py build/parent [--part all|nmf|filters|cnmf]

The script builds the earlier sources with the port's own ``nvcc`` flags
into the same directory (printing ``ptxas`` registers and spills), and
swaps them in for the current ones behind the port's wrappers.  K1's,
K2's and K4's C interfaces are the same (where the earlier source has no
warp entry of a kernel, its block entry runs in the warp entry's place).
K5's block entry before its resumable stop (``cnmf_f32`` with C0 and S0
apart from C and S, the last error in float32) is bound by the script
(``ParentCnmf``): every one-block fit one launch of that entry, as the
earlier wrapper ran it; where the earlier source already has the wide
entry, its interface is the current one and its library runs behind the
current wrapper (chunks, tail and all).  The
earlier ``sosfiltfilt.cu`` is the one-thread-per-column version, whose
K3 reads a time-major copy made by ``fold_extend`` and takes no
per-trial lengths: the script binds its C interface itself.  Then, in
the order earlier, current, current, earlier, on the same inputs:

- ``--part filters`` (or ``all``): K3 and K6 at 64 and 256 trials x
  124,460 x 8 (CUDA events), after a check that both versions agree at
  64 trials; the zero-phase ``preprocess_trials`` of 256 ragged trials
  (``chip_smoke.py``'s lengths, host clock), the earlier side grouping
  them by length as the earlier ``preprocess_trials`` did (one K3 launch
  per length), the current side in one launch; then, current only, the
  chunk length ``filter_cuda.CHUNK`` swept over 256-4,096 for K3 and K6
  at 64 and 256 trials, in two rounds, after a ``torch.profiler`` trace
  of the current kernels' device time by CUDA kernel (each pass's three
  phases); ``--filters-abi chunked`` times
  an earlier source that already has the chunked C interface (no
  grouping by length on either side);
- ``--part nmf`` (or ``all``): fixed iterations at 1024 x 200 x 8, rank
  4 (CUDA events): 50 CD, 50 MU and 50 KL (beta = 1) iterations, and 20
  convolutive iterations at K = 4, D = 10; the fits of
  ``chip_smoke.py``'s main paths on the same 256 synthetic trials (host
  clock around a synchronised call), 1,024 fits each: the CD, MU and KL
  fits of the zero-phase grid (ranks 1-4), the MU fit of the causal
  grid, the CD fit of the RMS grid (ragged trials) and the convolutive
  fit (4 restarts of every trial), with each fit's iteration count and
  its median by rank; and, for every path but the RMS one, its longest
  fit alone, the latency that sets the path's tail; the whole CD,
  RMS-CD, MU, causal-MU, KL and time-varying paths;
- ``--part cnmf``: K5 alone, each with a digest of its factors' bits and
  iterations: 20 fixed iterations at 1024 and 128 x 200 x 8 (K = 4,
  D = 10), the time-varying path's fit (1,024 fits of the main path's
  trials), its longest fit alone, the bootstrap's 51 fits of a 2,400 x 8
  subject (max_iter 300, tol 1e-5), the whole time-varying path; then,
  current only, the longest fit on the block entry alone, and the path's
  fit at chunk lengths (``cnmf_cuda.CHUNK_ITERS``) of 250-2,000, in two
  rounds.

It prints each number beside the card's name and power limit, then one
JSON line with all of them.  Without a CUDA card it exits with code 2.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import FS, N_SAMPLES, RAGGED_MIN, cuda_ms, synthetic_emg  # noqa: E402

MAIN_TRIALS = 256
NMF_KERNELS = ("cd_nmf", "cnmf", "mu_nmf", "beta_nmf")
CNMF_CHUNKS = (250, 500, 1000, 2000)  # K5's chunk lengths swept
CHUNKS = (256, 512, 1024, 2048, 4096)  # K3/K6 chunk lengths swept


def build_parent(src: Path, names) -> dict:
    """Compile the earlier sources, one nvcc each, all started together;
    return each kernel's loaded library."""
    from muscle_synergies_tpu_torch import _build

    procs = {}
    for name in names:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
               str(src / f"lib{name}.so"), str(src / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {name}.cu:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas earlier {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(src / f"lib{name}.so"))
    return libs


class Swap:
    """Run the port's wrappers on the earlier or the current kernels."""

    def __init__(self, parent_libs):
        from muscle_synergies_tpu_torch.models.kernels import (
            beta_cuda,
            cd_cuda,
            cnmf_cuda,
            mu_cuda,
        )

        self.mods = {"cd_nmf": cd_cuda, "mu_nmf": mu_cuda, "beta_nmf": beta_cuda}
        if hasattr(parent_libs["cnmf"], "cnmf_wide_f32"):
            self.mods["cnmf"] = cnmf_cuda
        self.current = {name: mod._lib for name, mod in self.mods.items()}
        self.parent = {name: self._picker(parent_libs[name], name, self.current[name])
                       for name in self.mods}

    @staticmethod
    def _picker(lib, name, current):
        """The earlier library's entry with the current one's C interface
        (its block entry where it has no such entry)."""
        def pick(entry: str = "block"):
            symbol = {"warp": f"{name}_warp_f32", "cluster": f"{name}_cluster_f32"}
            fn = getattr(lib, symbol.get(entry, f"{name}_f32"), None)
            if fn is None:
                fn, entry = getattr(lib, f"{name}_f32"), "block"
            like = current(entry)
            fn.argtypes, fn.restype = like.argtypes, like.restype
            return fn
        return pick

    def use(self, which: str) -> None:
        libs = self.parent if which == "earlier" else self.current
        for name, mod in self.mods.items():
            mod._lib = libs[name]


class ParentCnmf:
    """K5's block entry before its resumable stop behind the current
    wrapper: ``cnmf_f32(x, c0, s0, c, s, n_iter, prev_err, converged,
    batch, t, l, k, d, iters, tol, check_every, with_stop, stream)``, one
    launch a call for every one-block fit (the cluster entry, whose
    interface is unchanged, stays the current one's).  Launches count in
    ``cnmf_cuda.launches``."""

    def __init__(self, lib):
        from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda

        self.mod, self.current = cnmf_cuda, cnmf_cuda._launch
        self.fn = lib.cnmf_f32
        self.fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_double]
                            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int

    def use(self, which: str) -> None:
        self.mod._launch = self.launch if which == "earlier" else self.current

    def launch(self, xs, c0, s0, iters, tol, check_every, with_stop):
        import torch

        mod = self.mod
        if mod.check_shapes("cnmf", xs, c0, s0) == "cluster":
            return self.current(xs, c0, s0, iters, tol, check_every, with_stop)
        xs, c0, s0 = xs.contiguous(), c0.contiguous(), s0.contiguous()
        b, t, l = xs.shape
        k, d = s0.shape[1], s0.shape[2]
        c, s = torch.empty_like(c0), torch.empty_like(s0)
        n_iter, converged = (torch.zeros(b, dtype=torch.int32, device=xs.device)
                             for _ in range(2))
        prev_err = torch.zeros(b, dtype=torch.float32, device=xs.device)
        err = self.fn(xs.data_ptr(), c0.data_ptr(), s0.data_ptr(), c.data_ptr(), s.data_ptr(),
                      n_iter.data_ptr(), prev_err.data_ptr(), converged.data_ptr(), b, t, l,
                      k, d, int(iters), float(tol), int(check_every), int(with_stop),
                      torch.cuda.current_stream(xs.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier cnmf failed: CUDA error {err}")
        mod.launches += 1
        return c, s, n_iter, prev_err, converged.bool()


def cnmf_part(dev, smi, results, turns, tensor, digest, timed, use):
    """K5 in turns (see the module's note), then the current side's
    block-entry lone fit and chunk-length sweep."""
    import torch

    from chip_smoke import cnmf_entry
    from muscle_synergies_tpu_torch import (
        PipelineConfig,
        analyze_dataset_time_varying,
        preprocess_trials,
    )
    from muscle_synergies_tpu_torch.models import stability
    from muscle_synergies_tpu_torch.models.cnmf import fit_cnmf_batch, init_cnmf
    from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda

    rng = np.random.default_rng(0)
    xc = rng.random((1024, 200, 8))
    c0, s0 = init_cnmf(xc, 4, 10, seed=5)
    xc, c0, s0 = tensor(xc), tensor(c0), tensor(s0)

    def fixed(b):
        def run():
            out = cnmf_cuda.cnmf_iterations_cuda(xc[:b], c0[:b], s0[:b], 20)
            return cuda_ms(lambda: cnmf_cuda.cnmf_iterations_cuda(xc[:b], c0[:b], s0[:b], 20),
                           reps=20, warmup=3), {"digest": digest(*out)}
        return run

    for b in (1024, 128):
        turns(f"cnmf 20 iterations {b}x200x8 K=4 D=10", fixed(b))

    emg = synthetic_emg(MAIN_TRIALS, seed=2)
    config = PipelineConfig()
    stop = dict(max_iter=config.max_iter, tol=config.tol)
    zero_phase = preprocess_trials(emg, FS, config)
    gx = zero_phase.repeat_interleave(4, dim=0)
    tc, ts = (tensor(a) for a in init_cnmf(np.repeat(zero_phase.cpu().numpy(), 4, axis=0),
                                           4, 10))

    def path_fit():
        cnmf_cuda.launches = cnmf_cuda.wide_launches = 0
        ms, st = timed(lambda: fit_cnmf_batch(gx, tc, ts, **stop))
        n_iter = st.n_iter.cpu()
        return ms, {"iterations": int(n_iter.sum()), "median": float(n_iter.float().median()),
                    "max": int(n_iter.max()), "digest": digest(*st),
                    "launches": [cnmf_cuda.launches, getattr(cnmf_cuda, "wide_launches", 0)]}

    def lone(i):
        def run():
            idx = torch.tensor([i], device=dev)
            ms, st = timed(lambda: fit_cnmf_batch(gx[idx], tc[idx], ts[idx], **stop))
            iters = int(st.n_iter[0])
            return ms, {"iterations": iters, "us_per_iteration": ms / iters * 1e3,
                        "digest": digest(*st)}
        return run

    turns("time-varying path fit (1,024 fits)", path_fit)
    longest = int(fit_cnmf_batch(gx, tc, ts, **stop).n_iter.argmax())
    turns("time-varying path, its longest fit alone", lone(longest))

    subject = zero_phase[:12].reshape(-1, 8)
    host = subject.cpu().double().numpy()
    blocks = stability._block_bootstrap_indices(2400, 40, 50, np.random.default_rng(0))
    bx = torch.cat([subject[None], subject[torch.as_tensor(blocks, device=dev)]])
    bc, bs = (tensor(np.concatenate([a[None], b]))
              for a, b in zip(init_cnmf(host, 4, 10), init_cnmf(host[blocks], 4, 10)))

    def boot():
        ms, st = timed(lambda: fit_cnmf_batch(bx, bc, bs, max_iter=300, tol=1e-5))
        return ms, {"iterations": int(st.n_iter.sum()), "digest": digest(*st)}

    turns("bootstrap's 51 fits of 2,400x8", boot)
    turns("time-varying path, whole", lambda: (timed(lambda: analyze_dataset_time_varying(
        emg, FS, n_synergies=4, n_lags=10, n_inits=4))[0], ""))

    use("current")
    with cnmf_entry("block"):
        ms, extra = lone(longest)()
    print(f"time-varying path, its longest fit alone on the block entry [current]: "
          f"{ms:.3f} ms {extra}  [{smi}]", flush=True)
    results["longest fit alone, block entry, current"] = dict(ms=ms, **extra)
    saved = cnmf_cuda.CHUNK_ITERS
    for chunk in CNMF_CHUNKS + CNMF_CHUNKS[::-1]:
        cnmf_cuda.CHUNK_ITERS = chunk
        ms, extra = path_fit()
        print(f"chunk {chunk}: time-varying path fit {ms:.3f} ms {extra}  [{smi}]",
              flush=True)
        results.setdefault(f"cnmf chunk {chunk}", []).append(ms)
    cnmf_cuda.CHUNK_ITERS = saved


class ParentFilters:
    """The earlier K3 and K6 behind the current wrappers' signatures.

    With ``abi="columns"`` (sources before the chunked scans), binds the
    C interface of the one-thread-per-column ``sosfiltfilt.cu``:
    ``sosfiltfilt_f32(ext, out, coef, n_sections, n_ext, n_out, padlen,
    n_cols, channels, stream)`` over ``fold_extend``'s time-major copy,
    and ``sosfilt_f32(x, y, coef, zi, zf, n_sections, n, n_cols,
    channels, stream)``.  With ``abi="chunked"`` the earlier source has
    the current interface, and its library takes the current one's place
    behind the current wrappers.  Launches count in the current counters.
    """

    def __init__(self, lib, abi: str):
        from muscle_synergies_tpu_torch.ops import filter_cuda

        self.fc = filter_cuda
        self.current = (filter_cuda.sosfiltfilt_cuda, filter_cuda.sosfilt_cuda,
                        filter_cuda._lib)
        self.abi = abi
        self.k3, self.k6 = lib.sosfiltfilt_f32, lib.sosfilt_f32
        if abi == "chunked":
            fn, causal = filter_cuda._lib()
            self.k3.argtypes, self.k6.argtypes = fn.argtypes, causal.argtypes
        else:
            ptr, num = ctypes.c_void_p, ctypes.c_int
            self.k3.argtypes = [ptr] * 3 + [num] * 6 + [ptr]
            self.k6.argtypes = [ptr] * 5 + [num] * 4 + [ptr]
        self.k3.restype = self.k6.restype = ctypes.c_int

    def use(self, which: str) -> None:
        k3, k6, lib = self.current
        if which == "earlier" and self.abi == "chunked":
            lib = lambda: (self.k3, self.k6)  # noqa: E731
        elif which == "earlier":
            k3, k6 = self.sosfiltfilt, self.sosfilt
        self.fc.sosfiltfilt_cuda, self.fc.sosfilt_cuda, self.fc._lib = k3, k6, lib

    def sosfiltfilt(self, sos, x, padlen, padtype, lengths=None):
        import torch

        from muscle_synergies_tpu_torch.ops.filters import _normalize_sos, fold_extend

        if lengths is not None:
            raise ValueError("the earlier K3 takes no per-trial lengths")
        sos_np = _normalize_sos(sos)
        b, n, c = x.shape
        padlen = padlen if padtype is not None else 0
        ext = fold_extend(x, padlen, padtype)
        out = torch.empty_like(x)
        coef = self.fc._coefficients(sos_np, x.device)
        err = self.k3(ext.data_ptr(), out.data_ptr(), coef.data_ptr(), len(sos_np),
                      ext.shape[0], n, padlen, b * c, c,
                      torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier sosfiltfilt failed: CUDA error {err}")
        self.fc.launches += 1
        return out

    def sosfilt(self, sos, x, zi=None):
        import torch

        from muscle_synergies_tpu_torch.ops.filters import _normalize_sos

        sos_np = _normalize_sos(sos)
        b, n, c = x.shape
        cols = (len(sos_np), 2, b * c)
        zi_cols = (torch.zeros(cols, dtype=torch.float64, device=x.device) if zi is None
                   else self.fc._columns(zi).to(torch.float64).contiguous())
        x = x.contiguous()
        y, zf = torch.empty_like(x), torch.empty_like(zi_cols)
        coef = self.fc._coefficients(sos_np, x.device)
        err = self.k6(x.data_ptr(), y.data_ptr(), coef.data_ptr(), zi_cols.data_ptr(),
                      zf.data_ptr(), len(sos_np), n, b * c, c,
                      torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier sosfilt failed: CUDA error {err}")
        self.fc.sosfilt_launches += 1
        return y, self.fc._trials(zf, b).to(torch.float32)


def filter_part(dev, smi, results, turns, state):
    """K3 and K6 in turns at 64 and 256 trials, the ragged zero-phase
    preprocess in turns, then the chunk-length sweep (current only).

    ``state`` holds the side in use (``"which"``), the earlier source's
    C interface (``"abi"``) and the function that swaps sides (``"use"``).
    """
    import torch

    from muscle_synergies_tpu_torch import preprocess_trials
    from muscle_synergies_tpu_torch.ops import filter_cuda, filters

    sos = filters.sos_design(4, 4.0, FS)
    padlen = filters.default_padlen(sos)
    emg = synthetic_emg(MAIN_TRIALS, seed=2)
    # the filters' input on the main path: zero-centred, rectified EMG
    rect = torch.from_numpy(emg).to(dev)
    rect = (rect - rect.mean(dim=1, keepdim=True)).abs()
    shapes = {64: rect[:64].contiguous(), 256: rect}

    def k3(x):
        return filter_cuda.sosfiltfilt_cuda(sos, x, padlen, "odd")

    def k6(x):
        return filter_cuda.sosfilt_cuda(sos, x)[0]

    x = shapes[64]
    for name, fn in (("K3", k3), ("K6", k6)):
        outs = {}
        for which in ("earlier", "current"):
            state["use"](which)
            outs[which] = fn(x)
        state["use"]("current")
        gap = float((outs["current"] - outs["earlier"]).abs().max()
                    / outs["earlier"].abs().max())
        print(f"{name} at 64 trials: current vs earlier {gap:.3e} x max|y|", flush=True)
        results[f"{name} current vs earlier, 64 trials"] = gap
        del outs
    for b, xb in shapes.items():
        turns(f"K3 {b}x{N_SAMPLES}x8", lambda: (cuda_ms(lambda: k3(xb)), ""))
        turns(f"K6 {b}x{N_SAMPLES}x8", lambda: (cuda_ms(lambda: k6(xb)), ""))

    lengths = np.random.default_rng(4).integers(RAGGED_MIN, N_SAMPLES + 1,
                                               size=MAIN_TRIALS)
    ragged = [emg[b, :n] for b, n in enumerate(lengths)]

    def ragged_preprocess():
        filter_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if state["which"] == "earlier" and state["abi"] == "columns":
            # the earlier preprocess_trials' groups, one K3 launch each
            by_length = {}
            for i, a in enumerate(ragged):
                by_length.setdefault(a.shape[0], []).append(i)
            slots = [None] * len(ragged)
            for idx in by_length.values():
                group = preprocess_trials(np.stack([ragged[i] for i in idx]), FS)
                for j, i in enumerate(idx):
                    slots[i] = group[j]
            out = torch.stack(slots)
        else:
            out = preprocess_trials(ragged, FS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        state.setdefault("ragged", {})[state["which"]] = out
        return ms, {"K3 launches": filter_cuda.launches}

    turns(f"zero-phase preprocess_trials, {MAIN_TRIALS} ragged trials", ragged_preprocess)
    got = state.pop("ragged")
    gap = float((got["current"] - got["earlier"]).abs().max()
                / got["earlier"].abs().max())
    print(f"ragged preprocess: current vs earlier {gap:.3e} x max", flush=True)
    results["ragged preprocess current vs earlier"] = gap
    del got

    # where the current kernels' time goes: device time by CUDA kernel
    # (the three phases of each pass), from torch.profiler
    from torch.profiler import ProfilerActivity, profile

    for b, xb in shapes.items():
        for name, fn in (("K3", k3), ("K6", k6)):
            fn(xb)
            torch.cuda.synchronize()
            activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=activities) as prof:
                for _ in range(5):
                    fn(xb)
                torch.cuda.synchronize()
            rows = {}
            for evt in prof.key_averages():
                us = (getattr(evt, "device_time_total", 0)
                      or getattr(evt, "cuda_time_total", 0))
                if us > 0 and evt.count >= 5:
                    rows[evt.key] = us / 5 / 1e3  # ms a call
            for key, ms in sorted(rows.items(), key=lambda kv: -kv[1]):
                print(f"profile {name} {b}x{N_SAMPLES}x8: {ms:.4f} ms a call in "
                      f"{key[:90]}  [{smi}]", flush=True)
            results[f"profile {name} {b}"] = rows

    # the chunk length, current kernels only: two rounds, ascending then
    # descending, so that a drift of the card shows as a gap between them
    saved = filter_cuda.CHUNK
    for chunk in CHUNKS + CHUNKS[::-1]:
        filter_cuda.CHUNK = chunk
        for b, xb in shapes.items():
            for name, fn in (("K3", k3), ("K6", k6)):
                ms = cuda_ms(lambda: fn(xb))
                print(f"chunk {chunk}: {name} {b}x{N_SAMPLES}x8 {ms:.3f} ms  [{smi}]",
                      flush=True)
                results.setdefault(f"chunk {chunk} {name} {b}", []).append(ms)
    filter_cuda.CHUNK = saved


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_parent_kernels: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description="A/B of the CUDA kernels against "
                                     "earlier sources, in turns")
    parser.add_argument("parent", type=Path, help="directory of the earlier sources")
    parser.add_argument("--part", choices=("all", "nmf", "filters", "cnmf"), default="all")
    parser.add_argument("--filters-abi", choices=("columns", "chunked"), default="columns",
                        help="C interface of the earlier sosfiltfilt.cu: the "
                        "one-thread-per-column one, or the current chunked one")
    args = parser.parse_args(argv)
    parts = ("nmf", "filters") if args.part == "all" else (args.part,)
    from muscle_synergies_tpu_torch import (
        FilterSpec,
        PipelineConfig,
        analyze_dataset,
        analyze_dataset_time_varying,
        preprocess_trials,
    )
    from muscle_synergies_tpu_torch.models import batch as mb
    from muscle_synergies_tpu_torch.models.cnmf import fit_cnmf_batch, init_cnmf
    from muscle_synergies_tpu_torch.models.kernels import (
        beta_cuda,
        cd_cuda,
        cnmf_cuda,
        mu_cuda,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    names = (NMF_KERNELS if "nmf" in parts else ()) + (
        ("sosfiltfilt",) if "filters" in parts else ()) + (
        ("cnmf",) if "cnmf" in parts else ())
    libs = build_parent(args.parent.resolve(), names)
    swaps = []
    if "nmf" in parts:
        swaps.append(Swap(libs))
    if "cnmf" in names and not hasattr(libs["cnmf"], "cnmf_wide_f32"):
        swaps.append(ParentCnmf(libs["cnmf"]))
    if "filters" in parts:
        swaps.append(ParentFilters(libs["sosfiltfilt"], args.filters_abi))
    rng = np.random.default_rng(0)
    results = {"device": smi}
    state = {"which": "current", "abi": args.filters_abi}

    def use(which):
        state["which"] = which
        for swap in swaps:
            swap.use(which)

    state["use"] = use

    def turns(label, fn):
        """fn() -> (ms, extra) in the order earlier, current, current, earlier."""
        rows = {"earlier": [], "current": []}
        for which in ("earlier", "current", "current", "earlier"):
            use(which)
            ms, extra = fn()
            rows[which].append(ms)
            print(f"{label} [{which}]: {ms:.3f} ms {extra}  [{smi}]", flush=True)
            results.setdefault(label, {})[which + "_extra"] = extra
        use("current")
        for which, v in rows.items():
            results[label][which + "_ms"] = v

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def digest(*ts):
        """sha256 of the tensors' bytes: equal digests, equal bits."""
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]

    def fixed(fn):
        return cuda_ms(fn, reps=20, warmup=3), {"digest": digest(*fn())}

    if "filters" in parts:
        filter_part(dev, smi, results, turns, state)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    if "cnmf" in parts:
        cnmf_part(dev, smi, results, turns, tensor, digest, timed, use)
    if "nmf" not in parts:
        print(json.dumps(results), flush=True)
        return 0
    # ---- fixed iterations at the main paths' shapes ----
    xs, w0, h0 = (tensor(a) for a in (rng.random((1024, 200, 8)),
                                      np.abs(rng.standard_normal((1024, 200, 4))),
                                      np.abs(rng.standard_normal((1024, 4, 8)))))
    turns("cd 50 iterations 1024x200x8 k=4",
          lambda: fixed(lambda: cd_cuda.cd_iterations_cuda(xs, w0, h0, 50)))
    turns("mu 50 iterations 1024x200x8 k=4",
          lambda: fixed(lambda: mu_cuda.mu_iterations_cuda(xs, w0, h0, 50)))
    turns("kl 50 iterations 1024x200x8 k=4",
          lambda: fixed(lambda: beta_cuda.beta_iterations_cuda(xs, w0, h0, 50, 1.0)))
    xc = rng.random((1024, 200, 8))
    c0, s0 = init_cnmf(xc, 4, 10, seed=5)
    xc, c0, s0 = tensor(xc), tensor(c0), tensor(s0)
    turns("cnmf 20 iterations 1024x200x8 K=4 D=10",
          lambda: (cuda_ms(lambda: cnmf_cuda.cnmf_iterations_cuda(xc, c0, s0, 20)), ""))

    # ---- the main paths' fits on their own inputs ----
    emg = synthetic_emg(MAIN_TRIALS, seed=2)
    lengths = np.random.default_rng(4).integers(RAGGED_MIN, N_SAMPLES + 1, size=MAIN_TRIALS)
    ragged = [emg[b, :n] for b, n in enumerate(lengths)]
    config = PipelineConfig()
    causal = PipelineConfig(envelope=FilterSpec(zero_lag=False))
    stop = dict(max_iter=config.max_iter, tol=config.tol)

    def grid(frames):
        ws, hs = [], []
        for k in (1, 2, 3, 4):
            w, h = mb.init_batch(frames, k)
            ws.append(torch.nn.functional.pad(w, (0, 4 - k)))
            hs.append(torch.nn.functional.pad(h, (0, 0, 0, 4 - k)))
        return frames.repeat(4, 1, 1), torch.cat(ws), torch.cat(hs)

    def grid_fit(fit, g):
        ms, st = timed(lambda: fit(*g))
        n_iter = st.n_iter.view(4, -1).cpu()
        return ms, {"iterations": int(n_iter.sum()),
                    "median_by_rank": n_iter.float().median(dim=1).values.tolist(),
                    "digest": digest(*st[:2])}

    def lone(fit, i):
        """The fit ``i`` alone on the card: one fit's iteration latency."""
        idx = torch.tensor([i], device=dev)
        ms, st = timed(lambda: fit(idx))
        iters = int(st.n_iter[0])
        return ms, {"iterations": iters, "us_per_iteration": ms / iters * 1e3,
                    "digest": digest(*st[:2])}

    fits = {
        "CD": lambda x, w, h: mb.fit_cd_batch(x, w, h, **stop),
        "MU": lambda x, w, h: mb.fit_mu_batch(x, w, h, **stop),
        "KL": lambda x, w, h: mb.fit_mu_beta_batch(x, w, h, beta=1.0, **stop),
    }
    zero_phase = preprocess_trials(emg, FS, config)
    g = grid(zero_phase)
    gc = grid(preprocess_trials(emg, FS, causal))
    for label, fit, frames in (("CD", fits["CD"], g), ("MU", fits["MU"], g),
                               ("causal MU", fits["MU"], gc), ("KL", fits["KL"], g)):
        turns(f"{label} path fit (1,024 fits)", lambda: grid_fit(fit, frames))
        longest = int(fit(*frames).n_iter.argmax())
        turns(f"{label} path, its longest fit alone", lambda: lone(
            lambda i: fit(frames[0][i], frames[1][i], frames[2][i]), longest))
    del gc
    gr = grid(preprocess_trials(ragged, FS, PipelineConfig(use_rms=True)))
    turns("RMS-CD path fit (1,024 fits, ragged)", lambda: grid_fit(fits["CD"], gr))
    del gr
    gx = zero_phase.repeat_interleave(4, dim=0)
    tc, ts = (tensor(a) for a in init_cnmf(np.repeat(zero_phase.cpu().numpy(), 4, axis=0),
                                           4, 10))

    def cnmf_fit():
        ms, st = timed(lambda: fit_cnmf_batch(gx, tc, ts, **stop))
        n_iter = st.n_iter.cpu()
        return ms, {"iterations": int(n_iter.sum()), "median": float(n_iter.float().median()),
                    "max": int(n_iter.max())}

    turns("time-varying path fit (1,024 fits)", cnmf_fit)
    longest = int(fit_cnmf_batch(gx, tc, ts, **stop).n_iter.argmax())
    turns("time-varying path, its longest fit alone", lambda: lone(
        lambda i: fit_cnmf_batch(gx[i], tc[i], ts[i], **stop), longest))

    # ---- the whole paths ----
    def path(fn):
        ms, res = timed(fn)
        return ms, {"n_iter_median_by_rank": np.median(res.n_iter, axis=-1).tolist()
                    if res.n_iter.ndim == 2 else float(np.median(res.n_iter))}

    sweep = dict(ranks=(1, 2, 3, 4))
    turns("CD path, whole", lambda: path(lambda: analyze_dataset(
        emg, FS, solver="cd", **sweep)))
    turns("RMS-CD path, whole (ragged)", lambda: path(lambda: analyze_dataset(
        ragged, FS, solver="cd", config=PipelineConfig(use_rms=True), **sweep)))
    turns("MU path, whole", lambda: path(lambda: analyze_dataset(
        emg, FS, solver="mu", **sweep)))
    turns("causal MU path, whole", lambda: path(lambda: analyze_dataset(
        emg, FS, solver="mu", config=causal, **sweep)))
    turns("KL path, whole", lambda: path(lambda: analyze_dataset(
        emg, FS, solver="mu", beta_loss="kullback-leibler", **sweep)))
    turns("time-varying path, whole", lambda: path(lambda: analyze_dataset_time_varying(
        emg, FS, n_synergies=4, n_lags=10, n_inits=4)))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
