#!/usr/bin/env python3
"""Time the NMF kernels K1 (``mu_nmf.cu``), K2 (``cd_nmf.cu``), K4
(``beta_nmf.cu``) and K5 (``cnmf.cu``) against an earlier version of
their CUDA sources, in turns, on one card.

Put the earlier sources in a git-ignored directory and pass it::

    mkdir -p build/parent
    for f in cd_nmf.cu cnmf.cu mu_nmf.cu beta_nmf.cu nmf_common.cuh; do
        git show <commit>:muscle_synergies_tpu_torch/csrc/$f > build/parent/$f
    done
    python3 scripts/torch_ab_parent_kernels.py build/parent

The script builds the earlier sources with the port's own ``nvcc`` flags
into the same directory (printing ``ptxas`` registers and spills), and
swaps them in for the current ones behind the port's wrappers (their C
interfaces are the same; where the earlier source has no warp entry of a
kernel, its block entry runs in the warp entry's place).  Then, in the
order earlier, current, current, earlier, on the same inputs:

- fixed iterations at 1024 x 200 x 8, rank 4 (CUDA events): 50 CD, 50
  MU and 50 KL (beta = 1) iterations, and 20 convolutive iterations at
  K = 4, D = 10;
- the fits of ``chip_smoke.py``'s main paths on the same 256 synthetic
  trials (host clock around a synchronised call), 1,024 fits each: the
  CD, MU and KL fits of the zero-phase grid (ranks 1-4), the MU fit of
  the causal grid, the CD fit of the RMS grid (ragged trials) and the
  convolutive fit (4 restarts of every trial), with each fit's
  iteration count and its median by rank; and, for every path but the
  RMS one, its longest fit alone, the latency that sets the path's tail;
- the whole CD, RMS-CD, MU, causal-MU, KL and time-varying paths.

It prints each number beside the card's name and power limit, then one
JSON line with all of them.  Without a CUDA card it exits with code 2.
"""

from __future__ import annotations

import ctypes
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
KERNELS = ("cd_nmf", "cnmf", "mu_nmf", "beta_nmf")


def build_parent(src: Path) -> dict:
    """Compile the earlier sources, one nvcc each, all started together;
    return each kernel's loaded library."""
    from muscle_synergies_tpu_torch import _build

    procs = {}
    for name in KERNELS:
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

        self.mods = {"cd_nmf": cd_cuda, "cnmf": cnmf_cuda, "mu_nmf": mu_cuda,
                     "beta_nmf": beta_cuda}
        self.current = {name: mod._lib for name, mod in self.mods.items()}
        self.parent = {}
        for name, mod in self.mods.items():
            like = mod._lib() if name == "cnmf" else mod._lib("block")
            self.parent[name] = self._picker(parent_libs[name], name, like)

    @staticmethod
    def _picker(lib, name, like):
        def pick(entry: str = "block"):
            fn = getattr(lib, f"{name}_warp_f32", None) if entry == "warp" else None
            if fn is None:
                fn = getattr(lib, f"{name}_f32")
            fn.argtypes, fn.restype = like.argtypes, like.restype
            return fn
        return pick

    def use(self, which: str) -> None:
        libs = self.parent if which == "earlier" else self.current
        for name, mod in self.mods.items():
            mod._lib = libs[name]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_parent_kernels: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
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
    swap = Swap(build_parent(Path(argv[0]).resolve()))
    rng = np.random.default_rng(0)
    results = {"device": smi}

    def turns(label, fn):
        """fn() -> (ms, extra) in the order earlier, current, current, earlier."""
        rows = {"earlier": [], "current": []}
        for which in ("earlier", "current", "current", "earlier"):
            swap.use(which)
            ms, extra = fn()
            rows[which].append(ms)
            print(f"{label} [{which}]: {ms:.3f} ms {extra}  [{smi}]", flush=True)
            results.setdefault(label, {})[which + "_extra"] = extra
        swap.use("current")
        for which, v in rows.items():
            results[label][which + "_ms"] = v

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    # ---- fixed iterations at the main paths' shapes ----
    xs, w0, h0 = (tensor(a) for a in (rng.random((1024, 200, 8)),
                                      np.abs(rng.standard_normal((1024, 200, 4))),
                                      np.abs(rng.standard_normal((1024, 4, 8)))))
    turns("cd 50 iterations 1024x200x8 k=4",
          lambda: (cuda_ms(lambda: cd_cuda.cd_iterations_cuda(xs, w0, h0, 50)), ""))
    turns("mu 50 iterations 1024x200x8 k=4",
          lambda: (cuda_ms(lambda: mu_cuda.mu_iterations_cuda(xs, w0, h0, 50)), ""))
    turns("kl 50 iterations 1024x200x8 k=4", lambda: (cuda_ms(
        lambda: beta_cuda.beta_iterations_cuda(xs, w0, h0, 50, 1.0)), ""))
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

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def grid_fit(fit, g):
        ms, st = timed(lambda: fit(*g))
        n_iter = st.n_iter.view(4, -1).cpu()
        return ms, {"iterations": int(n_iter.sum()),
                    "median_by_rank": n_iter.float().median(dim=1).values.tolist()}

    def lone(fit, i):
        """The fit ``i`` alone on the card: one fit's iteration latency."""
        idx = torch.tensor([i], device=dev)
        ms, st = timed(lambda: fit(idx))
        iters = int(st.n_iter[0])
        return ms, {"iterations": iters, "us_per_iteration": ms / iters * 1e3}

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
