#!/usr/bin/env python3
"""K5's one-block entries by batch, on one card: where the wide entry
(``cnmf_wide_f32``) beats the block entry (``cnmf_f32``), and what the
wrapper's route makes of it.

Every fit is forced onto one entry with ``chip_smoke.cnmf_entry`` (each
call one launch) or left to the wrapper's own route ("route"):

- the time-varying path's fit (``chip_smoke.py``'s 256 synthetic trials
  under the default ``PipelineConfig``, 4 restarts a trial: 1,024 fits of
  200 x 8, K = 4, D = 10, the path's stop), in turns ``route, block,
  wide, wide, block, route`` for ``--rounds`` rounds (host clock around a
  synchronised call), each with its digest and iterations;
- the same fit on the path's first B fits (B across the wide entry's
  one-wave mark, 264 fits on 132 SMs), each way once in the same turns;
- 20 fixed iterations of B random 200 x 8 fits and of B 2,400 x 8 fits
  (K = 4, D = 10; CUDA events, 20 calls), on the block and wide entries
  and by the route, in turns ``block, wide, route, route, wide, block``.

With ``--nvcc-parent DIR`` (a directory holding an earlier ``cnmf.cu``
and ``nmf_common.cuh``) it first times ``nvcc`` on that source and on
the current one with the port's own flags, one at a time, in the order
earlier, current, current, earlier, and prints ptxas' register and spill
lines.  Each number is printed beside the card's name and power limit,
then one JSON line with all of them::

    python3 scripts/torch_cnmf_entries.py [--rounds 3] [--nvcc-parent DIR]

Without a CUDA card it exits with code 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PATH_BATCHES = (66, 132, 198, 264, 265, 330, 396, 528, 792)
FIXED_BATCHES = {(200, 8): (1, 66, 132, 198, 264, 265, 330, 396, 528, 792, 1024, 2048),
                 (2400, 8): (1, 51, 66, 132, 133, 198, 264, 528)}


def time_nvcc(parent: Path, out: Path, smi: str, results: dict) -> None:
    """nvcc's seconds on the earlier and the current ``cnmf.cu``, in turns."""
    from muscle_synergies_tpu_torch import _build

    out.mkdir(parents=True, exist_ok=True)
    for side in ("earlier", "current", "current", "earlier"):
        src = parent if side == "earlier" else _build.CSRC
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
               str(out / f"libcnmf_{side}.so"), str(src / "cnmf.cu")]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sec = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {side} cnmf.cu:\n{proc.stdout}{proc.stderr}")
        print(f"nvcc cnmf.cu [{side}]: {sec:.1f} s  [{smi}]", flush=True)
        results.setdefault(f"nvcc cnmf.cu {side} s", []).append(sec)
        if side == "current" and len(results[f"nvcc cnmf.cu {side} s"]) == 1:
            report = proc.stdout + proc.stderr
            for line in report.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}", flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_cnmf_entries: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--nvcc-parent", type=Path, default=None)
    args = parser.parse_args(argv)

    from chip_smoke import FS, cnmf_entry, cuda_ms, digest, synthetic_emg
    from muscle_synergies_tpu_torch import PipelineConfig, preprocess_trials
    from muscle_synergies_tpu_torch.models.cnmf import fit_cnmf_batch, init_cnmf
    from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    results: dict = {"card": smi}
    if args.nvcc_parent is not None:
        time_nvcc(args.nvcc_parent.resolve(), ROOT / "build" / "cnmf_entries", smi, results)
    dev = torch.device("cuda", 0)

    def on(way):
        return contextlib.nullcontext() if way == "route" else cnmf_entry(way)

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3, out

    config = PipelineConfig()
    stop = dict(max_iter=config.max_iter, tol=config.tol)
    xs = preprocess_trials(synthetic_emg(256, seed=2), FS, config)
    gx = xs.repeat_interleave(4, dim=0)
    tc, ts = (torch.from_numpy(a).to(dev) for a in init_cnmf(
        np.repeat(xs.cpu().numpy(), 4, axis=0), 4, 10))

    def path(b, way):
        with on(way):
            cnmf_cuda.launches = cnmf_cuda.wide_launches = 0
            ms, st = timed(lambda: fit_cnmf_batch(gx[:b], tc[:b], ts[:b], **stop))
            return ms, {"iterations": int(st.n_iter.sum()), "digest": digest(*st),
                        "launches": [cnmf_cuda.launches, cnmf_cuda.wide_launches]}

    for way in ("route", "block", "wide"):  # warm-up: build, first launches
        path(8, way)
    order = ("route", "block", "wide", "wide", "block", "route")
    digests = {}
    for r in range(args.rounds):
        for way in order:
            ms, extra = path(1024, way)
            print(f"path fit 1,024 fits [{way}] round {r}: {ms:.3f} ms {extra}  [{smi}]",
                  flush=True)
            results.setdefault(f"path fit 1024 {way} ms", []).append(ms)
            digests.setdefault(extra["digest"], set()).add(way)
    for b in PATH_BATCHES:
        for way in order:
            ms, extra = path(b, way)
            print(f"path fit first {b} fits [{way}]: {ms:.3f} ms {extra}  [{smi}]",
                  flush=True)
            results.setdefault(f"path fit {b} {way} ms", []).append(ms)
    assert len(digests) == 1, f"the ways' digests differ: {digests}"

    rng = np.random.default_rng(0)
    for (t, l), batches in FIXED_BATCHES.items():
        n = max(batches)
        x = rng.random((n, t, l))
        c0, s0 = init_cnmf(x, 4, 10, seed=5)
        x, c0, s0 = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, c0, s0))
        for b in batches:
            bits = set()
            for way in ("block", "wide", "route", "route", "wide", "block"):
                with on(way):
                    run = lambda: cnmf_cuda.cnmf_iterations_cuda(  # noqa: E731
                        x[:b], c0[:b], s0[:b], 20)
                    bits.add(digest(*run()))
                    ms = cuda_ms(run, reps=20, warmup=2)
                print(f"20 iterations {b}x{t}x{l} [{way}]: {ms:.4f} ms  [{smi}]", flush=True)
                results.setdefault(f"fixed {b}x{t}x{l} {way} ms", []).append(ms)
            assert len(bits) == 1, f"{b}x{t}x{l}: the entries' bits differ"
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
