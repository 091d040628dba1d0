#!/usr/bin/env python3
"""The host cost of a one-process NCCL ``all_reduce``, as calls accumulate.

The sharded solvers issue two or three ``all_reduce``s an iteration; on
a one-card machine their group has one process.  This script times
blocks of 1,000 calls of a ``(1024, 4, 8)`` float32 ``all_reduce`` on a
``(1, 1)`` mesh's time group, after 0, 5,000 and 20,000 earlier calls,
in a fresh process for each of a few ``TORCH_NCCL_*`` settings (the
default first), and prints microseconds a call beside the card's name
and power limit.  From the repository root::

    python3 scripts/torch_nccl_overhead.py

Without a CUDA card it exits with code 2 and runs nothing.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = [
    {},
    {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0"},
    {"TORCH_NCCL_ENABLE_MONITORING": "0"},
    {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"},
]


def measure() -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from muscle_synergies_tpu_torch import parallel

    parallel.init_distributed()
    group = parallel.make_mesh((1, 1)).get_group(1)
    y = torch.rand((1024, 4, 8), device="cuda")
    done, out = 0, []
    for upto in (0, 5_000, 20_000):
        while done < upto:
            dist.all_reduce(y.clone(), group=group)
            done += 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(1_000):
            dist.all_reduce(y.clone(), group=group)
        torch.cuda.synchronize()
        done += 1_000
        out.append(f"after {upto:,}: {(time.perf_counter() - t) * 1e3:.1f} us")
    print("; ".join(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nccl_overhead: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        measure()
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}; {smi}", flush=True)
    for extra in SETTINGS:
        run = subprocess.run([sys.executable, __file__, "--measure"],
                             env={**os.environ, **extra}, capture_output=True,
                             text=True, timeout=600)
        label = ", ".join(f"{k}={v}" for k, v in extra.items()) or "default"
        lines = run.stdout.strip().splitlines()
        print(f"{label}: {lines[-1] if lines else run.stderr[-500:]} a call "
              f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
