#!/usr/bin/env python3
"""Time the cluster entries of K1 (MU) and K2 (CD) on one card.

Builds ``mu_nmf`` and ``cd_nmf`` from the package under ``--root`` (the
repository by default; point it at an unpacked ``git archive`` of
another commit to compare two versions), prints each cluster kernel's
registers and spills from ``nvcc -Xptxas -v``, then for each case
checks 50 fixed iterations against the plain version in float64 and
times 200 iterations with CUDA events (the best of 3), one JSON line a
case, beside the card's name and power limit.  Each line carries a
digest of the 50 iterations' factors (``sha256`` of their bytes), so
two trees that compute the same bits print the same digests.  The cases are the
large-frame shapes of ``chip_smoke.py``'s phase 22: 124,460 x 8 and
20,000 x 8 at rank 4, one fit alone and 4 at once, and 124,460 x 8 at
rank 8 alone.  To compare two trees, run them alternately (A, B, B, A)
in one session::

    python3 scripts/torch_cluster_timing.py [--root DIR] [--build-only]

Without a CUDA card it exits with code 2 and runs nothing.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(1, 124_460, 8, 4), (4, 124_460, 8, 4), (1, 20_000, 8, 4), (4, 20_000, 8, 4),
         (1, 124_460, 8, 8)]
ITERS = 200


def ptxas_summary(log: str) -> list:
    """``(kernel, registers, spill store bytes)`` of every cluster kernel in
    an ``nvcc -Xptxas -v`` report."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*cluster_kernel\S*)'", line)
        if m:
            name = m.group(1)
            spill = None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, spill))
            name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="directory holding the package")
    ap.add_argument("--build-only", action="store_true", help="build, report, stop")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cluster_timing: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import muscle_synergies_tpu_torch as pkg
    from muscle_synergies_tpu_torch import _build
    from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda

    assert os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) == root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    _build.build_all(("mu_nmf", "cd_nmf"))
    for name in ("mu_nmf", "cd_nmf"):
        log = _build._library_path(name).with_suffix(".log").read_text()
        for kernel, regs, spill in ptxas_summary(log):
            print(json.dumps({"root": args.root, "ptxas": kernel, "registers": regs,
                              "spill_store_bytes": spill}), flush=True)
    if args.build_only:
        return 0

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def best_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            events[0].record()
            fn()
            events[1].record()
            torch.cuda.synchronize()
            times.append(events[0].elapsed_time(events[1]))
        return min(times)

    entries = (("mu_nmf_cluster", mu_cuda, mu_cuda.mu_iterations_cuda,
                mu_cuda.mu_iterations_plain),
               ("cd_nmf_cluster", cd_cuda, cd_cuda.cd_iterations_cuda,
                cd_cuda.cd_iterations_plain))
    for b, n, l, k in CASES:
        x, w, h = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.random((b, n, l)), np.abs(rng.standard_normal((b, n, k))),
            np.abs(rng.standard_normal((b, k, l)))))
        for name, mod, kern, plain in entries:
            before = mod.cluster_launches
            wk, hk = kern(x, w, h, 50)
            assert mod.cluster_launches == before + 1, f"{name} took another entry"
            wp, hp = plain(x.double(), w.double(), h.double(), 50)
            err = max(float(((a.double() - c).abs().amax() / c.abs().amax()).item())
                      for a, c in ((wk, wp), (hk, hp)))
            assert err <= 1e-3, f"{name} disagrees with float64 at {b}x{n}x{l} k={k}: {err}"
            digest = hashlib.sha256(wk.cpu().numpy().tobytes()
                                    + hk.cpu().numpy().tobytes()).hexdigest()[:16]
            ms = best_ms(lambda: kern(x, w, h, ITERS))
            print(json.dumps({"root": args.root, "kernel": name, "shape": f"{b}x{n}x{l}",
                              "k": k, "us_per_iteration": ms / ITERS * 1e3,
                              "rel_err_50": err, "digest_50": digest, "card": smi}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
