#!/usr/bin/env python3
"""Time the cluster entries of K1 (MU), K2 (CD), K4 (beta-MU) and K5 (cNMF) on one card.

Builds ``mu_nmf``, ``cd_nmf``, ``beta_nmf`` and ``cnmf`` from the package
under ``--root`` (the repository by default; point it at an unpacked
``git archive`` of another commit to compare two versions), prints every
kernel's registers and spills from ``nvcc -Xptxas -v`` (the cluster
kernels' KMAX from their template arguments), then for each case checks
50 fixed iterations against the plain version in float64 and times 200
iterations with CUDA events (the best of 3), one JSON line a case,
beside the card's name and power limit.  Each line carries a digest of
the 50 iterations' factors (``sha256`` of their bytes), so two trees
that compute the same bits print the same digests, and, where the tree
reports it, the plan the entry took (blocks a fit, rows a block,
resident or streamed).  The K1 and K2 cases are the large-frame shapes
of ``chip_smoke.py``'s phase 22: 124,460 x 8 and 20,000 x 8 at rank 4,
one fit alone and 4 at once, and 124,460 x 8 at rank 8 alone; K4 runs
124,460 x 8 fits at rank 4 for KL, IS and beta 1.5, and K5 at K = 4, D
= 10, each alone and 4 at once, then K4 on a lone 124,460 x 16 fit at
rank 12 (its KMAX-16 kernels) for the same three betas.  To compare two
trees, run them alternately (A, B, B, A) on one card, one command after
another::

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
BETAS = (1.0, 0.0, 1.5)
WIDE_BETA_CASE = (1, 124_460, 16, 12)  # K4's KMAX-16 kernels
ITERS = 200
SOURCES = ("mu_nmf", "cd_nmf", "beta_nmf", "cnmf", "sosfiltfilt")


def ptxas_summary(log: str) -> list:
    """``(kernel, KMAX, registers, spill store bytes)`` of every kernel in
    an ``nvcc -Xptxas -v`` report (KMAX from a cluster kernel's mangled
    template arguments, else None)."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            # KMAX: K1's and K2's first template argument, K4's second
            ints = re.findall(r"Li(\d+)E", name.split("cluster_kernel", 1)[-1]) \
                if "cluster_kernel" in name else []
            kmax = ints[1] if "beta_cluster" in name and len(ints) > 1 else (ints or [None])[0]
            out.append((name, int(kmax) if kmax else None, regs, spill))
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
    from muscle_synergies_tpu_torch.models.kernels import (
        beta_cuda,
        cd_cuda,
        cnmf_cuda,
        mu_cuda,
    )

    assert os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) == root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    _build.build_all(SOURCES)
    for name in SOURCES:
        log = _build._library_path(name).with_suffix(".log").read_text()
        for kernel, kmax, regs, spill in ptxas_summary(log):
            print(json.dumps({"root": args.root, "ptxas": kernel, "kmax": kmax,
                              "registers": regs, "spill_store_bytes": spill}),
                  flush=True)
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

    def run(name, mod, kern, plain, inputs, shape, k, **extra):
        """50 iterations against float64, their digest, 200 timed."""
        before = mod.cluster_launches
        ak, bk = kern(*inputs, 50)
        assert mod.cluster_launches == before + 1, f"{name} took another entry"
        plan = getattr(mod, "last_plan", None)
        ap_, bp = plain(*(t.double() for t in inputs), 50)
        err = max(float(((a.double() - c).abs().amax() / c.abs().amax()).item())
                  for a, c in ((ak, ap_), (bk, bp)))
        assert err <= 1e-3, f"{name} disagrees with float64 at {shape} k={k}: {err}"
        digest = hashlib.sha256(ak.cpu().numpy().tobytes()
                                + bk.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = best_ms(lambda: kern(*inputs, ITERS))
        line = {"root": args.root, "kernel": name, "shape": shape, "k": k, **extra,
                "us_per_iteration": ms / ITERS * 1e3, "rel_err_50": err,
                "digest_50": digest, "card": smi}
        if plan is not None:
            line["plan"] = plan._asdict()
        print(json.dumps(line), flush=True)

    def positive(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)

    def normal(*shape):
        a = np.abs(rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    for b, n, l, k in CASES:
        x, w, h = positive(b, n, l), normal(b, n, k), normal(b, k, l)
        run("mu_nmf_cluster", mu_cuda, mu_cuda.mu_iterations_cuda,
            mu_cuda.mu_iterations_plain, (x, w, h), f"{b}x{n}x{l}", k)
        run("cd_nmf_cluster", cd_cuda, cd_cuda.cd_iterations_cuda,
            cd_cuda.cd_iterations_plain, (x, w, h), f"{b}x{n}x{l}", k)
    n, l, k = CASES[0][1:]
    for b in (1, 4):
        x, w, h = positive(b, n, l) + 0.05, normal(b, n, k), normal(b, k, l)
        for beta in BETAS:
            def kern(x_, w_, h_, it, beta=beta):
                return beta_cuda.beta_iterations_cuda(x_, w_, h_, it, beta)

            def plain(x_, w_, h_, it, beta=beta):
                return beta_cuda.beta_iterations_plain(x_, w_, h_, it, beta)

            run("beta_nmf_cluster", beta_cuda, kern, plain, (x, w, h), f"{b}x{n}x{l}", k,
                beta=beta)
        c, s = normal(b, n, 4), normal(b, 4, 10, l)
        run("cnmf_cluster", cnmf_cuda, cnmf_cuda.cnmf_iterations_cuda,
            cnmf_cuda.cnmf_iterations_plain, (x, c, s), f"{b}x{n}x{l}", 4, d=10)
    # K4 at KMAX 16: a lone rank-12 fit of 16 channels
    b, n, l, k = WIDE_BETA_CASE
    x, w, h = positive(b, n, l) + 0.05, normal(b, n, k), normal(b, k, l)
    for beta in BETAS:
        def kern(x_, w_, h_, it, beta=beta):
            return beta_cuda.beta_iterations_cuda(x_, w_, h_, it, beta)

        def plain(x_, w_, h_, it, beta=beta):
            return beta_cuda.beta_iterations_plain(x_, w_, h_, it, beta)

        run("beta_nmf_cluster", beta_cuda, kern, plain, (x, w, h), f"{b}x{n}x{l}", k,
            beta=beta)
    return 0


if __name__ == "__main__":
    sys.exit(main())
