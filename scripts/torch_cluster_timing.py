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
rank 12 (its KMAX-16 kernels) for the same three betas.

The block-range cases (``--cases block``) are frames within one block's
shared memory, where the block entries of K1 and K4 and their grid
entries both run: K1 on 2,400 x 8 at rank 4 in batches of 1 to 1,024
(the bootstrap's 51 fits among them), 16 x 2,000 x 8, and 225 x 8 and
4,000 x 8 in batches of 4 and 1,024, and 1,024 fits beside the warp limits (200 x
8 at rank 9, 200 x 17, 225 x 16 at rank 8), 200 x 8 at rank 9 in batches
of 264 and 528, and 768 fits of 200 x 16 at rank 12; K4 for KL, IS and beta 1.5
on 2,000 x 8 in batches of 4, 16, 132 and 1,024, on 1,024 fits of 200 x
8 for beta 1.5 and -0.5 and for IS at rank 6, and about the crossover:
200 x 8 at beta 1.5 in batches of 132 to 2,048 and IS at rank 6 in
batches of 528 and 792, KL on 300 x 8 and beta 1.5 on 600 x 8 in batches
of 528 and 1,024; K2 on K1's 2,400 x 8 batches (and 528 fits), 16 x
2,000 x 8, 8 x 300 x 8, 225 x 8 and 4,000 x 8 in batches of 4 and 1,024,
K1's cases beside the warp limits, and 200-row frames of 8 to 16
channels at ranks 9 to 16 in batches of 528 to 2,048.  ``--kernels``
picks whose cases run (``mu``, ``cd``, ``beta``; all by default).
``--entries`` picks how each runs: ``routed`` (the tree's own route;
the line names the entry it took), ``block`` or ``cluster`` (that
entry, forced, where it takes the frame); a grid launch's line carries
its plan and the blocks a SM the card held (``null`` where the tree does
not report them).  A case whose 50 iterations stray past 1e-3 of
float64 is named on stderr at the end, and the run exits 1.  To compare
two trees, run them alternately (A, B, B, A) on one card, one command
after another.  ``--cases e2e`` times the user's call on a subject's
2,400 x 8 matrix instead: ``find_synergies``' array core over ranks 1-4
in one batched launch, with MU and with the KL loss (wall time with the
init, the best of 3, beside the launches of each entry), and with CD,
the default solver, twice: the default ``sweep="loop"`` (one launch a
rank, a batch of one each) and ``sweep="batched"`` (one launch of 4
fits)::

    python3 scripts/torch_cluster_timing.py [--root DIR] [--build-only]
        [--cases all|capture|block|e2e] [--entries routed,block,cluster]
        [--kernels mu,cd,beta]

Without a CUDA card it exits with code 2 and runs nothing.
"""

import argparse
import contextlib
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
# the block-range cases: (batch, n, l, k) for K1, (batch, n, l, k, beta) for K4
# (the last rows: frames beside the warp limits and batches about the
# crossover of K4's two entries)
MU_BLOCK_CASES = ([(b, 2_400, 8, 4) for b in (1, 4, 16, 51, 66, 132, 264, 1_024)]
                  + [(16, 2_000, 8, 4)]
                  + [(b, n, 8, 4) for n in (225, 4_000) for b in (4, 1_024)]
                  + [(1_024, 200, 8, 9), (1_024, 200, 17, 4), (1_024, 225, 16, 8)]
                  + [(264, 200, 8, 9), (528, 200, 8, 9), (768, 200, 16, 12)])
# K2: K1's subject-length batches, 16 x 2,000 x 8 (chip_smoke's phases
# 3-4), 8 x 300 x 8 (the card tests' frame), and K1's frames beside the
# warp limits
CD_BLOCK_CASES = ([(b, 2_400, 8, 4) for b in (1, 4, 16, 51, 132, 264, 528, 1_024)]
                  + [(16, 2_000, 8, 4), (8, 300, 8, 4)]
                  + [(b, n, 8, 4) for n in (225, 4_000) for b in (4, 1_024)]
                  + [(1_024, 200, 8, 9), (1_024, 200, 17, 4), (1_024, 225, 16, 8)]
                  + [(264, 200, 8, 9), (528, 200, 8, 9), (768, 200, 16, 12)]
                  # about the crossover at ranks past 8, by channels
                  + [(b, 200, 16, k) for k in (9, 12) for b in (528, 1_024)]
                  + [(2_048, 200, 16, 12), (1_024, 200, 16, 16), (1_024, 200, 12, 12),
                     (1_024, 200, 10, 10), (1_024, 100, 16, 12), (1_024, 200, 8, 12),
                     (1_024, 200, 8, 16), (2_048, 200, 8, 9)])
BETA_BLOCK_CASES = ([(b, 2_000, 8, 4, beta) for beta in BETAS
                     for b in (4, 16, 132, 1_024)]
                    + [(1_024, 200, 8, 4, 1.5), (1_024, 200, 8, 4, -0.5),
                       (1_024, 200, 8, 6, 0.0)]
                    + [(b, 200, 8, 4, 1.5) for b in (132, 264, 528, 792, 2_048)]
                    + [(b, 200, 8, 6, 0.0) for b in (528, 792)]
                    + [(b, 300, 8, 4, 1.0) for b in (528, 1_024)]
                    + [(b, 600, 8, 4, 1.5) for b in (528, 1_024)])
COUNTERS = {"warp": "warp_launches", "block": "launches", "cluster": "cluster_launches"}
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


def takes_block(mod, n, l, k, beta=None) -> bool:
    """Whether the block entry of K1 (``beta`` None) or K4 holds one fit."""
    if beta is None:
        return mod.smem_bytes(n, l, k) <= 227 * 1024
    return mod.smem_bytes(n, l, k, kl=beta == 1.0) <= 227 * 1024


def block_cases(mods, run, positive, normal, entries, kernels) -> None:
    """The block-range cases of K1, K2 and K4 (``mods``: name -> wrapper
    module) on each of ``entries``, for the kernels named in ``kernels``."""
    frobenius = (("mu", "mu_nmf", MU_BLOCK_CASES, "mu_iterations"),
                 ("cd", "cd_nmf", CD_BLOCK_CASES, "cd_iterations"))
    for key, name, cases, fn in frobenius:
        if key not in kernels:
            continue
        mod = mods[key]
        for b, n, l, k in cases:
            x, w, h = positive(b, n, l), normal(b, n, k), normal(b, k, l)
            for entry in entries:
                if entry != "block" or takes_block(mods["mu"], n, l, k):
                    run(name, mod, getattr(mod, f"{fn}_cuda"), getattr(mod, f"{fn}_plain"),
                        (x, w, h), f"{b}x{n}x{l}", k, entry, None)
            del x, w, h
    if "beta" not in kernels:
        return
    beta_cuda = mods["beta"]
    for b, n, l, k, beta in BETA_BLOCK_CASES:
        x, w, h = positive(b, n, l) + 0.05, normal(b, n, k), normal(b, k, l)

        def kern(x_, w_, h_, it, beta=beta):
            return beta_cuda.beta_iterations_cuda(x_, w_, h_, it, beta)

        def plain(x_, w_, h_, it, beta=beta):
            return beta_cuda.beta_iterations_plain(x_, w_, h_, it, beta)

        for entry in entries:
            if entry != "block" or takes_block(beta_cuda, n, l, k, beta):
                run("beta_nmf", beta_cuda, kern, plain, (x, w, h), f"{b}x{n}x{l}", k,
                    entry, None, beta=beta)
        del x, w, h


def subject_sweeps(torch, root, smi) -> None:
    """``find_synergies``' array core on a seeded 2,400 x 8 subject matrix
    (4 smooth activations mixing into 8 muscles, with noise), ranks 1-4:
    MU and KL in one batched sweep, CD (the default solver) in the
    default loop (one fit a rank) and in one batched sweep; wall time and
    each entry's launches."""
    import time

    from muscle_synergies_tpu_torch.models import select
    from muscle_synergies_tpu_torch.models.kernels import beta_cuda, cd_cuda, mu_cuda

    rng = np.random.default_rng(11)
    t = np.arange(2_400) / 200.0
    acts = np.abs(np.sin(np.pi * (t[:, None] * (1 + 0.1 * np.arange(4)) + rng.random(4))))
    x = (acts @ rng.random((4, 8)) + 0.02 * rng.random((2_400, 8))).astype(np.float32)
    for label, mod, kw in (("mu", mu_cuda, dict(solver="mu", sweep="batched")),
                           ("kl", beta_cuda, dict(solver="mu", sweep="batched",
                                                  beta_loss="kullback-leibler")),
                           ("cd loop", cd_cuda, dict(solver="cd")),
                           ("cd batched", cd_cuda, dict(solver="cd", sweep="batched"))):
        def call():
            return select._find_synergies_arrays(x, 1, 4, **kw)

        call()
        before = {e: getattr(mod, c, 0) for e, c in COUNTERS.items()}
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {e: getattr(mod, c, 0) - before[e] for e, c in COUNTERS.items()}
        print(json.dumps({"root": root, "e2e": f"find_synergies {label} 2400x8, ranks 1-4",
                          "wall_ms": min(times) * 1e3, "launches_3_calls": launches,
                          "card": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="directory holding the package")
    ap.add_argument("--build-only", action="store_true", help="build, report, stop")
    ap.add_argument("--cases", default="all", choices=("all", "capture", "block", "e2e"),
                    help="the capture-length cases, the block-range cases, both, or "
                         "find_synergies on a subject's matrix")
    ap.add_argument("--entries", default="routed",
                    help="comma list of routed, block, cluster (block-range cases)")
    ap.add_argument("--kernels", default="mu,cd,beta",
                    help="comma list of mu, cd, beta: whose block-range cases run")
    args = ap.parse_args()
    entries = args.entries.split(",")
    assert set(entries) <= {"routed", "block", "cluster"}, entries
    kernels = args.kernels.split(",")
    assert set(kernels) <= {"mu", "cd", "beta"}, kernels
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

    @contextlib.contextmanager
    def forced(mod, entry):
        """``mod``'s launches take ``entry`` whatever its route says."""
        if entry == "routed":
            yield
            return
        saved = mod.route
        mod.route = lambda *a, **kw: entry
        try:
            yield
        finally:
            mod.route = saved

    failed = []  # the cases whose 50 iterations strayed past 1e-3 of float64

    def finish() -> int:
        for msg in failed:
            print(f"torch_cluster_timing: {msg}", file=sys.stderr)
        return 1 if failed else 0

    def run(name, mod, kern, plain, inputs, shape, k, entry="routed", expect="cluster",
            **extra):
        """50 iterations against float64, their digest, 200 timed, on
        ``entry`` (``"routed"``: whichever the route picks, which must be
        ``expect`` unless that is None)."""
        before = {e: getattr(mod, c, 0) for e, c in COUNTERS.items()}
        with forced(mod, entry):
            ak, bk = kern(*inputs, 50)
        took = [e for e, c in COUNTERS.items() if getattr(mod, c, 0) == before[e] + 1]
        assert len(took) == 1 and entry in ("routed", took[0]), f"{name} took {took}"
        assert expect in (None, took[0]), f"{name} took {took[0]}, not {expect}"
        plan = getattr(mod, "last_plan", None) if took[0] == "cluster" else None
        per_sm = getattr(mu_cuda, "blocks_per_sm", {}).get(name.replace("_cluster", ""))
        ap_, bp = plain(*(t.double() for t in inputs), 50)

        def rel(pair):
            return max(float(((a.double() - c).abs().amax() / c.abs().amax()).item())
                       for a, c in zip(pair, (ap_, bp)))

        err = rel((ak, bk))
        if err > 1e-3:
            # the run goes on to time the other cases and fails at its end
            failed.append(f"{name} ({entry}) disagrees with float64 at {shape} k={k}: "
                          f"{err} (bar 1e-3; the plain float32 version "
                          f"{rel(plain(*inputs, 50))})")
        digest = hashlib.sha256(ak.cpu().numpy().tobytes()
                                + bk.cpu().numpy().tobytes()).hexdigest()[:16]
        with forced(mod, entry):
            ms = best_ms(lambda: kern(*inputs, ITERS))
        line = {"root": args.root, "kernel": name, "shape": shape, "k": k, **extra,
                "us_per_iteration": ms / ITERS * 1e3, "rel_err_50": err,
                "digest_50": digest, "card": smi}
        if expect is None:
            line["entry"] = took[0]
            line["asked"] = entry
        if plan is not None:
            line["plan"] = plan._asdict()
            line["blocks_per_sm"] = per_sm
        print(json.dumps(line), flush=True)

    def positive(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)

    def normal(*shape):
        a = np.abs(rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    if args.cases == "e2e":
        subject_sweeps(torch, args.root, smi)
        return 0
    if args.cases in ("all", "block"):
        block_cases({"mu": mu_cuda, "cd": cd_cuda, "beta": beta_cuda}, run, positive,
                    normal, entries, kernels)
    if args.cases == "block":
        return finish()
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
    return finish()


if __name__ == "__main__":
    sys.exit(main())
