#!/usr/bin/env python3
"""Why K2 strays from float64 at ranks 9-16 on random frames: on the CPU.

The crossover runs of ``scripts/torch_cluster_timing.py`` (``--cases
block --kernels cd``, run from the cases after 768 x 200 x 16 at rank
12) found K2's block and grid entries 1.75e-3 (rank 9) and 1.4e-2
(rank 16) from float64 after 50 unpenalized iterations on 1,024 random
frames of 200 x 16, up to 15x further than the plain float32 version on
the card.  This script replays those frames from the run's seed (numpy
only), runs 50 iterations of the plain version in float64 and in
float32 on the CPU, finds the fits furthest from float64, and for each:

- runs it on K2's block and grid entries compiled with g++ against the
  stand-in CUDA runtime (``tests/support/cuda_emu``), as the emulated
  tests build them;
- moves X by at most one float32 ulp at random (three draws) and runs
  float64 again: how far rounding-sized changes of the input carry the
  exact arithmetic;
- counts the entries that are 0 on one side only (a clamp of the
  projected step taken in one run and not the other).

It prints one JSON line a fit: each version's distance from float64
(max |a - b| over the batch's max |b|, the timing script's measure).
Needs g++.  With ``--card`` (on a machine with a CUDA card) it also runs
each whole batch through K2 on the card, as its route takes it, and the
plain float32 version there, and names the three fits furthest from
float64 for each::

    python3 scripts/torch_cd_stray.py [--card]
"""

from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

# the second crossover run's cases up to rank 16, in its order, seed 0
CASES = [(528, 200, 16, 9), (1024, 200, 16, 9), (528, 200, 16, 12), (1024, 200, 16, 12),
         (2048, 200, 16, 12), (1024, 200, 16, 16)]
STUDIED = {(1024, 200, 16, 9), (1024, 200, 16, 16)}
ITERS = 50
WORST = 3


def main(argv) -> int:
    import torch

    card = "--card" in argv

    from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda
    from test_torch_grid_emulated import build_emulated

    torch.set_num_threads(8)
    lib = build_emulated(Path(tempfile.mkdtemp(prefix="cd_stray_")), ("cd_nmf",))["cd_nmf"]
    card_load = cd_cuda.load

    def entry(name, x, w0, h0):
        """ITERS fixed iterations of one fit on an emulated entry."""
        cd_cuda.load = lambda _: lib
        fn = cd_cuda._lib(name)
        cd_cuda.load = card_load
        b, n, l = x.shape
        k = w0.shape[-1]
        w, h = np.zeros_like(w0), np.zeros_like(h0)
        outs = [np.zeros(b, t) for t in (np.int32, np.float32, np.int32)]
        extra = ()
        if name == "cluster":
            lib.emu_set_sms(132)
            plan = mu_cuda.grid_plan(b, n, l, k, 132)
            floats = mu_cuda.grid_workspace_floats(plan, b, l, k)
            ws = np.zeros(floats, np.float32)
            extra = (ws.ctypes.data, floats, (ctypes.c_int * mu_cuda.GRID_PLAN_INTS)())
        ptrs = [a.ctypes.data for a in (x, w0, h0, w, h, *outs)]
        err = fn(*ptrs, b, n, l, k, ITERS, 0.0, 0.0, 0.0, 0.0, 0.0, 0, *extra, None)
        assert err == 0, err
        return w, h

    rng = np.random.default_rng(0)
    for case in CASES:
        b, n, l, k = case
        x = rng.random((b, n, l)).astype(np.float32)
        w0 = np.abs(rng.standard_normal((b, n, k))).astype(np.float32)
        h0 = np.abs(rng.standard_normal((b, k, l))).astype(np.float32)
        if case not in STUDIED:
            continue
        t = [torch.from_numpy(a) for a in (x, w0, h0)]
        wp, hp = cd_cuda.cd_iterations_plain(*(a.double() for a in t), ITERS)
        w32, h32 = cd_cuda.cd_iterations_plain(*t, ITERS)
        sw, sh = float(wp.abs().max()), float(hp.abs().max())

        def dist(w, h, f):
            w, h = (torch.as_tensor(a).double() for a in (w, h))
            return max(float((w - wp[f]).abs().max()) / sw, float((h - hp[f]).abs().max()) / sh)

        def one_sided(w, h, f):
            return int(((torch.as_tensor(w) == 0) != (wp[f] == 0)).sum()
                       + ((torch.as_tensor(h) == 0) != (hp[f] == 0)).sum())

        per_fit = torch.tensor([dist(w32[f], h32[f], f) for f in range(b)])
        if card:
            dev = torch.device("cuda", 0)
            on = [a.to(dev) for a in t]
            for label, fn in (("card_" + cd_cuda.route(n, l, k, batch=b, sms=cd_cuda.card_sms(
                    on[0])), cd_cuda.cd_iterations_cuda), ("card_plain_f32",
                                                          cd_cuda.cd_iterations_plain)):
                w, h = (a.cpu() for a in fn(*on, ITERS))
                far = torch.tensor([dist(w[f], h[f], f) for f in range(b)])
                top = torch.argsort(far, descending=True)[:3].tolist()
                print(json.dumps({"case": f"{b}x{n}x{l} k={k}", "run": label,
                                  "furthest_fits": {f: float(far[f]) for f in top}}),
                      flush=True)
        print(json.dumps({"case": f"{b}x{n}x{l} k={k}", "iterations": ITERS,
                          "plain_f32_cpu": float(per_fit.max()),
                          "fits_past_1e-3": int((per_fit > 1e-3).sum()),
                          "fits_past_1e-4": int((per_fit > 1e-4).sum())}), flush=True)
        draw = np.random.default_rng(k)
        for f in torch.argsort(per_fit, descending=True)[:WORST].tolist():
            one = [np.ascontiguousarray(a[f:f + 1]) for a in (x, w0, h0)]
            moved = []
            for _ in range(3):
                xm = torch.from_numpy(one[0]).double() * (
                    1 + torch.from_numpy(draw.integers(-1, 2, one[0].shape).astype(float))
                    * 2.0 ** -24)
                wm, hm = cd_cuda.cd_iterations_plain(
                    xm, *(torch.from_numpy(a).double() for a in one[1:]), ITERS)
                moved.append(dist(wm[0], hm[0], f))
            row = {"case": f"{b}x{n}x{l} k={k}", "fit": f,
                   "plain_f32_cpu": float(per_fit[f]),
                   "f64_x_moved_one_ulp": moved,
                   "one_sided_zeros_plain_f32": one_sided(w32[f], h32[f], f)}
            for name in ("block", "cluster"):
                w, h = entry(name, *one)
                row[f"{name}_entry"] = dist(w[0], h[0], f)
                row[f"one_sided_zeros_{name}"] = one_sided(w[0], h[0], f)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
