"""PyTorch port: K2's warp entry runs on the CPU, over each fit's own rank.

K2's warp entry (``csrc/cd_nmf.cu``, ``cd_nmf_warp_f32``: one warp a fit,
its rows in registers, shuffles between the lanes) has no CPU mode.
Here it is compiled with g++ against the stand-in CUDA runtime
(``tests/support/cuda_emu/cuda_runtime.h``: a thread per CUDA thread,
``__syncwarp`` a barrier a warp, the xor shuffles through a per-warp
exchange), as ``tests/test_torch_grid_emulated.py`` builds the grid
entries, and called through ctypes with the wrapper's own argument
types:

- rank sweeps as ``rank_sweep_batch`` pads them (ranks 1-4 to 4 at 200 x
  8, ranks 5-8 to 8 at 224 x 16), with and without sklearn's penalties:
  fixed iterations within 1e-5 relative of the plain float64 version,
  and fits with the stop on at a median stopping gap of 0;
- the per-fit rank is exact: a padded fit of a sweep equals, bit for
  bit, the same fit launched alone at its own rank (rank 1 in a KMAX-4
  launch, ranks 1 and 5 in a KMAX-8 one), and its padding stays 0;
- frames whose rows leave a lane's last row masked (N = 33), one column,
  and one row.

What this cannot show: speed, registers, and what nvcc refuses;
``tests/test_torch_gpu.py`` runs the same checks on the card.  Skips
where g++ is missing::

    python -m pytest tests/test_torch_warp_emulated.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_grid_emulated import build_emulated  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu_torch.models.kernels import cd_cuda  # noqa: E402

PENALTIES = (0.01, 0.05, 0.02, 0.03)  # l1_w, l2_w, l1_h, l2_h


@pytest.fixture(scope="module")
def warp(tmp_path_factory):
    """``run(x, w0, h0, iters, stop, tol, regs)`` on the emulated warp
    entry: (w, h, n_iter, violation_init) as numpy arrays."""
    lib = build_emulated(tmp_path_factory.mktemp("cuda_emu_warp"), ("cd_nmf",))["cd_nmf"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cd_cuda, "load", lambda name: lib)
        fn = cd_cuda._lib("warp")

    def run(x, w0, h0, iters, stop, tol=1e-3, regs=(0.0, 0.0, 0.0, 0.0)):
        x, w0, h0 = (np.ascontiguousarray(a, dtype=np.float32) for a in (x, w0, h0))
        b, n, l = x.shape
        k = w0.shape[-1]
        assert cd_cuda.route(n, l, k) == "warp"
        w, h = np.full_like(w0, np.nan), np.full_like(h0, np.nan)
        n_iter, converged = np.zeros(b, np.int32), np.zeros(b, np.int32)
        viol_init = np.zeros(b, np.float32)
        ptr = [a.ctypes.data for a in (x, w0, h0, w, h, n_iter, viol_init, converged)]
        err = fn(*ptr, b, n, l, k, iters, tol, *regs, int(stop), None)
        assert err == 0, err
        return w, h, n_iter, viol_init

    return run


def _sweep(n, l, ranks, top, trials=2, seed=0):
    """A rank sweep's launch, rank-major as ``rank_sweep_batch`` stacks
    it: ``trials`` frames at each rank, the factors zero-padded to
    ``top``."""
    rng = np.random.default_rng(seed + n + l + top)
    x = rng.random((trials, n, l)) + 0.05
    xs, ws, hs = [], [], []
    for k in ranks:
        w = np.zeros((trials, n, top))
        h = np.zeros((trials, top, l))
        w[..., :k] = np.abs(rng.standard_normal((trials, n, k)))
        h[:, :k] = np.abs(rng.standard_normal((trials, k, l)))
        xs.append(x)
        ws.append(w)
        hs.append(h)
    return np.concatenate(xs), np.concatenate(ws), np.concatenate(hs)


def _rel(got, want):
    got = torch.from_numpy(got).double()
    return float((got - want).abs().max() / want.abs().max())


# (rows, channels, ranks, top, penalized)
SWEEPS = {"200x8 ranks 1-4": (200, 8, (1, 2, 3, 4), 4, False),
          "224x16 ranks 5-8": (224, 16, (5, 6, 7, 8), 8, False),
          "200x8 ranks 1-4 penalized": (200, 8, (1, 2, 3, 4), 4, True),
          "224x16 ranks 5-8 penalized": (224, 16, (5, 6, 7, 8), 8, True),
          "33x5 ranks 1-3": (33, 5, (1, 2, 3), 3, False),
          "1x1 rank 1": (1, 1, (1,), 1, False)}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_emulated_cd_warp_sweep_matches_plain_float64(warp, case):
    """5 fixed iterations of every fit within 1e-5 relative of the plain
    version in float64; then fits with the stop on (tol 1e-3) stop where
    the float64 fits stop (median gap 0), and the padding stays 0."""
    n, l, ranks, top, penalized = SWEEPS[case]
    regs = PENALTIES if penalized else (0.0,) * 4
    x, w0, h0 = _sweep(n, l, ranks, top)
    x64, w64, h64 = (torch.from_numpy(a.astype(np.float32)).double() for a in (x, w0, h0))
    w, h, _, _ = warp(x, w0, h0, 5, False)
    wp, hp = cd_cuda.cd_iterations_plain(x64, w64, h64, 5)
    assert _rel(w, wp) < 1e-5 and _rel(h, hp) < 1e-5, (_rel(w, wp), _rel(h, hp))
    w, h, n_iter, _ = warp(x, w0, h0, 100, True, 1e-3, regs)
    sp = cd_cuda.fit_cd_plain(x64, w64, h64, max_iter=100, tol=1e-3, l1_reg_w=regs[0],
                              l2_reg_w=regs[1], l1_reg_h=regs[2], l2_reg_h=regs[3])
    gap = n_iter - sp.n_iter.numpy()
    assert np.median(gap) == 0, (n_iter, sp.n_iter)
    for i, k in enumerate(np.repeat(ranks, len(x) // len(ranks))):
        assert (w[i, :, k:] == 0).all() and (h[i, k:] == 0).all()


# (rows, channels, the sweep's ranks, its top rank, the rank held alone)
PADDED = {"rank 1 in a KMAX-4 sweep": (200, 8, (1, 2, 3, 4), 4, 1),
          "rank 5 in a KMAX-8 sweep": (224, 16, (5, 6, 7, 8), 8, 5),
          "rank 1 in a KMAX-8 sweep": (200, 8, (1, 8), 8, 1)}


@pytest.mark.parametrize("case", list(PADDED))
def test_emulated_cd_warp_padded_fit_equals_its_own_rank(warp, case):
    """A fit padded to the sweep's top rank computes the same bits as the
    same fit launched alone at its own rank: fixed iterations, and a fit
    with the stop on (the same iterations and violation too)."""
    n, l, ranks, top, k = PADDED[case]
    x, w0, h0 = _sweep(n, l, ranks, top, seed=7)
    per = len(x) // len(ranks)
    at = slice(ranks.index(k) * per, (ranks.index(k) + 1) * per)
    alone = (x[at], w0[at, :, :k], h0[at, :k])
    for iters, stop in ((6, False), (100, True)):
        swept = warp(x, w0, h0, iters, stop, 1e-4)
        own = warp(*alone, iters, stop, 1e-4)
        assert np.array_equal(swept[0][at, :, :k], own[0])
        assert np.array_equal(swept[1][at, :k], own[1])
        assert (swept[0][at, :, k:] == 0).all() and (swept[1][at, k:] == 0).all()
        if stop:
            assert np.array_equal(swept[2][at], own[2]) and np.array_equal(swept[3][at], own[3])
            assert (own[2] > 1).all(), own[2]


def test_emulated_cd_warp_zero_fit_stops_at_once(warp):
    """A fit whose W0 and H0 are all 0 (rank 0) stays 0 and stops at
    iteration 1 (its violation is 0), beside a fit that runs."""
    x, w0, h0 = _sweep(200, 8, (0, 2), 2)
    w, h, n_iter, viol_init = warp(x, w0, h0, 50, True, 1e-4)
    assert (w[:2] == 0).all() and (h[:2] == 0).all()
    assert (n_iter[:2] == 1).all() and (viol_init[:2] == 0).all()
    assert (n_iter[2:] > 1).all()


@pytest.mark.parametrize("alive", ["W0 column only", "H0 row only"])
def test_emulated_cd_warp_rank_counts_either_factor(warp, alive):
    """The fit's rank counts a component that is nonzero in W0's column
    or in H0's row alone (the other factor's update brings it to life):
    such a component past the others runs, and the fit matches float64
    within 1e-5 after 5 iterations and at the stop."""
    x, w0, h0 = _sweep(200, 8, (4,), 4, trials=4, seed=11)
    if alive == "W0 column only":
        h0[:, 2:] = 0  # components 2 and 3 live in W0 alone
    else:
        w0[..., 2:] = 0  # ... in H0 alone
    x64, w64, h64 = (torch.from_numpy(a.astype(np.float32)).double() for a in (x, w0, h0))
    w, h, _, _ = warp(x, w0, h0, 5, False)
    wp, hp = cd_cuda.cd_iterations_plain(x64, w64, h64, 5)
    assert _rel(w, wp) < 1e-5 and _rel(h, hp) < 1e-5, (_rel(w, wp), _rel(h, hp))
    assert (w[..., 3] > 0).any() and (h[:, 3] > 0).any()
    w, h, n_iter, _ = warp(x, w0, h0, 100, True, 1e-3)
    sp = cd_cuda.fit_cd_plain(x64, w64, h64, max_iter=100, tol=1e-3)
    assert np.median(n_iter - sp.n_iter.numpy()) == 0, (n_iter, sp.n_iter)


def test_emulated_cd_div_is_the_ieee_division(tmp_path):
    """``cd_div`` (the warp entry's quotient from a shared reciprocal and
    two corrections) returns the IEEE division's bits wherever
    ``cd_div_ok`` holds for both operands: 2e7 random pairs over
    exponents -60..59 (mantissas at random, near all ones and near powers
    of two, both signs, zeros); ``cd_div_ok`` refuses what lies outside."""
    import ctypes
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from muscle_synergies_tpu_torch import _build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source's functions against the stand-in")
    src = (_build.CSRC / "cd_nmf.cu").read_text()
    funcs = [re.search(r"__device__ __forceinline__ (float|bool) %s\(.*?\n}\n" % name, src,
                       re.S).group(0) for name in ("cd_div", "cd_div_ok")]
    harness = tmp_path / "div.cpp"
    harness.write_text("\n".join([
        '#include "cuda_runtime.h"', "#include <cstdint>", "#include <cstring>",
        "#include <random>", *funcs, r'''
static float from_bits(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
extern "C" long cd_div_mismatches(unsigned long seed, long n) {
  std::mt19937_64 g(seed);
  long bad = 0;
  for (long i = 0; i < n; ++i) {
    uint32_t mb = g() & 0x7fffff, ma = g() & 0x7fffff;
    if (i % 7 == 0) mb = 0x7fffff - (g() & 0xff);
    if (i % 11 == 0) ma = g() & 0xff;
    const uint32_t eb = 127 + (int)(g() % 120) - 60, ea = 127 + (int)(g() % 120) - 60;
    const float b = from_bits((eb << 23) | mb);
    const float a = i % 101 == 0 ? 0.0f : from_bits(((uint32_t)(g() & 1) << 31) | (ea << 23) | ma);
    if (!cd_div_ok(a) || !cd_div_ok(b)) return -1;
    const float want = a / b, got = cd_div(a, b, 1.0f / b);
    bad += std::memcmp(&want, &got, 4) != 0;
  }
  return bad;
}
extern "C" int cd_div_refuses(float v) { return !cd_div_ok(v); }
''']))
    lib = tmp_path / "libdiv.so"
    out = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                          "-I", str(Path(__file__).resolve().parent / "support" / "cuda_emu"),
                          str(harness), "-o", str(lib)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    dll = ctypes.CDLL(str(lib))
    dll.cd_div_mismatches.restype = ctypes.c_long
    dll.cd_div_mismatches.argtypes = [ctypes.c_ulong, ctypes.c_long]
    dll.cd_div_refuses.argtypes = [ctypes.c_float]
    assert dll.cd_div_mismatches(19, 20_000_000) == 0
    for v in (2.0 ** 61, -(2.0 ** 61), 2.0 ** -61, 1e-40, float("inf"), float("nan")):
        assert dll.cd_div_refuses(v), v
    for v in (0.0, -0.0, 2.0 ** 60, 2.0 ** -60, 1.0, -3.5):
        assert not dll.cd_div_refuses(v), v
