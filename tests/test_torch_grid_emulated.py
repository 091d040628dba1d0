"""PyTorch port: the grid (cluster) entries of K1, K2, K4 and K5 run on the CPU.

The cluster entries spread one fit over many blocks of the card and
meet at barriers in device memory; their CUDA sources have no CPU mode.
Here they are compiled with g++ against a stand-in CUDA runtime
(``tests/support/cuda_emu/cuda_runtime.h``: every block of a launch at
once, a thread per CUDA thread, ``__syncthreads`` a barrier) and called
through ctypes with the wrappers' own argument types, on a stand-in card
of a few SMs, so that one fit spans several blocks:

- the plan each entry reports is its Python mirror's
  (``mu_cuda.grid_plan``, ``beta_cuda.grid_plan``, ``cnmf_cuda.grid_plan``),
  resident and streamed, with more fits than SMs, on the block-range
  frames a small batch sends to the grid entries of K1 and K4 (225 x 8
  on one block, 5 fits of 2,400 x 8 on 10 SMs at two blocks each, 200 x 8
  at beta 1.5 and -0.5 and for IS at rank 6), and for K1 planned for a
  larger batch than it runs (a checkpointed bootstrap's chunk); K2's on
  the same frames as K1's (a resident 2,000-row fit, 225 x 8, 5 x 2,400
  x 8 on 10 SMs, more fits than SMs);
- a few fixed iterations are within 1e-5 relative of the plain version
  in float64 (KL, Itakura-Saito, beta = 1.5 and -0.5; K5 with halos from
  the next block, from two and three blocks away, and none at D = 1);
- fits with the stop on stop within 10 iterations of the plain float64
  fit (the card's bar; K2, a Frobenius fit, at a median gap of 0).

What this cannot show: speed, registers, and what nvcc refuses (a
``__host__`` function called from device code compiles here);
``tests/test_torch_gpu.py`` runs the same entries on the card.  Skips
where g++ is missing.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu_torch import _build  # noqa: E402
from muscle_synergies_tpu_torch.models.beta import _gamma  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import (  # noqa: E402
    beta_cuda,
    cd_cuda,
    cnmf_cuda,
    mu_cuda,
)

EMU = Path(__file__).resolve().parent / "support" / "cuda_emu"
SOURCES = ("mu_nmf", "cd_nmf", "beta_nmf", "cnmf")
SUBS = [  # what g++ cannot read, as the stand-in runs it
    (re.compile(r"<<<[^>]*>>>"), ""),
    (re.compile(r"extern __shared__ (__align__\(16\) )?float smem\[\];"),
     "float* smem = emu_smem();"),
    (re.compile(r'asm volatile\("ld\.acquire.*$', re.M),
     "v = __atomic_load_n(p, __ATOMIC_ACQUIRE); std::this_thread::yield();"),
    (re.compile(r'asm volatile\("st\.release.*$', re.M),
     "__atomic_store_n(p, v, __ATOMIC_RELEASE);"),
]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The four sources built against the stand-in runtime, loaded."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources against the stand-in runtime")
    out = tmp_path_factory.mktemp("cuda_emu")
    for src in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / f"{n}.cu" for n in SOURCES]:
        text = src.read_text()
        for pat, rep in SUBS:
            text = pat.sub(rep, text)
        (out / src.name).write_text(text)
    procs = {n: subprocess.Popen(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(EMU), "-I",
         str(out), "-x", "c++", str(out / f"{n}.cu"), "-o", str(out / f"lib{n}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n in SOURCES}
    for n, p in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-3000:]
    return {n: ctypes.CDLL(str(out / f"lib{n}.so")) for n in SOURCES}


def _entry(libs, monkeypatch, mod, name, sms):
    """The cluster entry of ``name`` with the wrapper's argument types, on
    a stand-in card of ``sms`` SMs."""
    libs[name].emu_set_sms(sms)
    monkeypatch.setattr(mod, "load", lambda n: libs[n])
    return mod._lib("cluster")


def _ptr(a):
    return a.ctypes.data


def _workspace(plan, floats):
    ws = np.zeros(floats, np.float32)
    out = (ctypes.c_int * mu_cuda.GRID_PLAN_INTS)()
    return ws, out, (_ptr(ws), floats, out)


def _reported(out):
    return mu_cuda.GridPlan(out[0], out[1], bool(out[2]), out[3], out[4])


def _rel(got, want):
    got = torch.from_numpy(got).double()
    return float((got - want).abs().max() / want.abs().max())


def _factors(rng, *shapes):
    return [np.abs(rng.standard_normal(s)).astype(np.float32) + 0.05 for s in shapes]


# (batch, rows, channels, rank, beta, SMs, iterations, stop): resident
# plans over 4-8 blocks, two component and column tiles (rank 12, 12
# channels), streamed tiles (one block of 20,000 rows), more fits than
# SMs, and fits with the stop on
BETA_CASES = [(2, 1500, 8, 4, 1.0, 8, 5, False), (2, 1500, 8, 4, 0.0, 8, 5, False),
              (1, 1500, 8, 4, 1.5, 4, 4, False), (1, 1500, 8, 4, -0.5, 4, 4, False),
              (1, 1000, 12, 12, 1.0, 4, 3, False), (1, 20_000, 8, 4, 0.0, 1, 2, False),
              (3, 1200, 8, 4, 1.0, 2, 3, False), (2, 1500, 8, 4, 1.0, 4, 40, True),
              (1, 800, 16, 8, 1.5, 4, 20, True),
              # block-range frames, one block a fit
              (2, 200, 8, 4, 1.5, 4, 4, False), (2, 200, 8, 4, -0.5, 4, 4, False),
              (2, 200, 8, 6, 0.0, 4, 4, False), (1, 200, 8, 4, 1.5, 2, 30, True)]


@pytest.mark.parametrize("case", BETA_CASES, ids=[
    f"{b}x{n}x{l}k{k}b{beta:g}s{sms}{'stop' if st else ''}"
    for b, n, l, k, beta, sms, _, st in BETA_CASES])
def test_emulated_beta_grid_entry_matches_plain_float64(libs, monkeypatch, case):
    b, n, l, k, beta, sms, iters, with_stop = case
    fn = _entry(libs, monkeypatch, beta_cuda, "beta_nmf", sms)
    rng = np.random.default_rng(n + k)
    x, w0, h0 = _factors(rng, (b, n, l), (b, n, k), (b, k, l))
    w, h = np.zeros_like(w0), np.zeros_like(h0)
    n_iter, converged = np.zeros(b, np.int32), np.zeros(b, np.int32)
    prev_err = np.zeros(b, np.float32)
    plan = beta_cuda.grid_plan(b, n, l, k, sms, beta == 1.0)
    ws, out, extra = _workspace(plan, beta_cuda.grid_workspace_floats(plan, b, l, k))
    err = fn(_ptr(x), _ptr(w0), _ptr(h0), _ptr(w), _ptr(h), _ptr(n_iter), _ptr(prev_err),
             _ptr(converged), b, n, l, k, iters, beta, _gamma(beta), 1e-3, 10,
             0.0, 0.0, 0.0, 0.0, int(with_stop), *extra, None)
    assert err == 0 and _reported(out) == plan, (err, _reported(out), plan)
    xd, wd, hd = (torch.from_numpy(a).double() for a in (x, w0, h0))
    if with_stop:
        st = beta_cuda.fit_beta_plain(xd, wd, hd, beta, max_iter=iters, tol=1e-3)
        assert np.abs(n_iter - st.n_iter.numpy()).max() <= 10, (n_iter, st.n_iter)
    else:
        wp, hp = beta_cuda.beta_iterations_plain(xd, wd, hd, iters, beta)
        assert _rel(w, wp) < 1e-5 and _rel(h, hp) < 1e-5, (_rel(w, wp), _rel(h, hp))


# (batch, length, channels, synergies, lags, SMs, iterations, stop):
# resident over 4 blocks (halos from the next block), blocks of 200 rows
# under 399 lags (halos from up to three blocks away), D = 1 (no halo),
# 12 channels (two L-tiles), streamed tiles (with 16-byte loads, and
# without at 6 channels and 3 synergies), more fits than SMs, and fits
# with the stop on, resident and streamed
CNMF_CASES = [(1, 1200, 8, 4, 10, 4, 3, False), (1, 800, 8, 2, 400, 4, 2, False),
              (2, 1500, 8, 4, 1, 4, 3, False), (1, 1500, 12, 3, 7, 4, 3, False),
              (1, 12_000, 8, 4, 10, 2, 2, False), (1, 12_000, 6, 3, 7, 1, 2, False),
              (3, 1200, 8, 4, 10, 2, 2, False), (1, 1200, 8, 4, 10, 4, 40, True),
              (1, 9000, 8, 4, 10, 2, 20, True)]


@pytest.mark.parametrize("case", CNMF_CASES, ids=[
    f"{b}x{t}x{l}k{k}d{d}s{sms}{'stop' if st else ''}"
    for b, t, l, k, d, sms, _, st in CNMF_CASES])
def test_emulated_cnmf_grid_entry_matches_plain_float64(libs, monkeypatch, case):
    b, t, l, k, d, sms, iters, with_stop = case
    fn = _entry(libs, monkeypatch, cnmf_cuda, "cnmf", sms)
    rng = np.random.default_rng(t + d)
    x, c0, s0 = _factors(rng, (b, t, l), (b, t, k), (b, k, d, l))
    c, s = np.zeros_like(c0), np.zeros_like(s0)
    n_iter, converged = np.zeros(b, np.int32), np.zeros(b, np.int32)
    prev_err = np.zeros(b, np.float32)
    plan = cnmf_cuda.grid_plan(b, t, l, k, d, sms)
    ws, out, extra = _workspace(plan, cnmf_cuda.grid_workspace_floats(plan, b, l, k, d))
    err = fn(_ptr(x), _ptr(c0), _ptr(s0), _ptr(c), _ptr(s), _ptr(n_iter), _ptr(prev_err),
             _ptr(converged), b, t, l, k, d, iters, 1e-3, 10, int(with_stop), *extra, None)
    assert err == 0 and _reported(out) == plan, (err, _reported(out), plan)
    xd, cd, sd = (torch.from_numpy(a).double() for a in (x, c0, s0))
    if with_stop:
        st = cnmf_cuda.fit_cnmf_plain(xd, cd, sd, max_iter=iters, tol=1e-3)
        assert np.abs(n_iter - st.n_iter.numpy()).max() <= 10, (n_iter, st.n_iter)
    else:
        cp, sp = cnmf_cuda.cnmf_iterations_plain(xd, cd, sd, iters)
        assert _rel(c, cp) < 1e-5 and _rel(s, sp) < 1e-5, (_rel(c, cp), _rel(s, sp))


# (batch, rows, SMs, the plan's batch, blocks a fit)
MU_CASES = {"resident": (1, 2000, 4, 1, 4), "streamed": (1, 40_000, 4, 1, 4),
            "more-fits-than-SMs": (6, 1000, 4, 6, 1), "225-rows": (1, 225, 4, 1, 1),
            "5x2400-on-10": (5, 2400, 10, 5, 2), "2-planned-as-5": (2, 2400, 10, 5, 2)}


@pytest.mark.parametrize("case", list(MU_CASES))
def test_emulated_mu_grid_entry_matches_plain_float64(libs, monkeypatch, case):
    """K1's grid entry, whose helpers K4 and K5 share."""
    b, n, sms, plan_b, blocks = MU_CASES[case]
    fn = _entry(libs, monkeypatch, mu_cuda, "mu_nmf", sms)
    l, k, iters = 8, 4, 4
    x, w0, h0 = _factors(np.random.default_rng(n), (b, n, l), (b, n, k), (b, k, l))
    w, h = np.zeros_like(w0), np.zeros_like(h0)
    n_iter, converged = np.zeros(b, np.int32), np.zeros(b, np.int32)
    prev_err = np.zeros(b, np.float32)
    plan = mu_cuda.grid_plan(plan_b, n, l, k, sms)
    assert plan.blocks == blocks
    ws, out, extra = _workspace(plan, mu_cuda.grid_workspace_floats(plan, b, l, k))
    err = fn(_ptr(x), _ptr(w0), _ptr(h0), _ptr(w), _ptr(h), _ptr(n_iter), _ptr(prev_err),
             _ptr(converged), b, n, l, k, iters, 0.0, 1, 1, 0.0, 0.0, 0.0, 0.0, 0, plan_b,
             *extra, None)
    assert err == 0 and _reported(out) == plan, (err, _reported(out), plan)
    wp, hp = mu_cuda.mu_iterations_plain(
        *(torch.from_numpy(a).double() for a in (x, w0, h0)), iters)
    assert _rel(w, wp) < 1e-5 and _rel(h, hp) < 1e-5, (_rel(w, wp), _rel(h, hp))


# (batch, rows, SMs, blocks a fit): K2's grid entry on K1's frames
CD_CASES = {"resident": (1, 2000, 4, 4), "225-rows": (1, 225, 4, 1),
            "5x2400-on-10": (5, 2400, 10, 2), "more-fits-than-SMs": (6, 1000, 4, 1)}


@pytest.mark.parametrize("case", list(CD_CASES))
def test_emulated_cd_grid_entry_matches_plain_float64(libs, monkeypatch, case):
    """K2's grid entry, which a small batch of block-range frames takes:
    4 fixed iterations, then a fit with the stop on (median gap 0)."""
    b, n, sms, blocks = CD_CASES[case]
    fn = _entry(libs, monkeypatch, cd_cuda, "cd_nmf", sms)
    l, k = 8, 4
    x, w0, h0 = _factors(np.random.default_rng(n + 1), (b, n, l), (b, n, k), (b, k, l))
    xd, wd, hd = (torch.from_numpy(a).double() for a in (x, w0, h0))
    plan = mu_cuda.grid_plan(b, n, l, k, sms)
    assert plan.blocks == blocks
    for iters, with_stop in ((4, False), (80, True)):
        w, h = np.zeros_like(w0), np.zeros_like(h0)
        n_iter, converged = np.zeros(b, np.int32), np.zeros(b, np.int32)
        viol_init = np.zeros(b, np.float32)
        ws, out, extra = _workspace(plan, mu_cuda.grid_workspace_floats(plan, b, l, k))
        err = fn(_ptr(x), _ptr(w0), _ptr(h0), _ptr(w), _ptr(h), _ptr(n_iter),
                 _ptr(viol_init), _ptr(converged), b, n, l, k, iters, 3e-3,
                 0.0, 0.0, 0.0, 0.0, int(with_stop), *extra, None)
        assert err == 0 and _reported(out) == plan, (err, _reported(out), plan)
        if with_stop:
            st = cd_cuda.fit_cd_plain(xd, wd, hd, max_iter=iters, tol=3e-3)
            gap = n_iter - st.n_iter.numpy()
            assert np.median(gap) == 0 and st.converged.all(), (n_iter, st.n_iter)
        else:
            wp, hp = cd_cuda.cd_iterations_plain(xd, wd, hd, iters)
            assert _rel(w, wp) < 1e-5 and _rel(h, hp) < 1e-5, (_rel(w, wp), _rel(h, hp))
