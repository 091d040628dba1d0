"""PyTorch port: K5's wide entry and its resumable stop run on the CPU.

K5 (``csrc/cnmf.cu``) has two one-block entries: the block entry, 128
threads a fit, and the wide entry, ``cnmf_cuda.WIDE_THREADS`` threads a
fit, which the port runs for fits that have an SM to themselves (the time-
varying path's tail, ``CNMFModel``'s restarts, the bootstraps).  Every
sum of the wide entry keeps the block entry's order, so both compute the
same bits.  Both resume a fit's stop where an earlier launch left it, so
the port's driver (a large batch in chunks on the block entry, its tail
on the wide entry) computes the fit one uninterrupted launch computes.
Here ``cnmf.cu`` is built with g++ against the stand-in CUDA runtime of
``tests/support/cuda_emu/`` (as ``tests/test_torch_grid_emulated.py``
builds it) and called through ctypes with the wrapper's argument types:

- the wide entry equals the block entry bit for bit (C, S, iterations,
  the last error and the scale, converged) over T 12-200, L 3, 8 and 12,
  K 1, 4 and 5 and D 1, 3 and 10, with the stop on and off, and on the
  shapes whose S items take 4 or 8 columns or more than one round;
- block-entry chunks on a list of fits, then a wide resume on the fits
  still running, equal one uninterrupted block-entry launch, and the
  wrapper's own driver (``fit_cnmf_cuda`` on a stand-in card of one SM,
  the plan of ``cnmf_cuda.launch_plan``) equals a block-only run;
- the wide entry within 1e-5 of the float64 plain version and of the JAX
  package's ``cnmf_iterations_batch``, and its stop within 10 iterations
  of the JAX package's ``fit_cnmf_batch`` in float64;
- the route and the chunk plan, in pure Python (the wide entry for a
  batch one wave of it holds, and for every batch of frames whose shared
  memory leaves the block entry no more fits an SM).

What this cannot show: speed, registers, fused multiply-adds (g++ fuses
none here; nvcc fuses the same expressions in both entries, which the
card's digests check in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_grid_emulated import build_emulated  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda  # noqa: E402

BIG_CAP = 1 << 30


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("cuda_emu_cnmf"), ("cnmf",))["cnmf"]


@pytest.fixture
def entries(lib, monkeypatch):
    """entry name -> the C function with the wrapper's argument types."""
    monkeypatch.setattr(cnmf_cuda, "load", lambda n: lib)
    return {e: cnmf_cuda._lib(e) for e in ("block", "wide")}


def test_a_library_of_another_width_is_refused(lib, monkeypatch):
    """The wrapper plans waves for ``WIDE_THREADS`` threads a fit; a
    library whose wide entry runs another width raises before a launch."""
    assert lib.cnmf_wide_threads() == cnmf_cuda.WIDE_THREADS
    monkeypatch.setattr(cnmf_cuda, "load", lambda n: lib)
    monkeypatch.setattr(cnmf_cuda, "WIDE_THREADS", 2 * cnmf_cuda.WIDE_THREADS)
    with pytest.raises(RuntimeError, match="threads a fit"):
        cnmf_cuda._lib("wide")


def _ptr(a):
    return None if a is None else a.ctypes.data


def _problem(seed, b, t, l, k, d):
    rng = np.random.default_rng(seed)
    x = rng.random((b, t, l)).astype(np.float32) + np.float32(0.01)
    c = (rng.random((b, t, k)) + 0.1).astype(np.float32)
    s = (rng.random((b, k, d, l)) + 0.1).astype(np.float32)
    return x, c, s


def _state(b):
    return (np.zeros(b, np.int32), np.zeros(b, np.float64), np.zeros(b, np.float64),
            np.zeros(b, np.int32))


def _run(fn, x, c, s, state, max_iter, *, fits=None, cap=BIG_CAP, tol=0.0,
         check_every=1, with_stop=True):
    """One launch; C, S and the state updated in place."""
    b, t, l = x.shape
    k, d = s.shape[1], s.shape[2]
    n = b if fits is None else len(fits)
    if with_stop:
        cap = cap // check_every * check_every
    err = fn(_ptr(x), _ptr(c), _ptr(s), _ptr(fits), n, *(_ptr(a) for a in state),
             t, l, k, d, max_iter, cap, tol, check_every, int(with_stop), None)
    assert err == 0, err


def _same(a, b):
    return all(np.array_equal(u, v) for u, v in zip(a, b))


# (T, L, K, D): the slices G = min(4, 128 // (K D)) 4, 3 and 2 (4 columns
# an S item), two L-tiles (L = 12), D = 1, D = T; last G = 1 with 4 and 8
# columns an S item, the 8-column one over two rounds of the block
SHAPES = [(12, 3, 1, 1), (12, 8, 4, 3), (40, 12, 5, 10), (200, 8, 4, 10),
          (64, 3, 5, 3), (100, 12, 1, 10), (30, 8, 5, 1), (10, 8, 4, 10),
          (24, 8, 7, 10), (20, 8, 13, 10), (12, 8, 52, 10)]


@pytest.mark.parametrize("with_stop", [False, True], ids=["fixed", "stop"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{t}x{l}k{k}d{d}" for t, l, k, d in SHAPES])
def test_wide_entry_equals_the_block_entry_bit_for_bit(entries, shape, with_stop):
    t, l, k, d = shape
    x, c0, s0 = _problem(t * 7 + k, 2, t, l, k, d)
    out = {}
    for entry, fn in entries.items():
        c, s, state = c0.copy(), s0.copy(), _state(2)
        if with_stop:
            _run(fn, x, c, s, state, 6, tol=1e-3, check_every=2)
        else:
            _run(fn, x, c, s, state, 3, with_stop=False)
        out[entry] = (c, s, *state)
    assert _same(out["block"], out["wide"]), shape
    assert not np.array_equal(out["wide"][0], c0) and np.isfinite(out["wide"][0]).all()
    if with_stop:
        assert (out["wide"][2] > 0).all() and (out["wide"][4] > 0).all()


def test_chunks_then_a_wide_resume_equal_one_launch(entries):
    """Block-entry chunks of 4 iterations on fits [2, 0, 3] (fit 1 is
    left as it is), then the wide entry on the fits still running: the
    fits of one uninterrupted block-entry launch, bit for bit, fit 1 and
    its state untouched; the fits stop at different counts."""
    x, c0, s0 = _problem(3, 4, 60, 8, 4, 10)
    stop = dict(tol=3e-4, check_every=2)
    whole = (c0.copy(), s0.copy(), *_state(4))
    _run(entries["block"], x, *whole[:2], whole[2:], 60, **stop)
    c, s, state = c0.copy(), s0.copy(), _state(4)
    fits = np.array([2, 0, 3], np.int32)
    for _ in range(2):
        _run(entries["block"], x, c, s, state, 60, fits=fits, cap=4, **stop)
    assert (state[0][fits] == 8).all() and state[0][1] == 0
    running = fits[(state[0][fits] < 60) & (state[3][fits] == 0)]
    assert len(running) > 0
    _run(entries["wide"], x, c, s, state, 60, fits=running, **stop)
    for i in (0, 2, 3):
        assert _same([a[i] for a in (c, s, *state)], [a[i] for a in whole]), i
    assert np.array_equal(c[1], c0[1]) and np.array_equal(s[1], s0[1])
    assert state[0][1] == 0 and state[2][1] == 0.0
    assert len(set(whole[2][[0, 2, 3]].tolist())) > 1, whole[2]


@pytest.fixture
def stand_in_card(entries, monkeypatch):
    """The wrapper's CUDA checks and stream answered for CPU tensors on a
    stand-in card of one SM (a wide wave of 2 fits at 60 x 8)."""
    monkeypatch.setattr(cnmf_cuda, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(cnmf_cuda, "card_sms", lambda xs: 1)
    monkeypatch.setattr(cnmf_cuda, "_stream", lambda xs: None)
    monkeypatch.setattr(cnmf_cuda, "CHUNK_ITERS", 4)


def test_the_driver_finishes_on_the_wide_entry_with_the_block_entrys_fits(
        stand_in_card, monkeypatch):
    """``fit_cnmf_cuda`` on 5 fits: block-entry chunks until 2 or fewer
    run, then one wide launch; the same bits as a block-only run (one
    launch, no chunks)."""
    x, c0, s0 = (torch.from_numpy(a) for a in _problem(5, 5, 60, 8, 4, 10))
    stop = dict(max_iter=60, tol=1e-4, check_every=2)
    assert cnmf_cuda.wide_wave(60, 8, 4, 10, 1) == 2
    cnmf_cuda.launches = cnmf_cuda.wide_launches = 0
    got = cnmf_cuda.fit_cnmf_cuda(x, c0, s0, **stop)
    assert cnmf_cuda.wide_launches == 1 and cnmf_cuda.launches >= 2
    monkeypatch.setattr(cnmf_cuda, "launch_plan", lambda *a: ("block", None))
    cnmf_cuda.launches = cnmf_cuda.wide_launches = 0
    want = cnmf_cuda.fit_cnmf_cuda(x, c0, s0, **stop)
    assert cnmf_cuda.launches == 1 and cnmf_cuda.wide_launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got.previous_error.dtype == torch.float32 and got.converged.dtype == torch.bool
    assert len(set(got.n_iter.tolist())) > 1, got.n_iter
    # the fixed-iteration entry: 2 fits in one wide launch, 3 on the block entry
    for b, entry in ((2, "wide_launches"), (3, "launches")):
        cnmf_cuda.launches = cnmf_cuda.wide_launches = 0
        cnmf_cuda.cnmf_iterations_cuda(x[:b], c0[:b], s0[:b], 2)
        assert getattr(cnmf_cuda, entry) == 1


def test_wide_entry_matches_float64_and_the_jax_package(entries):
    mc = pytest.importorskip("muscle_synergies_tpu.models.cnmf")
    import jax.numpy as jnp

    x, c0, s0 = _problem(11, 2, 48, 8, 4, 5)
    c, s, state = c0.copy(), s0.copy(), _state(2)
    _run(entries["wide"], x, c, s, state, 5, with_stop=False)
    xd, cd, sd = (torch.from_numpy(a).double() for a in (x, c0, s0))
    cp, sp = cnmf_cuda.cnmf_iterations_plain(xd, cd, sd, 5)
    cj, sj = mc.cnmf_iterations_batch(jnp.asarray(xd.numpy()), jnp.asarray(cd.numpy()),
                                      jnp.asarray(sd.numpy()), 5, impl="xla")
    for want_c, want_s in ((cp, sp), (torch.from_numpy(np.array(cj)),
                                      torch.from_numpy(np.array(sj)))):
        for got, want in ((c, want_c), (s, want_s)):
            rel = float((torch.from_numpy(got).double() - want).abs().max()
                        / want.abs().max())
            assert rel < 1e-5, rel
    c, s, state = c0.copy(), s0.copy(), _state(2)
    _run(entries["wide"], x, c, s, state, 200, tol=1e-3, check_every=10)
    st = mc.fit_cnmf_batch(jnp.asarray(xd.numpy()), jnp.asarray(cd.numpy()),
                           jnp.asarray(sd.numpy()), max_iter=200, tol=1e-3, impl="xla")
    gap = np.abs(state[0] - np.asarray(st.n_iter))
    assert gap.max() <= 10 and (state[3] == np.asarray(st.converged)).all(), (state, st)


SMS = 132


# (T, L, K, D), one wide wave, whether the wide entry takes every batch
# (shared memory leaves the block entry no more fits an SM: 2,400 x 8, one)
@pytest.mark.parametrize("shape,wave,always", [((200, 8, 4, 10), 2 * SMS, False),
                                               ((2400, 8, 4, 10), SMS, True),
                                               ((12, 3, 1, 1), 2 * SMS, False)])
def test_route_and_chunk_plan(shape, wave, always):
    assert cnmf_cuda.wide_wave(*shape, SMS) == wave
    assert cnmf_cuda.route(*shape) == "block"
    assert cnmf_cuda.route(*shape, batch=1, sms=SMS) == "wide"
    assert cnmf_cuda.route(*shape, batch=wave, sms=SMS) == "wide"
    past = "wide" if always else "block"
    for batch in (wave + 1, 4 * wave):
        assert cnmf_cuda.route(*shape, batch=batch, sms=SMS) == past
        assert cnmf_cuda.wide_keeps(batch, *shape, SMS) == always
    assert cnmf_cuda.launch_plan(wave, *shape, SMS, 10) == ("wide", None)
    chunk = cnmf_cuda.CHUNK_ITERS
    want = ("wide", None) if always else ("block", chunk)
    assert cnmf_cuda.launch_plan(wave + 1, *shape, SMS, 10) == want
    entry, cap = cnmf_cuda.launch_plan(4 * wave, *shape, SMS, 30)
    if always:
        assert (entry, cap) == ("wide", None)
    else:
        assert entry == "block" and cap % 30 == 0 and chunk <= cap < chunk + 30
    with pytest.raises(ValueError, match="sms="):
        cnmf_cuda.route(*shape, batch=4)


def test_route_past_one_block_is_the_cluster_entry_whatever_the_batch():
    assert cnmf_cuda.route(124_460, 8, 4, 10, batch=1, sms=SMS) == "cluster"
    assert cnmf_cuda.route(2_900, 8, 4, 10, batch=4, sms=SMS) == "cluster"
