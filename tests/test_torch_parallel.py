"""PyTorch port: ``parallel`` (mesh, collectives, sharded solvers and
filters) against the JAX package's sharded functions.

The port's side runs in one pool of 4 gloo processes for the whole file
(:class:`torch_mesh_pool.MeshPool`, spawned, one torch thread each); the
JAX side in this process on the virtual CPU mesh of the same shape
(``tests/conftest.py`` provisions 8 devices).  Inputs come from a NumPy
seed, float64 on both sides.  Bars: factors of fixed-iteration fits
(``tol=0``) within 1e-9 relative; at ``tol > 0`` the same ``n_iter``
and ``converged``; filters and the moving RMS within 1e-10 x max|y|.
Every rank must return the same gathered result.  A call that does not
return from every rank within the pool's timeout fails (a hang in a
collective) instead of hanging the suite.  The cheap rules (mesh shapes,
``init_distributed``, placements, world size 1) run in this process on
a one-process group.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import MESH, MeshPool, no_leftover_group  # noqa: E402,F401

from muscle_synergies_tpu import parallel as jpar  # noqa: E402
from muscle_synergies_tpu.ops.filters import sos_design  # noqa: E402
from muscle_synergies_tpu_torch import parallel as tpar  # noqa: E402
from muscle_synergies_tpu_torch.parallel import _spmd  # noqa: E402
from muscle_synergies_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from muscle_synergies_tpu_torch.parallel import mesh as tmesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = ("data", "time")
DM = ("data", "model")


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4)
    yield p
    p.close()


def _jmesh(shape, names=DT):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape), names)


def _same_on_every_rank(outs):
    for other in outs[1:]:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), outs[0], other)
    return outs[0]


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(np.asarray(got) - want).max()) <= rtol * scale


def _problem(seed, b=4, n=48, l=6, k=3):
    rng = np.random.default_rng(seed)
    w, h = rng.random((b, n, k)), rng.random((b, k, l))
    x = w @ h + 0.05 * rng.random((b, n, l))
    return x, rng.random((b, n, k)), rng.random((b, k, l))


# ---------------------------------------------------------------- in process

def test_mesh_rules_on_one_process():
    assert tpar.init_distributed(device="cpu") == 1
    assert tpar.init_distributed(device="cpu") == 1  # idempotent
    mesh = tpar.make_mesh((1, 1), device="cpu")
    assert mesh.mesh_dim_names == DT and tuple(mesh.shape) == (1, 1)
    assert tpar.make_mesh(device="cpu").mesh_dim_names == DT
    assert tuple(tpar.make_mesh((-1, 1), DM, device="cpu").mesh_dim_names) == DM
    with pytest.raises(ValueError, match=r'device="cpu".*|world size is 1') as err:
        tpar.make_mesh((2, 2), device="cpu")
    assert 'device="cpu"' in str(err.value) and "world size is 1" in str(err.value)
    with pytest.raises(ValueError, match="at most one mesh axis"):
        tpar.make_mesh((-1, -1), device="cpu")
    with pytest.raises(ValueError, match="cannot infer mesh shape"):
        tpar.make_mesh((-1, 2), device="cpu")


def test_a_late_call_that_asks_for_a_cluster_raises(monkeypatch):
    tpar.init_distributed(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="call init_distributed before make_mesh"):
        tpar.init_distributed()
    with pytest.raises(RuntimeError, match="job of one"):
        tpar.init_distributed("127.0.0.1:1", 4, 0, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert tpar.init_distributed(num_processes=1, device="cpu") == 1
    with pytest.raises(RuntimeError, match="runs on 'gloo'"):
        tpar.init_distributed(num_processes=1)


def test_the_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh._backend(None)
    assert tmesh._backend("cpu") == "gloo"
    code = ("from muscle_synergies_tpu_torch.parallel import make_mesh\n"
            "make_mesh((1, 1))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_a_tensor_off_the_mesh_device_raises():
    """The sharded code runs where the caller's tensors lie: a tensor on
    another kind of device than the mesh's (here ``meta`` against a
    gloo mesh; on a machine with a card, card tensors against it) is
    refused, never moved."""
    mesh = tpar.make_mesh((1, 1), device="cpu")
    x = torch.empty((8, 3), dtype=torch.float64, device="meta")
    calls = [
        lambda: _spmd.local(x, mesh, ("time", None)),
        lambda: tpar.sharded_moving_rms(x, 3, mesh),
        lambda: tpar.sharded_sosfiltfilt(sos_design(2, 20.0, 1000.0), x, mesh),
        lambda: tpar.sharded_fit_mu(x[None], x[None, :, :2], x[None, :2], mesh),
        lambda: tpar.batch_sharding(mesh).apply(x),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="lies on 'meta'.*compute on 'cpu'"):
            call()
    with pytest.raises(RuntimeError, match="runs on 'gloo'.*needs 'nccl'"):
        tpar.make_mesh((1, 1))


def test_shardings_and_collectives_on_one_process():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tpar.make_mesh((1, 1), device="cpu")
    assert tpar.batch_sharding(mesh).placements == (Shard(0), Replicate())
    assert tpar.batch_sharding(mesh, time_sharded=True).placements == (Shard(0), Shard(1))
    assert tpar.replicated(mesh).placements == (Replicate(), Replicate())
    x = torch.arange(24.0, dtype=torch.float64).reshape(2, 3, 4)
    placed = tpar.batch_sharding(mesh, True).apply(x)
    assert torch.equal(placed.full_tensor(), x)
    assert tpar.batch_sharding(mesh, True).apply(x[:, :, 0]).placements[1] == Shard(1)
    with _spmd.bound(mesh):
        total = tcoll.axis_sum(x, "time")
        assert torch.equal(total, x) and total.data_ptr() != x.data_ptr()
        assert tcoll.gather_time(x, "data").shape == (1, 2, 3, 4)
        assert tcoll.axis_index("time") == 0 and tcoll.axis_size("data") == 1
        assert torch.equal(tcoll.ring_shift(x, "time"), x)
        assert torch.equal(tcoll.edge_shift(x, "time"), torch.zeros_like(x))
        assert tcoll.mark_varying(x, "data") is x
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        tcoll.axis_sum(x, "time")


# ---------------------------------------------------------------- 4 ranks

@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_collectives_over_four_ranks(pool, shape):
    outs = pool.call("pool.probe_collectives", MESH, on=(shape, DT))
    grid = np.arange(4).reshape(shape)
    base = np.arange(3.0)
    for out in outs:
        assert out["untouched"]
        r = out["rank"]
        coord = out["coordinate"]
        assert grid[tuple(coord)] == r
        for dim, axis in enumerate(DT):
            peers = np.moveaxis(grid, dim, -1)[
                tuple(c for d, c in enumerate(coord) if d != dim)]
            n, me = len(peers), coord[dim]
            got = out[axis]
            assert got["index"] == me and got["size"] == n
            np.testing.assert_array_equal(got["sum"], sum(100.0 * p + base for p in peers))
            np.testing.assert_array_equal(got["gather"],
                                          np.stack([100.0 * p + base for p in peers]))
            np.testing.assert_array_equal(got["ring"], 100.0 * peers[(me - 1) % n] + base)
            np.testing.assert_array_equal(got["ring_back"],
                                          100.0 * peers[(me + 1) % n] + base)
            np.testing.assert_array_equal(
                got["edge"], 100.0 * peers[me - 1] + base if me > 0 else 0 * base)
            np.testing.assert_array_equal(
                got["edge_back"], 100.0 * peers[me + 1] + base if me < n - 1 else 0 * base)
            np.testing.assert_array_equal(got["varying"], 100.0 * r + base)


def _check_state(got, want, fields, rtol=1e-9, exact=("n_iter", "converged")):
    for f in fields:
        if f in exact:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), err_msg=f)
        else:
            _close(got[f], getattr(want, f), rtol)


MU = ("w", "h", "n_iter", "previous_error", "converged")


@pytest.mark.parametrize("shape, tol", [((2, 2), 0.0), ((1, 4), 0.0), ((4, 1), 0.0),
                                        ((2, 2), 1e-4)])
def test_sharded_fit_mu_matches_jax(pool, shape, tol):
    x, w, h = _problem(1)
    kw = dict(max_iter=60, tol=tol)
    got = _same_on_every_rank(pool.call("parallel.sharded_fit_mu", x, w, h, MESH,
                                        on=(shape, DT), **kw))
    want = jpar.sharded_fit_mu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                               _jmesh(shape), **kw)
    _check_state(got, want, MU, rtol=1e-9 if tol == 0 else 1e-8)


def test_the_solvers_take_dtensors(pool):
    x, w, h = _problem(20)
    placed = pool.call("pool.fit_dtensors", x, w, h, MESH, on=((2, 2), DT))[0]
    plain = pool.call("parallel.sharded_fit_mu", x, w, h, MESH, on=((2, 2), DT),
                      max_iter=30, tol=0.0)[0]
    for f in MU:
        np.testing.assert_array_equal(placed[f], plain[f])


def test_sharded_fit_mu_takes_penalties_and_inner_iterations(pool):
    x, w, h = _problem(2)
    kw = dict(max_iter=40, tol=0.0, l1_reg_w=0.01, l2_reg_w=0.02, l1_reg_h=0.03,
              l2_reg_h=0.01, inner_iter=2)
    got = pool.call("parallel.sharded_fit_mu", x, w, h, MESH, on=((2, 2), DT), **kw)[0]
    want = jpar.sharded_fit_mu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                               _jmesh((2, 2)), **kw)
    _check_state(got, want, MU)


def test_a_time_group_with_different_local_errors_stops_together(pool):
    """The stop-decision hazard: the four time shards of each fit hold
    data of very different scales, so their local squared errors differ
    by orders of magnitude; only the summed error may decide, and every
    rank must leave the loop at the same chunk."""
    x, w, h = _problem(3, b=2, n=64)
    x[:, :16] *= 1e3
    x[:, 48:] *= 1e-3
    kw = dict(max_iter=400, tol=1e-3)
    outs = pool.call("parallel.sharded_fit_mu", x, w, h, MESH, on=((1, 4), DT), **kw)
    got = _same_on_every_rank(outs)
    want = jpar.sharded_fit_mu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                               _jmesh((1, 4)), **kw)
    assert 0 < got["n_iter"].max() < 400
    _check_state(got, want, MU, rtol=1e-8)


def test_sharded_mu_step_matches_jax(pool):
    x, w, h = _problem(4)
    got = pool.call("parallel.sharded_mu_step", x, w, h, MESH, on=((2, 2), DT))[0]
    want = jpar.sharded_mu_step(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                                _jmesh((2, 2)))
    for a, b in zip(got, want):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("beta, tol", [(1.0, 0.0), (0.0, 0.0), (1.5, 0.0), (1.0, 1e-4)])
def test_sharded_fit_beta_matches_jax(pool, beta, tol):
    x, w, h = _problem(5)
    kw = dict(beta=beta, max_iter=40, tol=tol, l1_reg_w=0.01, l2_reg_h=0.02)
    got = pool.call("parallel.sharded_fit_beta", x + 0.1, w, h, MESH,
                    on=((2, 2), DT), **kw)[0]
    want = jpar.sharded_fit_beta(jnp.asarray(x + 0.1), jnp.asarray(w), jnp.asarray(h),
                                 _jmesh((2, 2)), **kw)
    _check_state(got, want, MU, rtol=1e-9 if tol == 0 else 1e-8)


def test_sharded_fit_kl_matches_jax(pool):
    x, w, h = _problem(6)
    got = pool.call("parallel.sharded_fit_kl", x, w, h, MESH, on=((1, 4), DT),
                    max_iter=50)[0]
    want = jpar.sharded_fit_kl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                               _jmesh((1, 4)), max_iter=50)
    _check_state(got, want, MU, rtol=1e-8)


@pytest.mark.parametrize("shape, kw", [
    ((2, 2), dict(max_iter=80, tol=1e-3)),
    ((1, 4), dict(max_iter=30, tol=0.0, l1_reg_w=0.01, l2_reg_w=0.02, l1_reg_h=0.02,
                  l2_reg_h=0.01)),
])
def test_sharded_fit_cd_matches_jax(pool, shape, kw):
    x, w, h = _problem(7)
    got = pool.call("parallel.sharded_fit_cd", x, w, h, MESH, on=(shape, DT), **kw)[0]
    want = jpar.sharded_fit_cd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                               _jmesh(shape), **kw)
    _check_state(got, want, ("w", "ht", "n_iter", "violation_init", "converged"),
                 rtol=1e-8)


def test_sharded_fit_mu_tp_matches_jax(pool):
    x, w, h = _problem(8, l=8)
    kw = dict(max_iter=60, tol=1e-4, l2_reg_w=0.01, inner_iter=2)
    got = pool.call("parallel.sharded_fit_mu_tp", x, w, h, MESH, on=((2, 2), DM),
                    **kw)[0]
    want = jpar.sharded_fit_mu_tp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                                  _jmesh((2, 2), DM), **kw)
    _check_state(got, want, MU, rtol=1e-8)


def _cnmf_problem(seed, b=4, t=48, l=4, k=2, d=4):
    rng = np.random.default_rng(seed)
    return rng.random((b, t, l)) + 0.05, rng.random((b, t, k)), rng.random((b, k, d, l))


CNMF = ("c", "s", "n_iter", "previous_error", "converged")


@pytest.mark.parametrize("shape, tol", [((2, 2), 0.0), ((1, 4), 0.0), ((2, 2), 1e-4)])
def test_sharded_fit_cnmf_matches_jax(pool, shape, tol):
    x, c, s = _cnmf_problem(9)
    kw = dict(max_iter=40, tol=tol)
    got = pool.call("parallel.sharded_fit_cnmf", x, c, s, MESH, on=(shape, DT), **kw)
    got = _same_on_every_rank(got)
    want = jpar.sharded_fit_cnmf(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s),
                                 _jmesh(shape), **kw)
    _check_state(got, want, CNMF, rtol=1e-9 if tol == 0 else 1e-8)


def test_sharded_fit_cnmf_tp_matches_jax(pool):
    x, c, s = _cnmf_problem(10)
    got = pool.call("parallel.sharded_fit_cnmf_tp", x, c, s, MESH, on=((2, 2), DM),
                    max_iter=40, tol=0.0)[0]
    want = jpar.sharded_fit_cnmf_tp(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s),
                                    _jmesh((2, 2), DM), max_iter=40, tol=0.0)
    _check_state(got, want, CNMF)


@pytest.mark.parametrize("shape, tol", [((2, 2), 0.0), ((1, 4), 0.0), ((4, 1), 0.0),
                                        ((2, 2), 1e-4)])
def test_sharded_fit_nm3f_matches_jax(pool, shape, tol):
    rng = np.random.default_rng(12)
    x = rng.random((4, 48, 5)) + 0.05
    w, a, s = rng.random((48, 3)), rng.random((4, 3, 2)), rng.random((2, 5))
    kw = dict(max_iter=40, tol=tol)
    got = _same_on_every_rank(pool.call("parallel.sharded_fit_nm3f", x, w, a, s, MESH,
                                        on=(shape, DT), **kw))
    want = jpar.sharded_fit_nm3f(*(jnp.asarray(v) for v in (x, w, a, s)), _jmesh(shape),
                                 **kw)
    _check_state(got, want, ("w", "a", "s", "n_iter", "previous_error", "converged"),
                 rtol=1e-9 if tol == 0 else 1e-8)


def _filter_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-10 * float(np.abs(want).max())


SOS = sos_design(4, 10.0, 1000.0)


@pytest.mark.parametrize("n", [400, 403])
@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_sharded_sosfiltfilt_matches_jax(pool, n, padtype):
    sig = np.random.default_rng(13).random((n, 3))
    shape = (1, 4) if padtype != "even" else (2, 2)
    got = _same_on_every_rank(pool.call("parallel.sharded_sosfiltfilt", SOS, sig, MESH,
                                        on=(shape, DT), padtype=padtype))
    want = jpar.sharded_sosfiltfilt(SOS, jnp.asarray(sig), _jmesh(shape),
                                    padtype=padtype)
    _filter_close(got, want)


@pytest.mark.parametrize("shape, n", [((1, 4), 403), ((2, 2), 401), ((4, 1), 64)])
def test_sharded_sosfilt_matches_jax(pool, shape, n):
    sig = np.random.default_rng(14).random((n, 2))
    got = _same_on_every_rank(pool.call("parallel.sharded_sosfilt", SOS, sig, MESH,
                                        on=(shape, DT)))
    _filter_close(got, jpar.sharded_sosfilt(SOS, jnp.asarray(sig), _jmesh(shape)))


@pytest.mark.parametrize("n, window", [(400, 9), (403, 8), (40, 30)])
def test_sharded_moving_rms_matches_jax(pool, n, window):
    sig = np.random.default_rng(15).standard_normal((n, 3))
    got = _same_on_every_rank(pool.call("parallel.sharded_moving_rms", sig, window, MESH,
                                        on=((1, 4), DT)))
    _filter_close(got, jpar.sharded_moving_rms(jnp.asarray(sig), window, _jmesh((1, 4))))


def test_the_filters_take_dtensors(pool):
    sig = np.random.default_rng(16).random((400, 2))
    got = pool.call("parallel.sharded_sosfiltfilt", SOS, sig, MESH, on=((1, 4), DT))[0]
    twice = pool.call("pool.filter_a_dtensor", SOS, sig, MESH, on=((1, 4), DT))[0]
    np.testing.assert_array_equal(twice, got)


def test_sharded_cnmf_refuses_what_jax_refuses(pool):
    """Last in the file: a rank that raises restarts the pool."""
    x, c, s = _cnmf_problem(11, t=8, d=4)
    with pytest.raises(AssertionError, match="lag halo 3 exceeds one time shard"):
        pool.call("parallel.sharded_fit_cnmf", x, c, s, MESH, on=((1, 4), DT))
