"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked ``gpu``; every test skips without a CUDA device.  On a machine
with a CUDA card, from the repository root::

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` imports jax, which a
machine for the port need not have.)

Bars: the filters (zero-phase K3, causal K6) within 1e-6 x max|y| of
the plain float64 version (the kernels keep their state in float64;
measured ~6e-8 on the card), solver
iterates within 1e-3 relative of float64 (``bench.py --check``'s bar;
measured 2e-6 for MU and 3e-4 for CD after 50 iterations at 1024 x 200
x 8), the beta and convolutive fits within 10 iterations of where the
float64 fit stops (``BENCH_CHECK.json``'s bar for those kernels).  The
same bars hold with sklearn's L1/L2 penalties, which the MU, CD and
beta kernels take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muscle_synergies_tpu_torch import (  # noqa: E402
    FilterSpec,
    NMFModel,
    PipelineConfig,
    analyze_dataset,
    analyze_dataset_time_varying,
    preprocess_trials,
)
from muscle_synergies_tpu_torch.models import cnmf  # noqa: E402
from muscle_synergies_tpu_torch.models.beta import mu_update_beta  # noqa: E402
from muscle_synergies_tpu_torch.models.batch import rank_sweep_batch  # noqa: E402
from muscle_synergies_tpu_torch.models.mu import mu_update  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import (  # noqa: E402
    beta_cuda,
    cd_cuda,
    cnmf_cuda,
    mu_cuda,
)
from muscle_synergies_tpu_torch.ops import filter_cuda, filters  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _sms(cuda):
    return torch.cuda.get_device_properties(cuda).multi_processor_count


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
@pytest.mark.parametrize(
    "design",
    [dict(order=4, critical_freqs=4.0), dict(order=3, critical_freqs=40.0),
     dict(order=4, critical_freqs=[20.0, 300.0], band_type="bandpass")],
)
def test_filter_kernel_matches_plain(cuda, padtype, design):
    sos = filters.sos_design(sampling_frequency=1000.0, **design)
    x = torch.rand(5, 3001, 8, generator=torch.Generator().manual_seed(0)).to(cuda)
    padlen = filters.default_padlen(sos) if padtype else 0
    y = filter_cuda.sosfiltfilt_cuda(sos, x, padlen, padtype)
    ref = filter_cuda.sosfiltfilt_plain(sos, x.double(), padlen, padtype)
    torch.cuda.synchronize()
    assert _rel(y, ref) < 1e-6
    assert torch.equal(filters.sosfiltfilt(sos, x, padtype=padtype), y)


@pytest.mark.parametrize(
    "design",
    [dict(order=4, critical_freqs=4.0), dict(order=3, critical_freqs=40.0),
     dict(order=4, critical_freqs=[20.0, 300.0], band_type="bandpass")],
)
def test_causal_filter_kernel_matches_plain(cuda, design):
    sos = filters.sos_design(sampling_frequency=1000.0, **design)
    g = torch.Generator().manual_seed(2)
    x = torch.rand(5, 3001, 8, generator=g).to(cuda)
    zi = torch.randn(5, len(sos), 2, 8, generator=g).to(cuda)
    for states in (None, zi):
        y, zf = filter_cuda.sosfilt_cuda(sos, x, states)
        ref, ref_zf = filter_cuda.sosfilt_plain(
            sos, x.double(), None if states is None else states.double())
        torch.cuda.synchronize()
        assert _rel(y, ref) < 1e-6 and _rel(zf, ref_zf) < 1e-6
        assert zf.shape == (5, len(sos), 2, 8) and zf.dtype == torch.float32
    # "auto" launches the kernel; chunks with carried states equal one pass
    assert torch.equal(filters.sosfilt(sos, x, zi=zi), y)
    state, parts = zi, []
    for start in range(0, 3001, 700):
        part, state = filters.sosfilt(sos, x[:, start:start + 700], zi=state,
                                      return_zf=True)
        parts.append(part)
    assert _rel(torch.cat(parts, dim=1), y) < 1e-6
    one, zf1 = filters.sosfilt(sos, x[0, :, 0], zi=zi[0, :, :, 0], return_zf=True)
    assert torch.equal(one, y[0, :, 0]) and zf1.shape == (len(sos), 2)


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_filter_kernel_takes_per_trial_lengths(cuda, padtype):
    sos = filters.sos_design(4, 40.0, 1000.0)
    padlen = filters.default_padlen(sos) if padtype else 0
    g = torch.Generator().manual_seed(7)
    x = torch.rand(6, 3001, 8, generator=g).to(cuda)
    lengths = torch.tensor([3001, 2000, padlen + 1, 1234, 3000, 2999])
    before = filter_cuda.launches
    y = filter_cuda.sosfiltfilt_cuda(sos, x, padlen, padtype, lengths.to(cuda))
    ref = filter_cuda.sosfiltfilt_plain(sos, x.double(), padlen, padtype, lengths)
    torch.cuda.synchronize()
    assert filter_cuda.launches == before + 1
    assert _rel(y, ref) < 1e-6
    for b, n in enumerate(lengths.tolist()):
        assert not y[b, n:].any()  # zeros past each trial's length
    with pytest.raises(ValueError, match="greater than padlen"):
        filter_cuda.sosfiltfilt_cuda(sos, x, padlen, padtype,
                                     torch.tensor([3001] * 5 + [padlen]))
    assert filter_cuda.launches == before + 1


@pytest.mark.parametrize("shift", [-1, 0, 1])
def test_filter_kernels_at_chunk_boundaries(cuda, shift):
    # N (K6) and the extended length (K3) below, at and one above a
    # chunk; 7 x 5 columns, not a multiple of a warp's 32
    sos = filters.sos_design(4, 4.0, 2000.0)
    padlen = filters.default_padlen(sos)
    chunk = filter_cuda.CHUNK
    g = torch.Generator().manual_seed(8)
    for n in (chunk + shift, chunk - 2 * padlen + shift, 2 * chunk + shift):
        x = torch.rand(7, n, 5, generator=g).to(cuda)
        y = filter_cuda.sosfiltfilt_cuda(sos, x, padlen, "odd")
        ref = filter_cuda.sosfiltfilt_plain(sos, x.double(), padlen, "odd")
        assert _rel(y, ref) < 1e-6
        zi = torch.randn(7, len(sos), 2, 5, generator=g).to(cuda)
        yc, zf = filter_cuda.sosfilt_cuda(sos, x, zi)
        ref, ref_zf = filter_cuda.sosfilt_plain(sos, x.double(), zi.double())
        assert _rel(yc, ref) < 1e-6 and _rel(zf, ref_zf) < 1e-6
    torch.cuda.synchronize()


def test_causal_kernel_streams_across_its_chunks(cuda):
    sos = filters.sos_design(4, 4.0, 2000.0)
    chunk = filter_cuda.CHUNK
    g = torch.Generator().manual_seed(9)
    x = torch.rand(3, 3 * chunk + 5, 8, generator=g).to(cuda)
    zi = torch.randn(3, len(sos), 2, 8, generator=g).to(cuda)
    whole, zf_whole = filter_cuda.sosfilt_cuda(sos, x, zi)
    for piece in (1, 100, chunk, chunk + 1):
        state, parts = zi, []
        for start in range(0, min(x.shape[1], 40 * piece), piece):
            part, state = filter_cuda.sosfilt_cuda(sos, x[:, start:start + piece],
                                                   state)
            parts.append(part)
        done = torch.cat(parts, dim=1)
        # zf comes back in float32, so every call rounds the state (6e-8
        # relative); 40 one-sample calls at 4 Hz and 2 kHz measured 1.4e-6
        assert _rel(done, whole[:, :done.shape[1]]) < 1e-5
    assert _rel(state, zf_whole) < 1e-5  # the last piece size covers x


def test_ragged_zero_phase_preprocess_is_one_launch(cuda):
    rng = np.random.default_rng(10)
    lengths = [5000, 4100, 3000, 4999, 3001]
    trials = [rng.standard_normal((n, 8)).astype(np.float32) for n in lengths]
    filter_cuda.launches = filter_cuda.sosfilt_launches = 0
    pre = preprocess_trials(trials, 2000.0)
    torch.cuda.synchronize()
    assert (filter_cuda.launches, filter_cuda.sosfilt_launches) == (1, 0)
    alone = torch.cat([preprocess_trials([t], 2000.0) for t in trials])
    assert pre.shape == (5, 200, 8) and _rel(pre, alone) < 1e-5
    cpu = preprocess_trials(trials, 2000.0, device="cpu", dtype=torch.float64)
    assert _rel(pre.cpu(), cpu) < 1e-5


def test_causal_and_rms_paths_launch_their_kernels(cuda):
    rng = np.random.default_rng(5)
    trials = list(np.abs(rng.standard_normal((4, 4000, 8))).astype(np.float32))
    trials[3] = trials[3][:3000]  # two distinct lengths
    causal = PipelineConfig(envelope=FilterSpec(zero_lag=False))
    filter_cuda.launches = filter_cuda.sosfilt_launches = 0
    res = analyze_dataset(trials, 2000.0, ranks=(1, 2), config=causal, solver="mu",
                          max_iter=500)
    # ragged trials filter as one padded batch: one causal launch, no
    # zero-phase one
    assert (filter_cuda.sosfilt_launches, filter_cuda.launches) == (1, 0)
    plain = analyze_dataset(trials, 2000.0, ranks=(1, 2), config=causal, solver="mu",
                            max_iter=500, impl="torch")
    assert np.abs(plain.vaf_overall - res.vaf_overall).max() < 1e-3
    cd_cuda.launches = cd_cuda.warp_launches = filter_cuda.sosfilt_launches = 0
    rms = PipelineConfig(use_rms=True)
    res = analyze_dataset(trials, 2000.0, ranks=(1, 2), config=rms, max_iter=500)
    # no filter kernel on the RMS path; the ragged batch is one launch of
    # K2's warp entry
    assert (cd_cuda.warp_launches, cd_cuda.launches) == (1, 0)
    assert filter_cuda.sosfilt_launches == filter_cuda.launches == 0
    cpu = analyze_dataset(trials, 2000.0, ranks=(1, 2), config=rms, max_iter=500,
                          device="cpu", dtype=torch.float64)
    assert np.abs(cpu.vaf_overall - res.vaf_overall).max() < 1e-3


def test_nmf_model_route_follows_the_shape(cuda):
    rng = np.random.default_rng(6)
    small = np.abs(rng.standard_normal((200, 8))).astype(np.float32)
    big = np.abs(rng.standard_normal((20_000, 8))).astype(np.float32)
    for mod in (cd_cuda, mu_cuda, beta_cuda):
        mod.launches = mod.warp_launches = 0
    kinds = (dict(), dict(solver="mu"), dict(solver="mu", beta_loss="kullback-leibler"))
    # a 200 x 8 fit takes the warp entry of K2, K1 or K4
    counters = ((cd_cuda, "warp_launches"), (mu_cuda, "warp_launches"),
                (beta_cuda, "warp_launches"))
    for kw, (mod, attr) in zip(kinds, counters):
        model = NMFModel(n_components=4, max_iter=300, **kw)
        w = model.fit_transform(small)
        assert getattr(mod, attr) == 1
        ref = NMFModel(n_components=4, max_iter=300, device="cpu",
                       dtype=torch.float64, **kw)
        ref.fit_transform(small.astype(np.float64))
        assert abs(model.reconstruction_err_ - ref.reconstruction_err_) < (
            1e-3 * ref.reconstruction_err_)
        model.transform(small)  # frozen H: plain, no kernel
        assert getattr(mod, attr) == 1 and w.shape == (200, 4)
    assert cd_cuda.launches == mu_cuda.launches == beta_cuda.launches == 0
    before = (cd_cuda.warp_launches, mu_cuda.warp_launches, beta_cuda.warp_launches)
    # over one block's shared memory: one launch of K2's cluster entry, and
    # impl="torch" runs the plain fit on the card
    cd_cuda.cluster_launches = mu_cuda.cluster_launches = 0
    w = NMFModel(n_components=4, max_iter=50).fit_transform(big)
    assert cd_cuda.cluster_launches == 1 and w.shape == (20_000, 4)
    w_plain = NMFModel(n_components=4, max_iter=50, impl="torch").fit_transform(big)
    assert w_plain.shape == (20_000, 4) and np.isfinite(w_plain).all()
    assert np.abs(w - w_plain).max() <= 1e-3 * np.abs(w_plain).max()
    assert (cd_cuda.warp_launches, mu_cuda.warp_launches, beta_cuda.warp_launches) == before
    assert cd_cuda.launches == mu_cuda.launches == beta_cuda.launches == 0
    assert (cd_cuda.cluster_launches, mu_cuda.cluster_launches) == (1, 0)
    states, vafs = rank_sweep_batch(torch.as_tensor(small, device=cuda), range(1, 9),
                                    solver="cd")
    assert cd_cuda.warp_launches == before[0] + 1 and vafs.shape == (8,)


def _problem(cuda, b=256, n=200, l=8, k=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, n, l, generator=g)
    w = torch.randn(b, n, k, generator=g).abs()
    h = torch.randn(b, k, l, generator=g).abs()
    return x.to(cuda), w.to(cuda), h.to(cuda)


@pytest.mark.parametrize("k", [1, 4, 6, 16])
def test_fixed_iterations_match_plain_float64(cuda, k):
    x, w, h = _problem(cuda, k=k)
    for kern, plain in ((mu_cuda.mu_iterations_cuda, mu_cuda.mu_iterations_plain),
                        (cd_cuda.cd_iterations_cuda, cd_cuda.cd_iterations_plain)):
        wk, hk = kern(x, w, h, 50)
        wp, hp = plain(x.double(), w.double(), h.double(), 50)
        assert _rel(wk, wp) < 1e-3 and _rel(hk, hp) < 1e-3


def test_mu_inner_iter_matches_plain(cuda):
    x, w, h = _problem(cuda, b=64)
    wk, hk = mu_cuda.mu_iterations_cuda(x, w, h, 20, inner_iter=3)
    wp, hp = mu_cuda.mu_iterations_plain(x.double(), w.double(), h.double(), 20,
                                         inner_iter=3)
    assert _rel(wk, wp) < 1e-3 and _rel(hk, hp) < 1e-3


def test_fits_stop_where_float64_stops(cuda):
    x, w, h = _problem(cuda, b=128)
    for kern, plain in ((mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain),
                        (cd_cuda.fit_cd_cuda, cd_cuda.fit_cd_plain)):
        sk = kern(x, w, h, max_iter=200, tol=1e-4)
        sp = plain(x.double(), w.double(), h.double(), max_iter=200, tol=1e-4)
        gap = (sk.n_iter - sp.n_iter).cpu().numpy()
        assert np.median(gap) == 0
        assert (sk.converged == sp.converged).float().mean() > 0.95


def test_padded_rank_components_stay_zero(cuda):
    x, w, h = _problem(cuda, b=32)
    w[..., 2:] = 0
    h[:, 2:] = 0
    st = mu_cuda.fit_mu_cuda(x, w, h, max_iter=100)
    assert (st.w[..., 2:] == 0).all() and (st.h[:, 2:] == 0).all()
    # K2's warp entry at 200 x 8, with and without penalties; at 8 x 300 x
    # 8 its grid entry (two blocks a fit), in a process of its own under
    # the 120 s guard
    assert cd_cuda.route(200, 8, 4, batch=32, sms=_sms(cuda)) == "warp"
    for regs in ({}, REGS):
        st = cd_cuda.fit_cd_cuda(x, w, h, max_iter=100, **regs)
        assert (st.w[..., 2:] == 0).all() and (st.ht[..., 2:] == 0).all()
        assert (st.w[..., :2] > 0).any()
    _child(_CD_ENTRY_CASE.format(root=_root(), case=(8, 300, 8, 4, 0, "cluster",
                                                     {"padded": 2}), regs=REGS))
    for beta in (1.0, 0.0, 0.5, 1.5, 3.0):
        st = beta_cuda.fit_beta_cuda(x + 0.01, w, h, beta=beta, max_iter=100)
        assert (st.w[..., 2:] == 0).all() and (st.h[:, 2:] == 0).all()
        assert (st.w[..., :2] > 0).any()


@pytest.mark.parametrize("l", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 4, 5, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 200, cd_cuda.WARP_NMAX])
def test_cd_warp_entry_matches_plain_float64(cuda, n, k, l):
    """K2's warp entry (rows strided over the lanes, the last row of a
    lane masked when 32 does not divide N) against float64, with and
    without the penalties.

    Unpenalized CD from a random start is ill-conditioned where k >
    min(N, L) (and near it): there the plain float32 version itself ends
    up to ~1 away from float64 after 20 iterations, so the kernel is held
    to 1e-3 or to ten times the plain float32 version's own distance,
    whichever is larger.  With the penalties every shape is
    well-conditioned and the bar is 1e-3."""
    assert cd_cuda.route(n, l, k) == "warp"
    x, w, h = _problem(cuda, b=16, n=n, l=l, k=k, seed=n + 10 * k + 100 * l)
    args64 = (x.double(), w.double(), h.double())
    before = (cd_cuda.warp_launches, cd_cuda.launches)
    wk, hk = cd_cuda.cd_iterations_cuda(x, w, h, 20)
    wp, hp = cd_cuda.cd_iterations_plain(*args64, 20)
    w32, h32 = cd_cuda.cd_iterations_plain(x, w, h, 20)
    bar = max(1e-3, 10 * max(_rel(w32, wp), _rel(h32, hp)))
    assert _rel(wk, wp) < bar and _rel(hk, hp) < bar
    sk = cd_cuda.fit_cd_cuda(x, w, h, max_iter=20, tol=-1.0, **REGS)
    sp = cd_cuda.fit_cd_plain(*args64, max_iter=20, tol=-1.0, **REGS)
    assert _rel(sk.w, sp.w) < 1e-3 and _rel(sk.ht, sp.ht) < 1e-3
    assert torch.allclose(sk.violation_init.double(), sp.violation_init, rtol=1e-3)
    assert (cd_cuda.warp_launches, cd_cuda.launches) == (before[0] + 2, before[1])


@pytest.mark.parametrize("n, k", [(33, 1), (200, 4), (200, 8), (cd_cuda.WARP_NMAX, 5),
                                  (cd_cuda.WARP_NMAX + 1, 4), (2000, 4)])
def test_cd_entries_stop_where_float64_stops(cuda, n, k):
    """K2's entries each side of the warp limit, a small batch on each
    (the grid entry above it, as its route names, in a process of its own
    under the 120 s guard): the median stopping gap against a float64 fit
    is 0, and past the warp entry 50 fixed iterations are within 1e-3."""
    b = 64 if n < 1000 else 16
    if n > cd_cuda.WARP_NMAX:
        _child(_CD_ENTRY_CASE.format(root=_root(), case=(b, n, 8, k, n + k, "cluster",
                                                         {"stop": 200, "fixed": 50}),
                                     regs=REGS))
        return
    assert cd_cuda.route(n, 8, k, batch=b, sms=_sms(cuda)) == "warp"
    x, w, h = _problem(cuda, b=b, n=n, k=k, seed=n + k)
    before = cd_cuda.warp_launches
    sk = cd_cuda.fit_cd_cuda(x, w, h, max_iter=200, tol=1e-4)
    sp = cd_cuda.fit_cd_plain(x.double(), w.double(), h.double(), max_iter=200, tol=1e-4)
    assert cd_cuda.warp_launches == before + 1
    gap = (sk.n_iter - sp.n_iter).cpu().numpy()
    assert np.median(gap) == 0


def _padded_sweep(cuda, n, l, ranks, top, trials=8, seed=3):
    """A rank sweep's launch as ``rank_sweep_batch`` stacks it: ``trials``
    frames at each rank, the factors zero-padded to ``top``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(trials, n, l, generator=g)
    ws, hs = [], []
    for k in ranks:
        w = torch.zeros(trials, n, top)
        h = torch.zeros(trials, top, l)
        w[..., :k] = torch.randn(trials, n, k, generator=g).abs()
        h[:, :k] = torch.randn(trials, k, l, generator=g).abs()
        ws.append(w)
        hs.append(h)
    return [t.to(cuda) for t in (x.repeat(len(ranks), 1, 1), torch.cat(ws), torch.cat(hs))]


@pytest.mark.parametrize("n, l, ranks, top, k", [
    (200, 8, (1, 2, 3, 4), 4, 1), (cd_cuda.WARP_NMAX, 16, (5, 6, 7, 8), 8, 5),
    (200, 8, (1, 8), 8, 1), (33, 5, (1, 2, 3), 3, 2)])
def test_cd_warp_padded_fit_equals_its_own_rank(cuda, n, l, ranks, top, k):
    """K2's warp entry runs each fit over its own rank: a fit padded to a
    sweep's top rank holds the same bits as the same fit launched alone at
    its rank (fixed iterations, and a fit with the stop on: iterations
    and violation too, with and without the penalties), its padding 0."""
    x, w, h = _padded_sweep(cuda, n, l, ranks, top)
    per = len(x) // len(ranks)
    at = slice(ranks.index(k) * per, (ranks.index(k) + 1) * per)
    alone = (x[at], w[at, :, :k].contiguous(), h[at, :k].contiguous())
    before = cd_cuda.warp_launches
    swept = cd_cuda.cd_iterations_cuda(x, w, h, 30)
    own = cd_cuda.cd_iterations_cuda(*alone, 30)
    assert torch.equal(swept[0][at, :, :k], own[0]) and torch.equal(swept[1][at, :k], own[1])
    assert not swept[0][at, :, k:].any() and not swept[1][at, k:].any()
    for regs in ({}, REGS):
        sk = cd_cuda.fit_cd_cuda(x, w, h, max_iter=300, tol=1e-4, **regs)
        so = cd_cuda.fit_cd_cuda(*alone, max_iter=300, tol=1e-4, **regs)
        for a, b in ((sk.w[at, :, :k], so.w), (sk.ht[at, :, :k], so.ht),
                     (sk.n_iter[at], so.n_iter), (sk.violation_init[at], so.violation_init)):
            assert torch.equal(a, b)
        assert not sk.w[at, :, k:].any() and not sk.ht[at, :, k:].any()
    assert cd_cuda.warp_launches == before + 6


def test_cd_grid_padded_fit_equals_its_own_rank(cuda):
    """K2's grid entry runs each fit over its own rank: in a batched sweep
    of a 2,400 x 8 subject (ranks 1-4 padded to 4, one launch, 10 blocks
    a fit) and of a 4,000 x 16 frame (ranks 1-8 padded to 8, 16 blocks a
    fit), ranks 1, the middle one and the top one hold the same bits as
    the same fit launched alone at its rank, which takes the same blocks
    and rows; in a process of its own under the 120 s guard."""
    _child(_CD_PADDED_GRID_CASE.format(root=_root()))


# one beta per kernel kind (KL, IS, generic) and per damping branch
@pytest.mark.parametrize("beta", [1.0, 0.0, 0.5, 1.5, 3.0])
def test_beta_fixed_iterations_match_plain_float64(cuda, beta):
    x, w, h = _problem(cuda)
    x = x + 0.05  # strictly positive, as beta <= 0 needs
    wk, hk = beta_cuda.beta_iterations_cuda(x, w, h, 50, beta)
    wp, hp = beta_cuda.beta_iterations_plain(x.double(), w.double(), h.double(),
                                             50, beta)
    assert _rel(wk, wp) < 1e-3 and _rel(hk, hp) < 1e-3


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_beta_fits_stop_where_float64_stops(cuda, beta):
    x, w, h = _problem(cuda, b=128)
    x = x + 0.05
    sk = beta_cuda.fit_beta_cuda(x, w, h, beta=beta, max_iter=200, tol=1e-4)
    sp = beta_cuda.fit_beta_plain(x.double(), w.double(), h.double(), beta=beta,
                                  max_iter=200, tol=1e-4)
    gap = (sk.n_iter - sp.n_iter).cpu().numpy()
    assert abs(np.median(gap)) <= 10
    assert (sk.converged == sp.converged).float().mean() > 0.9
    assert torch.allclose(sk.previous_error.double(), sp.previous_error, rtol=1e-2)


REGS = dict(l1_reg_w=0.05, l2_reg_w=0.1, l1_reg_h=0.2, l2_reg_h=0.3)
# (kernel fit, plain fit, extra arguments, stopping-gap bar) per kernel
# and beta kind; the Frobenius kernels stop where float64 does
PENALIZED = {
    "mu": (mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain, {}, 0),
    "cd": (cd_cuda.fit_cd_cuda, cd_cuda.fit_cd_plain, {}, 0),
    "kl": (beta_cuda.fit_beta_cuda, beta_cuda.fit_beta_plain, dict(beta=1.0), 10),
    "is": (beta_cuda.fit_beta_cuda, beta_cuda.fit_beta_plain, dict(beta=0.0), 10),
    "beta1.5": (beta_cuda.fit_beta_cuda, beta_cuda.fit_beta_plain,
                dict(beta=1.5), 10),
}


@pytest.mark.parametrize("kind", list(PENALIZED))
def test_penalized_fits_match_plain_float64(cuda, kind):
    kern, plain, extra, gap_bar = PENALIZED[kind]
    x, w, h = _problem(cuda, b=128)
    x = x + 0.05
    args64 = (x.double(), w.double(), h.double())
    # tol < 0 never stops: 50 penalized iterations on both sides
    sk = kern(x, w, h, max_iter=50, tol=-1.0, **extra, **REGS)
    sp = plain(*args64, max_iter=50, tol=-1.0, **extra, **REGS)
    assert _rel(sk.w, sp.w) < 1e-3 and _rel(sk[1], sp[1]) < 1e-3
    unpenalized = kern(x, w, h, max_iter=50, tol=-1.0, **extra)
    assert _rel(unpenalized.w, sp.w) > 1e-2  # the penalties took effect
    sk = kern(x, w, h, max_iter=200, tol=1e-4, **extra, **REGS)
    sp = plain(*args64, max_iter=200, tol=1e-4, **extra, **REGS)
    gap = (sk.n_iter - sp.n_iter).cpu().numpy()
    assert abs(np.median(gap)) <= gap_bar


@pytest.mark.parametrize("solver, loss", [("cd", "frobenius"), ("mu", "frobenius"),
                                          ("mu", "kullback-leibler")])
def test_auto_takes_the_kernel_with_penalties(cuda, solver, loss):
    rng = np.random.default_rng(4)
    trials = np.abs(rng.standard_normal((4, 4000, 8))).astype(np.float32)
    mod, attr = {"cd": (cd_cuda, "warp_launches"), "mu": (mu_cuda, "warp_launches"),
                 "kullback-leibler": (beta_cuda, "warp_launches")}[
        loss if loss != "frobenius" else solver]
    kw = dict(ranks=(1, 2), solver=solver, beta_loss=loss, max_iter=500,
              alpha_W=0.01, alpha_H=0.02, l1_ratio=0.5)
    before = getattr(mod, attr)
    res = analyze_dataset(trials, 2000.0, **kw)
    assert getattr(mod, attr) == before + 1
    plain = analyze_dataset(trials, 2000.0, impl="torch", **kw)
    assert getattr(mod, attr) == before + 1
    assert np.abs(plain.vaf_overall - res.vaf_overall).max() < 1e-3


def _cnmf_problem(cuda, b=256, t=200, l=8, k=4, d=10):
    x = torch.rand(b, t, l, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    c0, s0 = cnmf.init_cnmf(x.numpy(), k, d, seed=3)
    return (x.float().to(cuda), torch.as_tensor(c0).float().to(cuda),
            torch.as_tensor(s0).float().to(cuda))


def test_cnmf_fixed_iterations_match_plain_float64(cuda):
    x, c, s = _cnmf_problem(cuda)
    ck, sk = cnmf_cuda.cnmf_iterations_cuda(x, c, s, 20)
    cp, sp = cnmf_cuda.cnmf_iterations_plain(x.double(), c.double(), s.double(), 20)
    assert _rel(ck, cp) < 1e-3 and _rel(sk, sp) < 1e-3
    # short trials, lags near T: the look-ahead sums meet the trial's end
    c1, s1 = cnmf_cuda.cnmf_iterations_cuda(x[:4, :12], c[:4, :12], s[:4, :, :6], 5)
    c2, s2 = cnmf_cuda.cnmf_iterations_plain(x[:4, :12].double(), c[:4, :12].double(),
                                             s[:4, :, :6].double(), 5)
    assert _rel(c1, c2) < 1e-3 and _rel(s1, s2) < 1e-3


@pytest.mark.parametrize("l", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("d", [1, 10, "T"])
def test_cnmf_shapes_match_plain_float64(cuda, d, k, l):
    """K5's register tiles, swizzled rows and time-split S update at
    T = 37 and 200 (neither a multiple of the 128 threads), one lag to T
    lags (one time slice of the S update when K*D > 64)."""
    for t in (37, 200):
        dd = t if d == "T" else d
        x, c, s = _cnmf_problem(cuda, b=4, t=t, l=l, k=k, d=dd)
        ck, sk = cnmf_cuda.cnmf_iterations_cuda(x, c, s, 10)
        cp, sp = cnmf_cuda.cnmf_iterations_plain(x.double(), c.double(), s.double(), 10)
        assert _rel(ck, cp) < 1e-3 and _rel(sk, sp) < 1e-3, (t, dd)


def test_cnmf_fits_stop_where_float64_stops(cuda):
    x, c, s = _cnmf_problem(cuda, b=128)
    sk = cnmf_cuda.fit_cnmf_cuda(x, c, s, max_iter=1000, tol=1e-4)
    sp = cnmf_cuda.fit_cnmf_plain(x.double(), c.double(), s.double(), max_iter=1000,
                                  tol=1e-4)
    gap = (sk.n_iter - sp.n_iter).cpu().numpy()
    assert abs(np.median(gap)) <= 10
    assert (sk.n_iter % 10 == 0).all()
    st = cnmf_cuda.fit_cnmf_cuda(x[:8], c[:8], s[:8], max_iter=95, tol=1e-9)
    assert (st.n_iter == 100).all()  # no tail chunk: the count overshoots


def test_main_path_runs_through_every_kernel(cuda):
    rng = np.random.default_rng(3)
    trials = np.abs(rng.standard_normal((6, 4000, 8))).astype(np.float32)
    mods = (filter_cuda, cd_cuda, mu_cuda, beta_cuda, cnmf_cuda)
    for mod in mods:
        mod.launches = 0
    filter_cuda.sosfilt_launches = 0
    for mod in (cd_cuda, mu_cuda, beta_cuda):
        mod.warp_launches = 0
    results = {}
    for solver, loss in (("cd", "frobenius"), ("mu", "frobenius"),
                         ("mu", "kullback-leibler")):
        # the default device is the card, where dtype=None means float32
        results[solver, loss] = analyze_dataset(
            trials, 2000.0, ranks=(1, 2, 3), solver=solver, beta_loss=loss,
            max_iter=2000)
    tv = analyze_dataset_time_varying(trials, 2000.0, n_synergies=2, n_lags=5,
                                      n_inits=2, max_iter=500)
    # the 200 x 8 fits take the warp entries of K2, K1 and K4, never a
    # block entry
    assert tuple(m.launches for m in mods) == (4, 0, 0, 0, 1)
    assert cd_cuda.warp_launches == mu_cuda.warp_launches == beta_cuda.warp_launches == 1
    assert filter_cuda.sosfilt_launches == 0  # the default envelope is zero-phase
    for (solver, loss), res in results.items():
        plain = analyze_dataset(trials, 2000.0, ranks=(1, 2, 3), solver=solver,
                                beta_loss=loss, max_iter=2000, impl="torch")
        assert np.abs(plain.vaf_overall - res.vaf_overall).max() < 1e-3
    plain = analyze_dataset_time_varying(trials, 2000.0, n_synergies=2, n_lags=5,
                                         n_inits=2, max_iter=500, impl="torch")
    assert np.abs(plain.vaf_overall - tv.vaf_overall).max() < 1e-3


def test_wrappers_refuse_what_the_kernels_cannot_run(cuda):
    x, w, h = _problem(cuda, b=4)
    with pytest.raises(TypeError, match="float32"):
        mu_cuda.fit_mu_cuda(x.double(), w.double(), h.double())
    wk, hk = _problem(cuda, b=4, k=17)[1:]
    with pytest.raises(ValueError, match="rank"):
        cd_cuda.fit_cd_cuda(x, wk, hk)
    for impl in ("cuda", "auto"):
        with pytest.raises(TypeError, match="float32"):
            filters.sosfiltfilt(filters.sos_design(4, 4.0, 1000.0), x.double(),
                                impl=impl)
        with pytest.raises(TypeError, match="float32"):
            filters.sosfilt(filters.sos_design(4, 4.0, 1000.0), x.double(), impl=impl)
    with pytest.raises(ValueError, match="zi must have shape"):
        filter_cuda.sosfilt_cuda(filters.sos_design(4, 4.0, 1000.0), x,
                                 torch.zeros(4, 2, 2, 3, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        analyze_dataset(x.cpu().numpy(), 1000.0, ranks=(1,),
                        device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        beta_cuda.fit_beta_cuda(x.double(), w.double(), h.double())
    xc, c, s = _cnmf_problem(cuda, b=2, t=20, d=5)
    with pytest.raises(ValueError, match="lags"):
        cnmf_cuda.fit_cnmf_cuda(xc[:, :4], c[:, :4], s)
    with pytest.raises(ValueError, match="shared memory"):
        # 16 synergies of 200 lags: S and its sums alone fill a cluster block
        big = torch.zeros(1, 3000, 16, device=cuda)
        cnmf_cuda.cnmf_iterations_cuda(big, torch.zeros(1, 3000, 16, device=cuda),
                                       torch.zeros(1, 16, 200, 16, device=cuda), 1)


def _warp_bar(kern_plain, x, w, h, iters, **kw):
    """1e-3, or ten times the plain float32 version's own distance from
    float64 where a shape is ill-conditioned, whichever is larger."""
    ref = kern_plain(x.double(), w.double(), h.double(), iters, **kw)
    f32 = kern_plain(x, w, h, iters, **kw)
    return ref, max(1e-3, 10 * max(_rel(f32[0], ref[0]), _rel(f32[1], ref[1])))


@pytest.mark.parametrize("l", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 200, mu_cuda.WARP_NMAX])
def test_mu_warp_entry_matches_plain_float64(cuda, n, k, l):
    """K1's warp entry (rows strided over the lanes, the last row of a
    lane masked when 32 does not divide N) against float64: fixed
    iterations with the stop off, with the penalties, and with
    inner_iter=3."""
    assert mu_cuda.route(n, l, k) == "warp"
    x, w, h = _problem(cuda, b=16, n=n, l=l, k=k, seed=n + 10 * k + 100 * l)
    before = (mu_cuda.warp_launches, mu_cuda.launches)
    wk, hk = mu_cuda.mu_iterations_cuda(x, w, h, 20)
    (wp, hp), bar = _warp_bar(mu_cuda.mu_iterations_plain, x, w, h, 20)
    assert _rel(wk, wp) < bar and _rel(hk, hp) < bar
    wk, hk = mu_cuda.mu_iterations_cuda(x, w, h, 10, inner_iter=3)
    (wp, hp), bar = _warp_bar(mu_cuda.mu_iterations_plain, x, w, h, 10, inner_iter=3)
    assert _rel(wk, wp) < bar and _rel(hk, hp) < bar
    sk = mu_cuda.fit_mu_cuda(x, w, h, max_iter=20, tol=-1.0, **REGS)
    sp = mu_cuda.fit_mu_plain(x.double(), w.double(), h.double(), max_iter=20,
                              tol=-1.0, **REGS)
    assert _rel(sk.w, sp.w) < 1e-3 and _rel(sk.h, sp.h) < 1e-3
    assert (mu_cuda.warp_launches, mu_cuda.launches) == (before[0] + 3, before[1])


@pytest.mark.parametrize("l", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 200, mu_cuda.WARP_NMAX])
def test_beta_warp_entry_matches_plain_float64(cuda, n, k, l):
    """K4's warp entry against float64 for each kind it takes (KL at
    every shape; IS at L <= 8, rank <= 4; a run-time beta never: its 16
    fits, like IS's above those limits, take the grid entry), with the
    stop off, and with the penalties."""
    x, w, h = _problem(cuda, b=16, n=n, l=l, k=k, seed=n + 10 * k + 100 * l)
    x = x + 0.05  # strictly positive, as beta <= 0 needs
    for beta in (1.0, 0.0, 1.5):
        warp = beta == 1.0 or (beta == 0.0 and l <= 8 and k <= 4)
        assert beta_cuda.route(n, l, k, beta, batch=16, sms=_sms(cuda)) == (
            "warp" if warp else "cluster")
        before = (beta_cuda.warp_launches, beta_cuda.cluster_launches)
        wk, hk = beta_cuda.beta_iterations_cuda(x, w, h, 20, beta)
        (wp, hp), bar = _warp_bar(beta_cuda.beta_iterations_plain, x, w, h, 20,
                                  beta=beta)
        assert _rel(wk, wp) < bar and _rel(hk, hp) < bar, beta
        sk = beta_cuda.fit_beta_cuda(x, w, h, beta=beta, max_iter=20, tol=-1.0, **REGS)
        sp = beta_cuda.fit_beta_plain(x.double(), w.double(), h.double(), beta=beta,
                                      max_iter=20, tol=-1.0, **REGS)
        assert _rel(sk.w, sp.w) < 1e-3 and _rel(sk.h, sp.h) < 1e-3, beta
        after = (before[0] + 2, before[1]) if warp else (before[0], before[1] + 2)
        assert (beta_cuda.warp_launches, beta_cuda.cluster_launches) == after


# both entries of a small batch, each side of the warp limit: the warp
# entry, and the grid entry above it up to the 2,000 x 8 frame of the
# per-capture API
@pytest.mark.parametrize("n, k", [(33, 1), (200, 4), (200, 8), (mu_cuda.WARP_NMAX, 5),
                                  (mu_cuda.WARP_NMAX + 1, 4), (2000, 4)])
def test_mu_and_beta_entries_stop_where_float64_stops(cuda, n, k):
    """BENCH_CHECK.json's bars: MU median stopping gap 0 and factor error
    at the kernel's stop 1e-3; beta |median gap| <= 10 and 2e-3."""
    x, w, h = _problem(cuda, b=64 if n < 1000 else 16, n=n, k=k, seed=n + k)
    x = x + 0.05
    args64 = (x.double(), w.double(), h.double())
    cases = [(mu_cuda, mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain, {}, 0, 1e-3,
              mu_update)]
    for beta in ((1.0, 0.0) if n < 1000 else (1.0,)):
        cases.append((beta_cuda, beta_cuda.fit_beta_cuda, beta_cuda.fit_beta_plain,
                      dict(beta=beta), 10, 2e-3,
                      lambda x_, w_, h_, b=beta: mu_update_beta(x_, w_, h_, b)))
    for mod, kern, plain, kw, gap_bar, err_bar, step in cases:
        warp = n <= mu_cuda.WARP_NMAX and (kw.get("beta", 1.0) == 1.0 or k <= 4)
        assert mod.route(n, 8, k, *kw.values(), batch=x.shape[0], sms=_sms(cuda)) == (
            "warp" if warp else "cluster")
        counter = "warp_launches" if warp else "cluster_launches"
        before = getattr(mod, counter)
        sk = kern(x, w, h, max_iter=200, tol=1e-4, **kw)
        assert getattr(mod, counter) == before + 1
        sp = plain(*args64, max_iter=200, tol=1e-4, **kw)
        gap = (sk.n_iter - sp.n_iter).cpu().numpy()
        assert abs(np.median(gap)) <= gap_bar, (kw, gap)
        # float64 updates run to each kernel fit's own stop
        w64, h64 = args64[1].clone(), args64[2].clone()
        for i in range(int(sk.n_iter.max())):
            idx = (sk.n_iter > i).nonzero().flatten()
            w64[idx], h64[idx] = step(args64[0][idx], w64[idx], h64[idx])
        assert _rel(sk.w, w64) < err_bar and _rel(sk.h, h64) < err_bar, kw


def test_warp_entries_compute_the_block_entries_fits_bit_for_bit(cuda, monkeypatch):
    """The warp entries add every sum in the block entries' order, so on
    the main paths' frames they reach the same factors and stop at the
    same iteration as the block entries they replace there."""
    x, w, h = _problem(cuda, b=64, seed=9)
    x = x + 0.05
    for mod, fit, kw in ((mu_cuda, mu_cuda.fit_mu_cuda, {}),
                         (beta_cuda, beta_cuda.fit_beta_cuda, dict(beta=1.0)),
                         (beta_cuda, beta_cuda.fit_beta_cuda, dict(beta=0.0))):
        warp = fit(x, w, h, max_iter=300, tol=1e-5, **kw)
        with monkeypatch.context() as m:
            m.setattr(mod, "route", lambda *shape, **_: "block")
            before = mod.launches
            block = fit(x, w, h, max_iter=300, tol=1e-5, **kw)
            assert mod.launches == before + 1
        assert torch.equal(warp.n_iter, block.n_iter), kw
        assert torch.equal(warp.w, block.w) and torch.equal(warp.h, block.h), kw


def test_negative_beta_takes_the_block_entry(cuda):
    """For beta < 0 a padded entry's weight overflows, so the route keeps
    every frame off the warp entry: a batch that fills the card with
    waves of fits takes the block entry (a small one the grid entry)."""
    x, w, h = _problem(cuda, b=1024)
    x = x + 0.05
    assert beta_cuda.route(200, 8, 4, -0.5, batch=1024, sms=_sms(cuda)) == "block"
    assert beta_cuda.route(200, 8, 4, -0.5, batch=16, sms=_sms(cuda)) == "cluster"
    before = (beta_cuda.warp_launches, beta_cuda.launches)
    wk, hk = beta_cuda.beta_iterations_cuda(x, w, h, 20, -0.5)
    wp, hp = beta_cuda.beta_iterations_plain(x.double(), w.double(), h.double(), 20, -0.5)
    assert _rel(wk, wp) < 1e-3 and _rel(hk, hp) < 1e-3
    assert (beta_cuda.warp_launches, beta_cuda.launches) == (before[0], before[1] + 1)


# (module, fixed iterations, plain, frame (n, l, k), keywords): frames past
# the warp entry and within one block
BLOCK_RANGE = {
    "mu rank 12 x 16": (mu_cuda, mu_cuda.mu_iterations_cuda,
                        mu_cuda.mu_iterations_plain, (200, 16, 12), {}),
    "beta 1.5": (beta_cuda, beta_cuda.beta_iterations_cuda,
                 beta_cuda.beta_iterations_plain, (200, 8, 4), dict(beta=1.5)),
    "is rank 6": (beta_cuda, beta_cuda.beta_iterations_cuda,
                  beta_cuda.beta_iterations_plain, (200, 8, 6), dict(beta=0.0)),
    "cd rank 10 x 16": (cd_cuda, cd_cuda.cd_iterations_cuda,
                        cd_cuda.cd_iterations_plain, (200, 16, 10), {}),
}


@pytest.mark.parametrize("kind", list(BLOCK_RANGE))
def test_block_range_batches_take_the_entry_their_route_names(cuda, kind):
    """A batch of 16 fits takes the grid entry, one of 1,024 (waves of
    fits on every SM) the block entry: K1 at rank 12, where its grid
    kernel holds one block a SM, K4 for a run-time beta and for IS past
    the warp entry's rank, and K2 at rank 10 (its block entry kept at
    ranks 9-10), each held to float64; K2's launches in a process of
    their own under the 120 s guard, with sklearn's penalties:
    unpenalized CD from a random start near k = L strays in float32 (see
    ``test_cd_warp_entry_matches_plain_float64``)."""
    mod, kern, plain, (n, l, k), kw = BLOCK_RANGE[kind]
    for b, entry, counter in ((16, "cluster", "cluster_launches"),
                              (1024, "block", "launches")):
        if mod is cd_cuda:
            _child(_CD_ENTRY_CASE.format(root=_root(), case=(b, n, l, k, b + k, entry,
                                                             {"penalized": 20}), regs=REGS))
            continue
        assert mod.route(n, l, k, *kw.values(), batch=b, sms=_sms(cuda)) == entry
        x, w, h = _problem(cuda, b=b, n=n, l=l, k=k, seed=b + k)
        x = x + 0.05
        before = getattr(mod, counter)
        wk, hk = kern(x, w, h, 20, *kw.values())
        assert getattr(mod, counter) == before + 1, (kind, b)
        wp, hp = plain(x.double(), w.double(), h.double(), 20, *kw.values())
        assert _rel(wk, wp) < 1e-3 and _rel(hk, hp) < 1e-3, (kind, b)


def test_written_capture_runs_the_main_path_on_the_card(cuda, tmp_path):
    """A written capture goes through load, segment, the cut gait cycles
    and ``analyze_dataset`` on the card: one K3 launch for the ragged
    cycles (per-trial lengths) and K2's warp entry, no block entry; the
    native decoder builds under ``build/native/``."""
    from pathlib import Path

    from muscle_synergies_tpu_torch import load_vicon_file, native
    from muscle_synergies_tpu_torch.segment import Segmenter
    from muscle_synergies_tpu_torch.testing import GAIT_MUSCLES, write_synthetic_capture

    path = write_synthetic_capture(str(tmp_path / "capture.csv"), state_len=500,
                                   n_markers=4, seed=3)
    data = load_vicon_file(path)
    lib = native.library_path()
    assert lib.is_file() and lib.parent.name == "native"
    assert lib.parent.parent.name == "build"
    assert Path(native.__file__).resolve().parent.parent not in lib.resolve().parents
    seg = Segmenter(data)
    trials = []
    for trecho, cycles in seg.segments.items():
        for cycle in cycles:
            times = seg.get_times_of(trecho, cycle)
            start, stop = data.emg.to_index(times.start), data.emg.to_index(times.stop)
            trials.append(data.emg.array[start:stop + 1])
    assert len(trials) == 8 and {t.shape[0] for t in trials} == {2000}
    trials = [t[: 1500 + 50 * i] for i, t in enumerate(trials)]  # ragged
    filter_cuda.launches = filter_cuda.sosfilt_launches = 0
    cd_cuda.launches = cd_cuda.warp_launches = 0
    res = analyze_dataset(trials, 2000.0, ranks=(1, 2, 3), max_iter=2000)
    assert filter_cuda.launches == 1 and filter_cuda.sosfilt_launches == 0
    assert cd_cuda.warp_launches == 1 and cd_cuda.launches == 0
    assert np.isfinite(res.vaf_overall).all() and (res.vaf_overall <= 1).all()
    plain = analyze_dataset(trials, 2000.0, ranks=(1, 2, 3), max_iter=2000,
                            impl="torch")
    assert np.abs(res.vaf_overall - plain.vaf_overall).max() <= 1e-3
    whole = analyze_dataset([data.emg], 2000.0, ranks=(1, 2), max_iter=500)
    assert whole.channel_names == list(GAIT_MUSCLES)


def test_cnmf_model_fits_through_one_k5_launch(cuda):
    """``CNMFModel`` stacks its restarts on the batch axis of one K5
    launch; its library reconstructs as the plain float64 fit of the
    same restarts does (bar 1e-3 in VAF), and ``transform`` (plain, S
    frozen) launches nothing."""
    from muscle_synergies_tpu_torch.models import CNMFModel

    x = preprocess_trials(np.abs(np.random.default_rng(5).standard_normal((1, 6000, 8))),
                          2000.0)[0]
    cnmf_cuda.launches = 0
    model = CNMFModel(4, 10, n_inits=4)
    c = model.fit_transform(x)
    assert cnmf_cuda.launches == 1 and c.shape == (200, 4)
    assert model.synergies_.shape == (4, 10, 8) and np.isfinite(c).all()
    ref = CNMFModel(4, 10, n_inits=4, device="cpu", dtype=torch.float64)
    c_ref = ref.fit_transform(x.cpu().double())
    vafs = [float(cnmf.tvaf(x.cpu().double(), torch.as_tensor(cc, dtype=torch.float64),
                            torch.as_tensor(m.synergies_, dtype=torch.float64)))
            for cc, m in ((c, model), (c_ref, ref))]
    assert abs(vafs[0] - vafs[1]) <= 1e-3, vafs
    assert model.transform(x[None].repeat(3, 1, 1)).shape == (3, 200, 4)
    assert cnmf_cuda.launches == 1
    # over one block's shared memory (2,822 x 8 at K = 4, D = 10): one
    # launch of K5's cluster entry
    cnmf_cuda.cluster_launches = 0
    long = torch.rand(3000, 8, device=cuda)
    fitted = CNMFModel(4, 10, n_inits=2, max_iter=100).fit(long)
    assert (cnmf_cuda.launches, cnmf_cuda.cluster_launches) == (1, 1)
    assert np.isfinite(fitted.synergies_).all()


def test_frozen_factors_refuse_the_kernel_route(cuda):
    x, c, s = _cnmf_problem(cuda, b=4)
    cnmf_cuda.launches = 0
    for frozen in (dict(update_c=False), dict(update_s=False)):
        with pytest.raises(ValueError, match="impl='torch'"):
            cnmf.fit_cnmf_batch(x, c, s, max_iter=20, **frozen)
        st = cnmf.fit_cnmf_batch(x, c, s, max_iter=20, impl="torch", **frozen)
        frozen_out, given = (st.c, c) if "update_c" in frozen else (st.s, s)
        assert torch.equal(frozen_out, given)
    with pytest.raises(ValueError, match="impl='torch'"):
        cnmf.cnmf_iterations_batch(x, c, s, 2, update_c=False)
    assert cnmf_cuda.launches == 0


@pytest.mark.parametrize("precision, bar", [(None, 1e-4), ("high", 5e-2)])
def test_nm3f_fixed_iterations_match_float64(cuda, precision, bar):
    """20 space-by-time updates in float32 on the card against float64
    on the host: full float32 by default, TF32 under "high" (the JAX
    package's bar for its default precision)."""
    from muscle_synergies_tpu_torch.models import nm3f

    xs = np.random.default_rng(6).random((256, 200, 8))
    w, a, s = nm3f.init_nm3f(xs, 4, 3, seed=0)
    card = [torch.as_tensor(v, dtype=torch.float32, device=cuda) for v in (xs, w, a, s)]
    host = [torch.as_tensor(v) for v in (xs, w, a, s)]
    for _ in range(20):
        card[1:] = nm3f.nm3f_update(*card, precision=precision)
        host[1:] = nm3f.nm3f_update(*host)
    for got, want in zip(card[1:], host[1:]):
        assert _rel(got.cpu(), want) <= bar


def _subject_matrix(n_rows, seed=11):
    """A preprocessed-looking ``(n_rows, 8)`` matrix: 4 smooth,
    gait-periodic activations mixing into 8 muscles, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows) / 200.0
    acts = np.abs(np.sin(np.pi * (t[:, None] * (1 + 0.1 * np.arange(4)) + rng.random(4))))
    return acts @ rng.random((4, 8)) + 0.02 * rng.random((n_rows, 8))


def _hold_bootstrap_to_float64(got, want, ref_field):
    """The chip bars: each similarity within 2e-3 of the float64 run's,
    and each reference component's cosine to its counterpart >= 0.999."""
    assert np.abs(got.similarities - want.similarities).max() <= 2e-3
    a, b = (getattr(r, ref_field).reshape(len(getattr(r, ref_field)), -1)
            for r in (got, want))
    cos = (a * b).sum(1) / np.sqrt((a * a).sum(1) * (b * b).sum(1))
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("n_rows, entry", [(200, "warp_launches"),
                                           (2400, "cluster_launches")])
def test_bootstrap_synergies_is_one_k1_launch(cuda, n_rows, entry):
    """The reference fit and the resamples in one launch of K1: its warp
    entry for a 200 x 8 trial, its grid entry for a 2,400 x 8 subject
    (21 fits on 6 blocks each)."""
    from muscle_synergies_tpu_torch.models import stability

    x = _subject_matrix(n_rows)
    mu_cuda.warp_launches = mu_cuda.launches = mu_cuda.cluster_launches = 0
    got = stability.bootstrap_synergies(x, 4, n_boot=20)
    assert getattr(mu_cuda, entry) == 1
    assert mu_cuda.warp_launches + mu_cuda.launches + mu_cuda.cluster_launches == 1
    want = stability.bootstrap_synergies(x, 4, n_boot=20, device="cpu",
                                         dtype=torch.float64)
    _hold_bootstrap_to_float64(got, want, "reference_components")


def test_bootstrap_time_varying_is_one_k5_launch(cuda):
    from muscle_synergies_tpu_torch.models import stability

    x = _subject_matrix(2400)
    cnmf_cuda.launches = 0
    got = stability.bootstrap_time_varying_synergies(x, 4, 10, n_boot=10)
    assert cnmf_cuda.launches == 1
    want = stability.bootstrap_time_varying_synergies(x, 4, 10, n_boot=10, device="cpu",
                                                      dtype=torch.float64)
    _hold_bootstrap_to_float64(got, want, "reference_synergies")


def test_bootstraps_refuse_frames_over_one_block(cuda):
    """5,000 x 8 is over one block's shared memory for K1 at rank 4 (about
    4,100 rows) and K5 at K = 4, D = 10 (2,822 rows): each bootstrap is
    one launch of its kernel's cluster entry, held to float64 (the name
    is from when K5 refused such a frame)."""
    from muscle_synergies_tpu_torch.models import stability

    x = _subject_matrix(5000)
    mu_cuda.warp_launches = mu_cuda.launches = mu_cuda.cluster_launches = 0
    cnmf_cuda.launches = cnmf_cuda.cluster_launches = 0
    got = stability.bootstrap_synergies(x, 4, n_boot=10)
    assert (mu_cuda.warp_launches, mu_cuda.launches, mu_cuda.cluster_launches) == (0, 0, 1)
    want = stability.bootstrap_synergies(x, 4, n_boot=10, device="cpu",
                                         dtype=torch.float64)
    _hold_bootstrap_to_float64(got, want, "reference_components")
    got = stability.bootstrap_time_varying_synergies(x, 4, 10, n_boot=4)
    assert (cnmf_cuda.launches, cnmf_cuda.cluster_launches) == (0, 1)
    want = stability.bootstrap_time_varying_synergies(x, 4, 10, n_boot=4, device="cpu",
                                                      dtype=torch.float64)
    _hold_bootstrap_to_float64(got, want, "reference_synergies")
    plain = stability.bootstrap_synergies(x, 4, n_boot=2, max_iter=20, impl="torch")
    assert plain.similarities.shape == (2, 4) and mu_cuda.cluster_launches == 1


_CLUSTER_CASE = """
import sys, numpy as np, torch
sys.path.insert(0, {root!r})
from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda
b, n, l, k, streamed = {case!r}
regs = {regs!r}
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(0)
x = torch.rand(b, n, l, generator=g).to(dev)
w = torch.randn(b, n, k, generator=g).abs().to(dev)
h = torch.randn(b, k, l, generator=g).abs().to(dev)
assert mu_cuda.route(n, l, k) == cd_cuda.route(n, l, k) == "cluster"
sms = torch.cuda.get_device_properties(dev).multi_processor_count
plan = mu_cuda.grid_plan(b, n, l, k, sms)
assert plan.resident == (not streamed), plan
def rel(a, c):
    return float((a.double() - c).abs().max() / c.abs().max())
for mod, kern, plain in ((mu_cuda, mu_cuda.mu_iterations_cuda, mu_cuda.mu_iterations_plain),
                         (cd_cuda, cd_cuda.cd_iterations_cuda, cd_cuda.cd_iterations_plain)):
    before = mod.cluster_launches
    wk, hk = kern(x, w, h, 30)
    assert mod.cluster_launches == before + 1 and mod.last_plan == plan, mod.last_plan
    wp, hp = plain(x.double(), w.double(), h.double(), 30)
    assert rel(wk, wp) < 1e-3 and rel(hk, hp) < 1e-3, (rel(wk, wp), rel(hk, hp))
fits = min(b, 2)
for kern, plain in ((mu_cuda.fit_mu_cuda, mu_cuda.fit_mu_plain),
                    (cd_cuda.fit_cd_cuda, cd_cuda.fit_cd_plain)):
    sk = kern(x, w, h, max_iter=200, tol=1e-3, **regs)
    sp = plain(x[:fits].double(), w[:fits].double(), h[:fits].double(), max_iter=200,
               tol=1e-3, **regs)
    assert np.median((sk.n_iter[:fits] - sp.n_iter).cpu().numpy()) == 0
# zero-padded components stay exactly 0
w[..., k // 2:] = 0
h[:, k // 2:] = 0
st = mu_cuda.fit_mu_cuda(x, w, h, max_iter=30)
assert (st.w[..., k // 2:] == 0).all() and (st.h[:, k // 2:] == 0).all()
st = cd_cuda.fit_cd_cuda(x, w, h, max_iter=30, **regs)
assert (st.w[..., k // 2:] == 0).all() and (st.ht[..., k // 2:] == 0).all()
torch.cuda.synchronize()
print("finished", plan)
"""

# (batch, rows, channels, rank, streamed): resident rows at a subject's
# 6,000 x 8, 20,000 x 8 and x 16, a whole capture at ranks 4 and 8 alone
# (every SM) and 4 at once, rank 12 (three 4-row Gram tiles); streamed
# tiles where the batch's rows exceed the card's shared memory, with
# rows of 9 channels at rank 3 (copies that start off 16-byte alignment)
# and a batch over the SM count (one block a fit, no barrier)
CLUSTER_CASES = [(2, 6000, 8, 4, False), (2, 20_000, 8, 4, False),
                 (2, 20_000, 16, 8, False), (1, 124_460, 8, 4, False),
                 (1, 124_460, 8, 8, False), (4, 124_460, 8, 4, False),
                 (2, 8000, 8, 12, False), (33, 20_000, 8, 4, True),
                 (33, 21_001, 9, 3, True), (140, 6000, 8, 4, True)]


@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[f"{b}x{n}x{l}k{k}" for b, n, l, k, _ in CLUSTER_CASES])
def test_cluster_entries_match_plain_float64(cuda, case):
    """K1's and K2's cluster entries (one fit spread over many blocks, rows
    resident or streamed as ``grid_plan`` says, the plan the kernel
    reports equal to the mirror's): 30 fixed iterations within 1e-3 of
    float64, fits with sklearn's penalties that stop where the float64
    fit stops, and zero-padded components that stay 0.  Each case runs in
    a process of its own that must finish within 120 s: blocks that took
    different branches at a barrier in device memory would hang the card
    rather than fail."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _CLUSTER_CASE.format(root=root, case=case, regs=REGS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "finished" in out.stdout, out.stderr[-2000:]


_CHILD_HELPERS = """
import sys, hashlib, numpy as np, torch
sys.path.insert(0, {root!r})
dev = torch.device("cuda", 0)
sms = torch.cuda.get_device_properties(dev).multi_processor_count
def rel(a, c):
    return float((a.double() - c).abs().max() / c.abs().max())
def digest(*ts):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()
"""

_BETA_CLUSTER_CASE = _CHILD_HELPERS + """
from muscle_synergies_tpu_torch.models.kernels import beta_cuda
b, n, l, k, streamed = {case!r}
regs = {regs!r}
g = torch.Generator().manual_seed(0)
x = (torch.rand(b, n, l, generator=g) + 0.05).to(dev)  # strictly positive for IS, beta < 0
w = torch.randn(b, n, k, generator=g).abs().to(dev)
h = torch.randn(b, k, l, generator=g).abs().to(dev)
fits = min(b, 2)
for beta in (1.0, 0.0, 1.5, -0.5):
    assert beta_cuda.route(n, l, k, beta) == "cluster"
    plan = beta_cuda.grid_plan(b, n, l, k, sms, beta == 1.0)
    assert plan.resident == (not streamed), plan
    before = beta_cuda.cluster_launches
    wk, hk = beta_cuda.beta_iterations_cuda(x, w, h, 30, beta)
    assert beta_cuda.cluster_launches == before + 1, "beta_nmf took another entry"
    assert beta_cuda.last_plan == plan, (beta_cuda.last_plan, plan)
    assert digest(wk, hk) == digest(*beta_cuda.beta_iterations_cuda(x, w, h, 30, beta))
    wp, hp = beta_cuda.beta_iterations_plain(x.double(), w.double(), h.double(), 30, beta)
    assert rel(wk, wp) < 1e-3 and rel(hk, hp) < 1e-3, (beta, rel(wk, wp), rel(hk, hp))
    sk = beta_cuda.fit_beta_cuda(x, w, h, beta, max_iter=200, tol=1e-3, **regs)
    sp = beta_cuda.fit_beta_plain(x[:fits].double(), w[:fits].double(), h[:fits].double(),
                                  beta, max_iter=200, tol=1e-3, **regs)
    gap = np.abs((sk.n_iter[:fits] - sp.n_iter).cpu().numpy()).max()
    assert gap <= 10, (beta, sk.n_iter[:fits].tolist(), sp.n_iter.tolist())
# zero-padded components stay exactly 0
w[..., k // 2:] = 0
h[:, k // 2:] = 0
st = beta_cuda.fit_beta_cuda(x, w, h, 1.0, max_iter=30)
assert (st.w[..., k // 2:] == 0).all() and (st.h[:, k // 2:] == 0).all()
torch.cuda.synchronize()
print("finished", plan)
"""

# (batch, rows, channels, rank, streamed): resident rows at a subject's
# 6,000 x 8, a whole capture alone (every SM) and 4 at once (a sweep's
# ranks), rank 12 at 16 channels (three component tiles, two column
# tiles); streamed tiles where the batch's rows exceed the card's shared
# memory (5 captures at once; 9 channels at rank 3, copies off 16-byte
# alignment); and more fits than SMs (one block a fit, no barrier)
BETA_CLUSTER_CASES = [(2, 6000, 8, 4, False), (1, 124_460, 8, 4, False),
                      (4, 124_460, 8, 4, False), (2, 3000, 16, 12, False),
                      (5, 124_460, 8, 4, True), (33, 21_001, 9, 3, True),
                      (140, 3000, 8, 4, False)]


# K2 on the entry its route names for a batch (``case``: batch, rows,
# channels, rank, seed, entry, checks), from the inputs of ``_problem``:
# ``fixed`` iterations within 1e-3 of float64, as many ``penalized`` ones
# (sklearn's penalties, the stop off) within 1e-3, a fit to ``stop``
# (max_iter) at tol 1e-4 with a median stopping gap of 0, and components
# from ``padded`` on zeroed that stay exactly 0, with and without penalties
_CD_PADDED_GRID_CASE = _CHILD_HELPERS + """
from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda
for n, l, top, fixed in ((2400, 8, 4, 30), (4000, 16, 8, 20)):
    g = torch.Generator().manual_seed(n)
    x = torch.rand(1, n, l, generator=g).repeat(top, 1, 1).to(dev)
    w = torch.zeros(top, n, top)
    h = torch.zeros(top, top, l)
    for k in range(1, top + 1):
        w[k - 1, :, :k] = torch.randn(n, k, generator=g).abs()
        h[k - 1, :k] = torch.randn(k, l, generator=g).abs()
    w, h = w.to(dev), h.to(dev)
    assert cd_cuda.route(n, l, top, batch=top, sms=sms) == "cluster"
    swept = cd_cuda.cd_iterations_cuda(x, w, h, fixed)
    plan = cd_cuda.last_plan
    st = cd_cuda.fit_cd_cuda(x, w, h, max_iter=200, tol=1e-4)
    for k in (1, top // 2, top):
        alone = (x[k - 1:k], w[k - 1:k, :, :k].contiguous(), h[k - 1:k, :k].contiguous())
        own = cd_cuda.cd_iterations_cuda(*alone, fixed)
        assert cd_cuda.last_plan[:4] == plan[:4], (cd_cuda.last_plan, plan)
        assert torch.equal(swept[0][k - 1:k, :, :k], own[0]), (n, k)
        assert torch.equal(swept[1][k - 1:k, :k], own[1]), (n, k)
        assert not swept[0][k - 1, :, k:].any() and not swept[1][k - 1, k:].any()
        so = cd_cuda.fit_cd_cuda(*alone, max_iter=200, tol=1e-4)
        assert torch.equal(st.w[k - 1:k, :, :k], so.w) and torch.equal(st.ht[k - 1:k, :, :k], so.ht)
        assert int(st.n_iter[k - 1]) == int(so.n_iter[0]), (n, k)
torch.cuda.synchronize()
print("finished", plan)
"""
_CD_ENTRY_CASE = _CHILD_HELPERS + """
from muscle_synergies_tpu_torch.models.kernels import cd_cuda
b, n, l, k, seed, entry, checks = {case!r}
regs = {regs!r}
g = torch.Generator().manual_seed(seed)
x = torch.rand(b, n, l, generator=g).to(dev)
w = torch.randn(b, n, k, generator=g).abs().to(dev)
h = torch.randn(b, k, l, generator=g).abs().to(dev)
assert cd_cuda.route(n, l, k, batch=b, sms=sms) == entry
counter = {{"block": "launches", "cluster": "cluster_launches"}}[entry]
def launched(fn, *args, **kw):
    before = getattr(cd_cuda, counter)
    out = fn(*args, **kw)
    assert getattr(cd_cuda, counter) == before + 1, "cd_nmf took another entry"
    return out
args64 = (x.double(), w.double(), h.double())
if "fixed" in checks:
    wk, hk = launched(cd_cuda.cd_iterations_cuda, x, w, h, checks["fixed"])
    wp, hp = cd_cuda.cd_iterations_plain(*args64, checks["fixed"])
    assert rel(wk, wp) < 1e-3 and rel(hk, hp) < 1e-3, (rel(wk, wp), rel(hk, hp))
if "penalized" in checks:
    sk = launched(cd_cuda.fit_cd_cuda, x, w, h, max_iter=checks["penalized"], tol=-1.0,
                  **regs)
    sp = cd_cuda.fit_cd_plain(*args64, max_iter=checks["penalized"], tol=-1.0, **regs)
    assert rel(sk.w, sp.w) < 1e-3 and rel(sk.ht, sp.ht) < 1e-3, (rel(sk.w, sp.w),
                                                                  rel(sk.ht, sp.ht))
if "stop" in checks:
    sk = launched(cd_cuda.fit_cd_cuda, x, w, h, max_iter=checks["stop"], tol=1e-4)
    sp = cd_cuda.fit_cd_plain(*args64, max_iter=checks["stop"], tol=1e-4)
    gap = (sk.n_iter - sp.n_iter).cpu().numpy()
    assert np.median(gap) == 0, gap
if "padded" in checks:
    z = checks["padded"]
    w[..., z:] = 0
    h[:, z:] = 0
    for r in ({{}}, regs):
        st = launched(cd_cuda.fit_cd_cuda, x, w, h, max_iter=100, **r)
        assert (st.w[..., z:] == 0).all() and (st.ht[..., z:] == 0).all()
        assert (st.w[..., :z] > 0).any()
torch.cuda.synchronize()
print("finished", cd_cuda.last_plan)
"""


def _child(code):
    """Run ``code`` in a process of its own that must finish within 120 s:
    blocks that took different branches at a barrier in device memory
    would hang the card rather than fail."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "finished" in out.stdout, out.stderr[-2000:]


def _root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", BETA_CLUSTER_CASES,
                         ids=[f"{b}x{n}x{l}k{k}" for b, n, l, k, _ in BETA_CLUSTER_CASES])
def test_beta_cluster_entry_matches_plain_float64(cuda, case):
    """K4's cluster entry (one fit spread over many blocks, rows resident
    or streamed as ``beta_cuda.grid_plan`` says, the plan the kernel
    reports equal to the mirror's), for KL, IS, beta 1.5 and beta -0.5:
    30 fixed iterations within 1e-3 of float64 and the same bits on a
    second run, fits with sklearn's penalties within 10 iterations of
    where the float64 fit stops, and zero-padded components that stay 0,
    in a process of its own under the 120 s guard."""
    _child(_BETA_CLUSTER_CASE.format(root=_root(), case=case, regs=REGS))


_CNMF_CLUSTER_CASE = _CHILD_HELPERS + """
from muscle_synergies_tpu_torch.models import cnmf
from muscle_synergies_tpu_torch.models.kernels import cnmf_cuda
b, t, l, k, d, streamed = {case!r}
x = torch.rand(b, t, l, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
c0, s0 = cnmf.init_cnmf(x.numpy(), k, d, seed=3)
x, c, s = x.float().to(dev), torch.as_tensor(c0).float().to(dev), torch.as_tensor(s0).float().to(dev)
assert cnmf_cuda.route(t, l, k, d) == "cluster"
plan = cnmf_cuda.grid_plan(b, t, l, k, d, sms)
assert plan.resident == (not streamed), plan
before = cnmf_cuda.cluster_launches
ck, sk = cnmf_cuda.cnmf_iterations_cuda(x, c, s, 20)
assert cnmf_cuda.cluster_launches == before + 1, "cnmf took another entry"
assert cnmf_cuda.last_plan == plan, (cnmf_cuda.last_plan, plan)
assert digest(ck, sk) == digest(*cnmf_cuda.cnmf_iterations_cuda(x, c, s, 20))
cp, sp = cnmf_cuda.cnmf_iterations_plain(x.double(), c.double(), s.double(), 20)
assert rel(ck, cp) < 1e-3 and rel(sk, sp) < 1e-3, (rel(ck, cp), rel(sk, sp))
if t <= 6000:
    fits = min(b, 2)
    fk = cnmf_cuda.fit_cnmf_cuda(x, c, s, max_iter=300, tol=1e-3)
    fp = cnmf_cuda.fit_cnmf_plain(x[:fits].double(), c[:fits].double(), s[:fits].double(),
                                  max_iter=300, tol=1e-3)
    gap = np.abs((fk.n_iter[:fits] - fp.n_iter).cpu().numpy()).max()
    assert gap <= 10, (fk.n_iter[:fits].tolist(), fp.n_iter.tolist())
torch.cuda.synchronize()
print("finished", plan)
"""

# (batch, length, channels, synergies, lags, streamed): a subject's
# 6,000 x 8 at D = 10 and at D = 1 (no halo), a whole capture alone
# (resident on every SM) and 4 at once (CNMFModel's restarts, streamed),
# one synergy of 700 lags (blocks of 250 rows, shorter than D - 1, so a
# halo comes from up to three blocks away), 12 channels at K = 3 (two
# L-tiles, C rows off 16-byte chunks), streamed 6-channel rows (no
# 16-byte loads of X), and more fits than SMs (one block a fit)
CNMF_CLUSTER_CASES = [(2, 6000, 8, 4, 10, False), (2, 6000, 8, 4, 1, False),
                      (1, 124_460, 8, 4, 10, False), (4, 124_460, 8, 4, 10, True),
                      (1, 5000, 8, 1, 700, False), (2, 4000, 12, 3, 7, False),
                      (40, 30_000, 6, 3, 7, True), (140, 3000, 8, 4, 10, True)]


@pytest.mark.parametrize("case", CNMF_CLUSTER_CASES,
                         ids=[f"{b}x{t}x{l}k{k}d{d}" for b, t, l, k, d, _ in CNMF_CLUSTER_CASES])
def test_cnmf_cluster_entry_matches_plain_float64(cuda, case):
    """K5's cluster entry (rows resident or streamed as
    ``cnmf_cuda.grid_plan`` says, the plan the kernel reports equal to
    the mirror's): 20 fixed iterations within 1e-3 of float64 and the
    same bits on a second run, and fits within 10 iterations of where the
    float64 fit stops, in a process of its own under the 120 s guard."""
    _child(_CNMF_CLUSTER_CASE.format(root=_root(), case=case))


def test_beta_and_convolutive_finders_take_the_cluster_entries(cuda):
    """Under default arguments: ``NMFModel`` with a KL loss on a
    subject's 6,000 x 8 cycles and ``CNMFModel`` on a 6,000 x 8
    recording are one cluster launch each, with no other launch."""
    from muscle_synergies_tpu_torch.models import CNMFModel

    x = torch.as_tensor(_subject_matrix(6000), dtype=torch.float32, device=cuda)
    beta_cuda.warp_launches = beta_cuda.launches = beta_cuda.cluster_launches = 0
    w = NMFModel(n_components=4, solver="mu", beta_loss="kullback-leibler",
                 max_iter=300).fit_transform(x)
    assert (beta_cuda.warp_launches, beta_cuda.launches, beta_cuda.cluster_launches) == (0, 0, 1)
    assert np.isfinite(w).all() and w.shape == (6000, 4)
    cnmf_cuda.launches = cnmf_cuda.cluster_launches = 0
    c = CNMFModel(4, 10, max_iter=200).fit_transform(x)
    assert (cnmf_cuda.launches, cnmf_cuda.cluster_launches) == (0, 1)
    assert np.isfinite(c).all() and c.shape == (6000, 4)


_CAPTURE_FIT = """
import sys, numpy as np, torch
sys.path.insert(0, {root!r})
from muscle_synergies_tpu_torch.models.kernels import cd_cuda, mu_cuda
rng = np.random.default_rng(3)
x = torch.tensor(rng.random((1, 124_460, 8)), dtype=torch.float32, device="cuda")
w = torch.tensor(rng.random((1, 124_460, 8)), dtype=torch.float32, device="cuda")
h = torch.tensor(rng.random((1, 8, 8)), dtype=torch.float32, device="cuda")
for fit in (mu_cuda.fit_mu_cuda, cd_cuda.fit_cd_cuda):
    st = fit(x, w, h, max_iter=300, tol=1e-4)
    torch.cuda.synchronize()
    assert torch.isfinite(st.w).all() and int(st.n_iter[0]) >= 1
assert mu_cuda.cluster_launches == cd_cuda.cluster_launches == 1
from muscle_synergies_tpu_torch.models.kernels import beta_cuda, cnmf_cuda
x = x + 0.01
for beta in (1.0, 0.0):
    st = beta_cuda.fit_beta_cuda(x, w, h, beta, max_iter=100, tol=1e-4)
    torch.cuda.synchronize()
    assert torch.isfinite(st.w).all() and int(st.n_iter[0]) >= 1
c = torch.tensor(rng.random((1, 124_460, 4)), dtype=torch.float32, device="cuda")
s = torch.tensor(rng.random((1, 4, 10, 8)), dtype=torch.float32, device="cuda")
st = cnmf_cuda.fit_cnmf_cuda(x, c, s, max_iter=60, tol=1e-4)
torch.cuda.synchronize()
assert torch.isfinite(st.c).all() and int(st.n_iter[0]) >= 10
assert beta_cuda.cluster_launches == 2 and cnmf_cuda.cluster_launches == 1
print("finished")
"""


def test_a_capture_length_fit_finishes_in_time(cuda):
    """A rank-8 fit of a whole capture's 124,460 x 8 envelope on each
    cluster entry of K1 and K2, KL and IS fits on K4's, and a K = 4, D =
    10 fit on K5's, with the stop on, in a process of its own that must
    finish within 120 s: a cluster whose blocks took different branches
    at a barrier would hang the card rather than fail."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _CAPTURE_FIT.format(root=root)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "finished" in out.stdout, out.stderr[-2000:]


def test_checkpointed_bootstraps_count_their_launches(cuda, tmp_path):
    """A chunked bootstrap is one K1 (or K5) launch a chunk; a fully
    restored one refits only the reference (one launch); the result is
    the one-shot call's to 1e-6."""
    import os

    from muscle_synergies_tpu_torch.models import resume, stability

    x = _subject_matrix(2400)
    want = stability.bootstrap_synergies(x, 4, n_boot=20)
    for drop, launches in (((), 4), ((), 1), (("chunk_00005_00010",), 1)):
        for key in drop:
            os.remove(tmp_path / "k1" / f"{key}.npz")
        mu_cuda.warp_launches = mu_cuda.launches = mu_cuda.cluster_launches = 0
        got = resume.bootstrap_synergies_checkpointed(x, 4, tmp_path / "k1", n_boot=20,
                                                      chunk_size=5)
        # each chunk on the grid entry, planned as the one-shot call's 21 fits
        assert mu_cuda.cluster_launches == launches
        assert mu_cuda.warp_launches == mu_cuda.launches == 0
        assert mu_cuda.last_plan == mu_cuda.grid_plan(21, 2400, 8, 4, _sms(cuda))
        assert np.abs(got.similarities - want.similarities).max() <= 1e-6
        ref = got.reference_components - want.reference_components
        assert np.abs(ref).max() <= 1e-6
    want = stability.bootstrap_time_varying_synergies(x, 4, 10, n_boot=10)
    cnmf_cuda.launches = 0
    got = resume.bootstrap_time_varying_synergies_checkpointed(
        x, 4, 10, tmp_path / "k5", n_boot=10, chunk_size=5)
    assert cnmf_cuda.launches == 2
    assert np.abs(got.similarities - want.similarities).max() <= 1e-6


def test_checkpointed_cv_matches_the_one_shot_grid(cuda, tmp_path):
    import os

    from muscle_synergies_tpu_torch.models import resume, stability

    x = _subject_matrix(2400)
    want = stability.cv_rank_selection(x, range(1, 6), n_repeats=3)
    for drop in ((), ("rank_2", "rank_4")):
        for key in drop:
            os.remove(tmp_path / f"{key}.npz")
        got = resume.cv_rank_selection_checkpointed(x, range(1, 6), tmp_path,
                                                    n_repeats=3)
        assert got.best_rank == want.best_rank
        assert np.abs(got.test_error / want.test_error - 1).max() <= 1e-6


def _card_models(cuda):
    """An ``NMFModel`` fitted through K2, a ``CNMFModel`` through K5 and
    an ``NM3FModel``, on preprocessed-looking 200 x 8 trials."""
    from muscle_synergies_tpu_torch.models import CNMFModel, NM3FModel

    trials = np.stack([_subject_matrix(200, seed=s) for s in range(24)])
    trials = trials.astype(np.float32)
    nmf = NMFModel(4)
    nmf.fit_transform(trials[0])
    cn = CNMFModel(4, 10, n_inits=2, max_iter=200).fit(trials[0])
    nm = NM3FModel(4, 3, n_inits=2, max_iter=200).fit(trials[:16])
    return {"NMFModel": nmf, "CNMFModel": cn, "NM3FModel": nm}, trials


def test_saved_models_reload_bit_for_bit(cuda, tmp_path):
    from muscle_synergies_tpu_torch import load_model

    models, trials = _card_models(cuda)
    for name, model in models.items():
        path = model.save(tmp_path / name)
        loaded = type(model).load(path)
        for a, b in zip(model._transform_factors(), loaded._transform_factors()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(loaded.transform(trials[8:16]), model.transform(trials[8:16]))
        host = load_model(path, device="cpu")
        assert np.isfinite(host.transform(trials[8:10])).all()


def test_exported_transforms_replay_on_the_card(cuda, tmp_path):
    from muscle_synergies_tpu_torch.models import export_transform, load_transform

    models, trials = _card_models(cuda)
    for name, model in models.items():
        fn = load_transform(export_transform(model, ("b", 200, 8), platforms=("cuda",)))
        for b in (16, 3):
            x = trials[4:4 + b]
            want = model.transform(x)
            got = fn(torch.as_tensor(x, device=cuda))
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name


def test_profiling_scopes_see_the_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from muscle_synergies_tpu_torch.models import batch as mb
    from muscle_synergies_tpu_torch.utils import annotate, debug_nans, solver_report

    xs = torch.as_tensor(np.stack([_subject_matrix(200, seed=s) for s in range(4)]),
                         dtype=torch.float32, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with annotate("card-scope"):
            NMFModel(4).fit_transform(xs[0])
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                    for e in prof.key_averages() if e.key == "card-scope")
    assert device_us > 0
    w0, h0 = mb.init_batch(xs, 4)
    x = xs.clone()
    x[0, 0, 0] = float("nan")
    with debug_nans():
        with pytest.raises(FloatingPointError):
            torch.log(-torch.ones(3, device=cuda))
        with pytest.raises(FloatingPointError, match="mu_nmf"):
            mu_cuda.mu_iterations_cuda(x, w0, h0, 5)
    st = mb.fit_mu_batch(xs, w0, h0, max_iter=200, tol=1e-4)
    rep = solver_report(st, xs)
    w, h = (t.cpu().double().numpy() for t in (st.w, st.h))
    want = np.sqrt(((xs.cpu().double().numpy() - w @ h) ** 2).sum(axis=(1, 2)))
    assert (rep["n_iter"] == st.n_iter.cpu().numpy()).all()
    assert np.abs(rep["final_error"] - want).max() <= 1e-5 * want.max()


def test_device_prefetch_stages_host_arrays_on_a_side_stream(cuda):
    from muscle_synergies_tpu_torch.io import device_prefetch, stack_trials

    rng = np.random.default_rng(60)
    items = [rng.random((1000, 8)).astype(np.float32) for _ in range(4)]
    pinned = torch.empty((500, 8), pin_memory=True).uniform_()
    batch = stack_trials([items[0], items[1][:700]], device=cuda)
    staged = list(device_prefetch(iter(items + [(pinned, batch)]), buffer_size=2,
                                  device=cuda))
    for got, want in zip(staged, items):
        assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(want))
    got_pinned, got_batch = staged[-1]
    assert got_pinned.is_cuda and torch.equal(got_pinned.cpu(), pinned)
    assert got_batch.data is batch.data  # already on the card


def test_the_consumer_stream_waits_for_the_staged_copy(cuda):
    """A long K3 launch queued on the consumer's stream, then a large
    staged copy: what the consumer computes after it sees the whole copy."""
    from muscle_synergies_tpu_torch.io import device_prefetch

    sos = filters.sos_design(4, 4.0, 2000.0)
    busy = torch.rand((64, 124_460, 8), device=cuda)
    host = [np.random.default_rng(s).random((2 ** 24,)).astype(np.float32)
            for s in range(3)]
    gen = device_prefetch(iter(host), buffer_size=1, device=cuda)
    for want in host:
        filter_cuda.sosfiltfilt_cuda(sos, busy, filters.default_padlen(sos), "odd")
        got = next(gen)
        total = got.double().sum()  # on the consumer's stream, after the wait
        np.testing.assert_allclose(float(total), want.astype(np.float64).sum(),
                                   rtol=1e-9)


def test_record_stream_keeps_staged_memory_alive_across_chunks(cuda):
    """Each chunk's tensor is dropped right after a long read of it is
    queued; the next chunks' staging must not reuse its memory early."""
    from muscle_synergies_tpu_torch.io import device_prefetch

    host = [np.full((2 ** 22,), float(i + 1), dtype=np.float32) for i in range(3)]
    sums = []
    for chunk in device_prefetch(iter(host), buffer_size=2, device=cuda):
        acc = chunk.clone()
        for _ in range(200):  # a long read of the chunk on the consumer's stream
            acc += chunk
        sums.append(acc.double().sum())
        del chunk
    torch.cuda.synchronize()
    for i, s in enumerate(sums):
        assert float(s) == float((i + 1) * 201 * 2 ** 22)


@pytest.fixture
def nccl_mesh(cuda):
    """A ``(data, time)`` mesh of this one process on NCCL, torn down
    after the test."""
    import torch.distributed as dist

    from muscle_synergies_tpu_torch import parallel
    from muscle_synergies_tpu_torch.parallel import mesh

    assert parallel.init_distributed() == 1
    assert dist.get_backend() == "nccl"
    yield parallel.make_mesh((1, 1))
    dist.destroy_process_group()
    mesh._ALONE = False


def test_the_sharded_filters_take_k6_on_a_mesh_of_one(nccl_mesh):
    """World size 1 over NCCL: the sequence-parallel filters run the
    whole cascade in K6 (two launches a pass, one for the left edge pad,
    two for the right one) and agree with K3 and K6 within 5e-4 x max|y|."""
    from muscle_synergies_tpu_torch import parallel

    sos = filters.sos_design(4, 4.0, 2000.0)
    x = torch.rand(20_000, 16, generator=torch.Generator().manual_seed(3)).cuda()
    filter_cuda.sosfilt_launches = 0
    y = parallel.sharded_sosfiltfilt(sos, x, nccl_mesh)
    assert filter_cuda.sosfilt_launches == 7 and y.to_local().is_cuda
    assert _rel(y.full_tensor(), filters.sosfiltfilt(sos, x)) < 5e-4
    filter_cuda.sosfilt_launches = 0
    y = parallel.sharded_sosfilt(sos, x, nccl_mesh)
    assert filter_cuda.sosfilt_launches == 2
    assert _rel(y.full_tensor(), filters.sosfilt(sos, x)) < 5e-4


def test_the_sharded_solvers_match_the_plain_fits_on_a_mesh_of_one(nccl_mesh):
    from muscle_synergies_tpu_torch import parallel
    from muscle_synergies_tpu_torch.models.hals import fit_cd
    from muscle_synergies_tpu_torch.models.mu import fit_mu

    g = torch.Generator().manual_seed(4)
    x, w, h = (torch.rand(s, generator=g).cuda() for s in
               ((64, 200, 8), (64, 200, 4), (64, 4, 8)))
    got = parallel.sharded_fit_mu(x, w, h, nccl_mesh, max_iter=50, tol=0.0)
    want = fit_mu(x, w, h, max_iter=50, tol=0.0)
    assert got.w.to_local().is_cuda
    assert _rel(got.w.full_tensor(), want.w) < 1e-4
    got = parallel.sharded_fit_cd(x, w, h, nccl_mesh, max_iter=20, tol=0.0)
    assert _rel(got.w.full_tensor(), fit_cd(x, w, h, max_iter=20, tol=0.0).w) < 1e-4


def test_card_tensors_on_a_gloo_mesh_raise(cuda):
    """The sharded code runs where its tensors lie: card tensors against
    a mesh of CPU processes raise instead of being solved on the host,
    and the default mesh (the card) refuses the gloo group."""
    import torch.distributed as dist

    from muscle_synergies_tpu_torch import parallel
    from muscle_synergies_tpu_torch.models import stability
    from muscle_synergies_tpu_torch.parallel import mesh as pmesh

    try:
        mesh = parallel.make_mesh((1, 1), device="cpu")
        x = torch.rand(200, 8, generator=torch.Generator().manual_seed(5)).cuda()
        with pytest.raises(ValueError, match="lies on 'cuda'"):
            stability.bootstrap_synergies(x, 2, n_boot=2, max_iter=10, mesh=mesh)
        with pytest.raises(ValueError, match="lies on 'cuda'"):
            parallel.sharded_moving_rms(x, 5, mesh)
        with pytest.raises(RuntimeError, match="runs on 'gloo'"):
            parallel.make_mesh((1, 1))
    finally:
        dist.destroy_process_group()
        pmesh._ALONE = False
