"""Synergy stability, held-out rank selection and group-level matching.

Port of :mod:`muscle_synergies_tpu.models.stability`:

- the bootstraps (:func:`bootstrap_synergies`,
  :func:`bootstrap_time_varying_synergies`, :func:`bootstrap_space_by_time`
  and the shared-factor forms) refit on resamples and score each
  reference component's stability as its best-matching cosine
  similarity across resamples (Hungarian matching per resample).  The
  reference fit rides as row 0 of the same batch as the resamples:
  each fit stops on its own, so it is the single-problem fit of the JAX
  package, and on the card each MU or convolutive bootstrap is one
  launch of kernel K1 or K5 (``impl="auto"``).  Both take a matrix of
  any length: within one block's shared memory (about 4,100 rows of 8
  channels at rank 4 for K1, 2,822 rows at K = 4, D = 10 for K5) on
  their block entries, beyond on their cluster entries (K1's spreads
  a fit over many blocks of the card, K5's runs one thread-block
  cluster a fit);
- the masked fits (:func:`fit_mu_masked`, :func:`fit_cnmf_masked`,
  :func:`fit_nm3f_masked`) minimise the Frobenius error on the observed
  (mask = 1) entries, and the cross-validations hold out random entries
  and score every (repeat, candidate) fit's held-out reconstruction
  error.  Every grid runs as one batched loop over the fits still
  going, candidates zero-padded to the grid's maximum (padded
  components start at zero, every masked numerator touching them is
  zero, so they stay zero).  The JAX package runs these on XLA; here
  they are plain PyTorch on the device where the data lies;
- :func:`match_synergies` and :func:`cluster_synergies` compare synergy
  sets on the host (NumPy and SciPy), as the JAX package does.

The resample indices, masks and host inits are the JAX package's NumPy
draws, call for call; the ``random`` NMF init draws its ``jax.random``
normals (:mod:`.._prng`).  The entry points run on the card unless
``device="cpu"`` (float32 there; ``dtype`` overrides, and ``device="cpu"``
keeps float64).  With ``mesh=`` (a ``(data, time)`` mesh of
:func:`~muscle_synergies_tpu_torch.parallel.make_mesh`, every process
calling with the same data) the MU and convolutive bootstraps run
through the sharded solvers (``sharded_fit_mu``, ``sharded_fit_cnmf``:
fits over ``data``, samples over ``time``), and every other grid's fits
split over all the mesh's processes, each running its slice on the
loop above, then gathered: the same fits as without a mesh.  No pandas
is needed: a DataFrame is read as an array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._common import as_tensor, entry_placement, to_numpy
from . import cnmf as _cnmf
from . import nm3f as _nm3f
from .batch import fit_mu_batch
from .init import initialize_nmf
from .mu import MUState, _masked_error, _masked_update, fit_chunked

__all__ = [
    "bootstrap_synergies",
    "BootstrapResult",
    "fit_mu_masked",
    "cv_rank_selection",
    "CVResult",
    "bootstrap_time_varying_synergies",
    "TimeVaryingBootstrapResult",
    "fit_cnmf_masked",
    "cv_time_varying_rank_selection",
    "bootstrap_space_by_time",
    "fit_nm3f_masked",
    "cv_space_by_time_selection",
    "SpaceByTimeCVResult",
    "cv_temporal_selection",
    "cv_shared_spatial_selection",
    "bootstrap_temporal_synergies",
    "bootstrap_shared_spatial_synergies",
    "match_synergies",
    "SynergyMatch",
    "cluster_synergies",
    "SynergyClusters",
]


def _place(x, device, dtype):
    """``(host float64 copy, tensor where the fits run)`` of the input,
    as the JAX package reads it (``np.asarray(x, dtype=float)``)."""
    host = np.asarray(to_numpy(x) if isinstance(x, torch.Tensor) else x, dtype=float)
    device, dtype = entry_placement(device, dtype)
    return host, as_tensor(x if isinstance(x, torch.Tensor) else host, device, dtype)


def _over_mesh(mesh, caller: str, fit, *per_fit):
    """``fit(*per_fit)``, or with a usable ``mesh`` the fits (the leading
    axis of ``per_fit``) split over all its processes and gathered back."""
    from ..parallel._spmd import gather_fits, usable_mesh

    mesh = usable_mesh(mesh, caller, then="local single-device path")
    if mesh is None:
        return fit(*per_fit)
    return gather_fits(mesh, fit, *per_fit)


def _sharded_solve(mesh, caller: str, n: int, n_lags: int, solve, *grids):
    """``solve(*grids, mesh)`` of the sharded MU or convolutive solver,
    gathered, when ``mesh`` is usable and its time axis divides the ``n``
    samples with one shard covering the lag halo; ``None`` otherwise (a
    warning said why), for the caller's local fit."""
    from ..parallel._spmd import axis_size, gathered, pad_fits, usable_mesh
    from ..parallel.mesh import DATA_AXIS

    mesh = usable_mesh(mesh, caller, then="local single-device path")
    mesh = usable_mesh(mesh, caller, n, n_lags - 1 if n_lags > 1 else None,
                       what="sample count", then="local batched solver")
    if mesh is None:
        return None
    grids_padded = pad_fits(axis_size(mesh, DATA_AXIS), *grids)
    return gathered(solve(*grids_padded, mesh), grids[0].shape[0])


def _unit(m: torch.Tensor, dim: int) -> torch.Tensor:
    """``m`` with unit-norm slices along ``dim`` (zero slices untouched)."""
    norm = (m * m).sum(dim=dim, keepdim=True).sqrt()
    return m / torch.where(norm == 0, 1.0, norm)


def _heldout(x: torch.Tensor, masks: torch.Tensor, rec: torch.Tensor) -> np.ndarray:
    """Each fit's held-out error ``||(1 - mask) * (X - X^)|| / ||X||``."""
    err = (1.0 - masks) * (x - rec)
    dims = tuple(range(1, err.ndim))
    return to_numpy((err * err).sum(dim=dims).sqrt() / torch.linalg.vector_norm(x))


# ---------------------------------------------------------------------------
# bootstrap stability
# ---------------------------------------------------------------------------

@dataclass
class BootstrapResult:
    """Per-component stability of a synergy factorization.

    Attributes:
        reference_components: ``(k, L)`` components of the full fit.
        similarities: ``(n_boot, k)`` matched cosine similarity of each
            reference component in each bootstrap refit.
        mean / std: per-component summary across resamples.
    """

    reference_components: np.ndarray
    similarities: np.ndarray

    @property
    def mean(self) -> np.ndarray:
        return self.similarities.mean(axis=0)

    @property
    def std(self) -> np.ndarray:
        return self.similarities.std(axis=0)


def _normalize_rows(h: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(h, axis=1, keepdims=True)
    return h / np.where(norm == 0, 1.0, norm)


def _match_components(h_ref: np.ndarray, h_boot: np.ndarray) -> np.ndarray:
    """Best-assignment cosine similarity of each reference component."""
    from scipy.optimize import linear_sum_assignment

    sim = _normalize_rows(h_ref) @ _normalize_rows(h_boot).T  # (k, k)
    rows, cols = linear_sum_assignment(-sim)
    matched = np.zeros(h_ref.shape[0])
    matched[rows] = sim[rows, cols]
    return matched


def bootstrap_synergies(
    x,
    n_components: int,
    n_boot: int = 50,
    seed: int = 0,
    init: Optional[str] = None,
    max_iter: int = 500,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    impl: str = "auto",
    *,
    _plan_batch: Optional[int] = None,
) -> BootstrapResult:
    """Bootstrap the time axis and measure component stability.

    The full fit (the reference components) and the ``n_boot`` refits
    on resampled rows run as one batch of MU fits, row 0 the full
    matrix, each stopping on its own: one launch of K1 on the card.
    Only the k x k component matching runs on the host.

    Args:
        x: ``(N, L)`` non-negative data (array, DataFrame or tensor).
        _resample_plan: ``(indices, row0)``, precomputed resample rows
            (resume plumbing); the init is the same for every row, so
            ``row0`` is not needed.
        _plan_batch: the one-shot call's batch, whose K1 plan a chunk's
            fits take on the card (resume plumbing: the chunks then give
            the one-shot call's bits).
        mesh: optional ``(data, time)`` mesh: the batch through
            :func:`~..parallel.sharded_fit_mu` (no kernel); a sample count
            that does not divide the time axis warns and fits locally.
        device, dtype: where the fits run (the card by default).
        impl: the fits' route (:func:`~.batch.fit_mu_batch`).
    """
    _, x = _place(x, device, dtype)
    n = x.shape[0]
    if _resample_plan is None:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, n, size=(n_boot, n))
    else:
        idx, _ = _resample_plan
        n_boot = idx.shape[0]
    xs = torch.cat([x[None], x[torch.as_tensor(idx, device=x.device)]])
    w0, h0 = initialize_nmf(xs, n_components, init=init, seed=seed)
    from ..parallel.nmf import sharded_fit_mu

    states = _sharded_solve(
        mesh, "bootstrap_synergies", n, 1,
        lambda *g: sharded_fit_mu(*g, max_iter=max_iter, tol=tol), xs, w0, h0)
    if states is None:
        states = fit_mu_batch(xs, w0, h0, max_iter=max_iter, tol=tol, impl=impl,
                              plan_batch=_plan_batch)
    hs = to_numpy(states.h).astype(float)
    h_ref = hs[0]
    sims = np.stack([_match_components(h_ref, hs[1 + b]) for b in range(n_boot)])
    return BootstrapResult(reference_components=h_ref, similarities=sims)


# ---------------------------------------------------------------------------
# masked (weighted) MU and cross-validated rank selection
# ---------------------------------------------------------------------------

def fit_mu_masked(
    x,
    mask,
    w0,
    h0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
) -> MUState:
    """Masked MU-NMF: minimize ``||mask * (X - WH)||_F`` where ``x`` lies.

    The loop and stopping rule of
    :func:`~muscle_synergies_tpu_torch.models.mu.fit_mu`, with every
    update and the convergence error restricted to observed (mask = 1)
    entries: chunks of ``check_every`` updates, the last one cut at
    ``max_iter``, a fit converging only at a multiple of ``check_every``
    when ``(previous - current) / initial < tol``; ``tol == 0`` computes
    no error after the first.  Takes one problem ``(N, L)`` or a batch
    ``(B, N, L)`` (each fit stopping on its own).
    """
    x = as_tensor(x)
    mask, w0, h0 = (as_tensor(a, x.device, x.dtype) for a in (mask, w0, h0))
    return MUState(*fit_chunked(x, w0, h0, _masked_update, _masked_error,
                                max_iter, tol, check_every, mask=mask))


class CVResult(NamedTuple):
    """Cross-validated rank selection outcome.

    ``test_error``: ``(n_repeats, n_ranks)`` relative held-out
    reconstruction errors.  ``best_rank``: the rank minimizing the mean
    held-out error.
    """

    ranks: tuple
    test_error: np.ndarray
    best_rank: int

    @property
    def mean_test_error(self) -> np.ndarray:
        return self.test_error.mean(axis=0)


def _holdout_masks(rng, shape, holdout_fraction, like: torch.Tensor):
    """The JAX package's held-out masks ``(n_repeats, *shape)`` (1 =
    observed), drawn on the host and placed beside ``like``."""
    masks = (rng.random(shape) >= holdout_fraction).astype(float)
    return masks, as_tensor(masks, like.device, like.dtype)


def cv_rank_selection(
    x,
    ranks: Sequence[int],
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    init: Optional[str] = None,
    max_iter: int = 500,
    tol: float = 1e-6,
    mesh=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> CVResult:
    """Wold-style CV: mask random entries, score their reconstruction.

    For every (repeat, rank) pair a masked MU fit runs (its init on the
    observed matrix, seeded ``seed + repeat``); all pairs run as one
    batched loop, ranks zero-padded to the maximum.  Plain PyTorch (no
    kernel) on ``device``; with a ``mesh`` the grid's fits split over
    all its processes.
    """
    _, x = _place(x, device, dtype)
    n, l = x.shape
    ranks = tuple(ranks)
    k_max = max(ranks)
    rng = np.random.default_rng(seed)
    _, masks = _holdout_masks(rng, (n_repeats, n, l), holdout_fraction, x)
    w0s, h0s = [], []
    for r in range(n_repeats):
        x_obs = x * masks[r]
        for k in ranks:
            w0, h0 = initialize_nmf(x_obs, k, init=init, seed=seed + r)
            w0s.append(torch.nn.functional.pad(w0, (0, k_max - k)))
            h0s.append(torch.nn.functional.pad(h0, (0, 0, 0, k_max - k)))
    gm = masks.repeat_interleave(len(ranks), dim=0)
    gx = x.expand(gm.shape)
    fits = _over_mesh(
        mesh, "cv_rank_selection",
        lambda *g: fit_mu_masked(*g, max_iter=max_iter, tol=tol),
        gx, gm, torch.stack(w0s), torch.stack(h0s))
    test_error = _heldout(x, gm, fits.w @ fits.h).reshape(n_repeats, len(ranks))
    best_rank = int(ranks[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(ranks, test_error, best_rank)


# ---------------------------------------------------------------------------
# time-varying (convolutive) stability and rank selection
# ---------------------------------------------------------------------------

@dataclass
class TimeVaryingBootstrapResult:
    """Per-synergy stability of a convolutive factorization.

    Attributes:
        reference_synergies: ``(K, D, L)`` unit-norm patterns of the
            full fit.
        similarities: ``(n_boot, K)`` matched, shift-tolerant cosine
            similarity of each reference synergy in each block-bootstrap
            refit.
    """

    reference_synergies: np.ndarray
    similarities: np.ndarray

    @property
    def mean(self) -> np.ndarray:
        return self.similarities.mean(axis=0)

    @property
    def std(self) -> np.ndarray:
        return self.similarities.std(axis=0)


def _best_shift(a: np.ndarray, b: np.ndarray, max_shift: int):
    """Best overlap-windowed cosine of two ``(D, L)`` patterns + its lag.

    Returns ``(similarity, shift)`` where ``shift >= 0`` means ``b``
    delayed by ``shift`` lags matches ``a`` (``a[shift + t] ~ b[t]``).
    """
    d = a.shape[0]
    best, best_sh = -1.0, 0
    for sh in range(-max_shift, max_shift + 1):
        if sh >= 0:
            aa, bb = a[sh:], b[: d - sh]
        else:
            aa, bb = a[: d + sh], b[-sh:]
        na, nb = np.linalg.norm(aa), np.linalg.norm(bb)
        if na == 0 or nb == 0:
            continue
        sim = float(np.sum(aa * bb) / (na * nb))
        if sim > best:
            best, best_sh = sim, sh
    return best, best_sh


def _shifted_cosine(a: np.ndarray, b: np.ndarray, max_shift: int) -> float:
    """Cosine of two ``(D, L)`` patterns at their best relative lag shift
    (the convolutive model's time-shift indeterminacy makes the plain
    flattened cosine under-score stable synergies)."""
    return _best_shift(a, b, max_shift)[0]


def _shifted_similarity(a: np.ndarray, b: np.ndarray, max_shift: int) -> np.ndarray:
    """``(len(a), len(b))`` shift-tolerant cosines of two synergy stacks."""
    sim = np.zeros((a.shape[0], b.shape[0]))
    for i in range(a.shape[0]):
        for j in range(b.shape[0]):
            sim[i, j] = _shifted_cosine(a[i], b[j], max_shift)
    return sim


def _match_time_varying(
    s_ref: np.ndarray, s_boot: np.ndarray, max_shift: int
) -> np.ndarray:
    """Best-assignment shift-tolerant similarity per reference synergy."""
    from scipy.optimize import linear_sum_assignment

    sim = _shifted_similarity(s_ref, s_boot, max_shift)
    rows, cols = linear_sum_assignment(-sim)
    matched = np.zeros(s_ref.shape[0])
    matched[rows] = sim[rows, cols]
    return matched


def _block_bootstrap_indices(n, block_len, n_boot, rng) -> np.ndarray:
    """Moving-block bootstrap index matrix ``(n_boot, n)``: contiguous
    blocks of ``block_len >= n_lags`` samples keep every lag window
    intact except at the block seams."""
    n_blocks = -(-n // block_len)  # ceil
    starts = rng.integers(0, n - block_len + 1, size=(n_boot, n_blocks))
    offsets = np.arange(block_len)
    return (starts[:, :, None] + offsets).reshape(n_boot, -1)[:, :n]


def bootstrap_time_varying_synergies(
    x,
    n_synergies: int,
    n_lags: int,
    n_boot: int = 50,
    block_len: Optional[int] = None,
    seed: int = 0,
    max_iter: int = 300,
    tol: float = 1e-5,
    match_max_shift: Optional[int] = None,
    mesh=None,
    _resample_plan=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    impl: str = "auto",
) -> TimeVaryingBootstrapResult:
    """Block-bootstrap the time axis and score synergy stability.

    Resamples are moving blocks (default ``block_len = 4 * n_lags``, at
    least 16) so lag windows survive; the full fit and every refit run
    as one batch of convolutive fits (one K5 launch on the card), and
    matching tolerates the model's time-shift indeterminacy
    (``match_max_shift`` lags each way, default ``n_lags // 2``).
    ``_resample_plan`` is ``(indices, row0)``: precomputed rows and
    their global offset, so the per-row init seeds ``seed + row0 + b``
    match the unchunked run.  With a ``mesh`` the batch runs through
    :func:`~..parallel.sharded_fit_cnmf` (no kernel).
    """
    host, x = _place(x, device, dtype)
    n = x.shape[0]
    if block_len is None:
        block_len = min(max(4 * n_lags, 16), n)
    if not n_lags <= block_len <= n:
        raise ValueError(
            f"block_len must be in [n_lags={n_lags}, n_samples={n}], "
            f"got {block_len}"
        )
    if match_max_shift is None:
        match_max_shift = n_lags // 2

    c0, s0 = _cnmf.init_cnmf(host, n_synergies, n_lags, seed=seed)
    if _resample_plan is None:
        rng = np.random.default_rng(seed)
        idx = _block_bootstrap_indices(n, block_len, n_boot, rng)
        row0 = 0
    else:
        idx, row0 = _resample_plan
        n_boot = idx.shape[0]
    c0b, s0b = _cnmf.init_cnmf(host[idx], n_synergies, n_lags, seed=seed + row0)
    xs = torch.cat([x[None], x[torch.as_tensor(idx, device=x.device)]])
    c0s = as_tensor(np.concatenate([c0[None], c0b]), x.device, x.dtype)
    s0s = as_tensor(np.concatenate([s0[None], s0b]), x.device, x.dtype)
    from ..parallel.cnmf import sharded_fit_cnmf

    states = _sharded_solve(
        mesh, "bootstrap_time_varying_synergies", n, n_lags,
        lambda *g: sharded_fit_cnmf(*g, max_iter=max_iter, tol=tol), xs, c0s, s0s)
    if states is None:
        states = _cnmf.fit_cnmf_batch(xs, c0s, s0s, max_iter=max_iter, tol=tol,
                                      impl=impl)
    _, s_all = _cnmf.normalize_synergies(states.c, states.s)
    s_all = to_numpy(s_all).astype(float)
    s_ref = s_all[0]
    sims = np.stack([
        _match_time_varying(s_ref, s_all[1 + b], match_max_shift)
        for b in range(n_boot)
    ])
    return TimeVaryingBootstrapResult(reference_synergies=s_ref, similarities=sims)


def fit_cnmf_masked(
    x,
    mask,
    c0,
    s0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
) -> _cnmf.CNMFState:
    """Masked convolutive NMF: minimize ``||mask * (X - X^)||_F``.

    The loop and stopping rule of
    :func:`~muscle_synergies_tpu_torch.models.cnmf.fit_cnmf` on observed
    (mask = 1) entries: whole chunks of ``check_every`` updates (so the
    count may pass ``max_iter``), a fit stopping when ``(previous -
    current) / max(initial, EPSILON) < tol``.  One problem ``(T, L)``
    or a batch ``(B, T, L)``, each fit stopping on its own.
    """
    x = as_tensor(x)
    mask, c0, s0 = (as_tensor(a, x.device, x.dtype) for a in (mask, c0, s0))
    return _cnmf._fit_loop(x, c0, s0, _cnmf._masked_update, _cnmf._masked_error,
                           max_iter, tol, check_every, mask=mask)


def cv_time_varying_rank_selection(
    x,
    ranks: Sequence[int],
    n_lags: int,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 300,
    tol: float = 1e-5,
    mesh=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> CVResult:
    """Wold-style CV for the convolutive model's synergy count.

    Hold out random entries, fit :func:`fit_cnmf_masked` on the rest for
    every (repeat, rank) pair as one batched loop (synergy counts
    zero-padded to the maximum), and score each rank's held-out
    reconstruction error.  Plain PyTorch (no kernel) on ``device``.
    """
    host, x = _place(x, device, dtype)
    n, l = x.shape
    ranks = tuple(ranks)
    k_max = max(ranks)
    rng = np.random.default_rng(seed)
    masks_host, masks = _holdout_masks(rng, (n_repeats, n, l), holdout_fraction, x)
    c0s, s0s = [], []
    for r in range(n_repeats):
        x_obs = host * masks_host[r]
        for k in ranks:
            c0, s0 = _cnmf.init_cnmf(x_obs, k, n_lags, seed=seed + r)
            c0s.append(np.pad(c0, ((0, 0), (0, k_max - k))))
            s0s.append(np.pad(s0, ((0, k_max - k), (0, 0), (0, 0))))
    gm = masks.repeat_interleave(len(ranks), dim=0)
    fits = _over_mesh(
        mesh, "cv_time_varying_rank_selection",
        lambda *g: fit_cnmf_masked(*g, max_iter=max_iter, tol=tol),
        x.expand(gm.shape), gm, as_tensor(np.stack(c0s), x.device, x.dtype),
        as_tensor(np.stack(s0s), x.device, x.dtype))
    rec = _cnmf.cnmf_reconstruct(fits.c, fits.s)
    test_error = _heldout(x, gm, rec).reshape(n_repeats, len(ranks))
    best_rank = int(ranks[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(ranks, test_error, best_rank)


# ---------------------------------------------------------------------------
# space-by-time (NM3F) stability and module-count selection
# ---------------------------------------------------------------------------

def _fit_stack(xs, inits, max_iter, tol, update_w=True, update_s=True, mask=None,
               mesh=None, caller: str = ""):
    """Every fit of ``inits`` (``[(W, A, S), ...]`` host arrays) at once,
    each stopping on its own: :func:`fit_nm3f` restart by restart.  The
    trials are shared ``(B, T, L)`` or per fit ``(R, B, T, L)``; with a
    ``mesh`` the fits split over its processes."""
    w0, a0, s0 = (as_tensor(np.stack(f), xs.device, xs.dtype) for f in zip(*inits))
    per_fit = [w0, a0, s0] + ([xs] if xs.ndim == 4 else []) + (
        [] if mask is None else [mask])

    def fit(w, a, s, *rest):
        rest = list(rest)
        x_fit = rest.pop(0) if xs.ndim == 4 else xs.to(w.device)
        return _nm3f._fit_restarts(x_fit, w, a, s, max_iter, tol, 10, update_w,
                                   update_s, None, mask=rest[0] if rest else None)

    return _over_mesh(mesh, caller, fit, *per_fit)


def _trial_stack(xs, device, dtype):
    """``(host float64 copy, placed tensor)`` of a ``(B, T, L)`` stack."""
    host, placed = _place(xs, device, dtype)
    if host.ndim != 3:
        raise ValueError(f"expected a (B, T, L) trial stack, got shape {host.shape}")
    return host, placed


def bootstrap_space_by_time(
    xs,
    n_temporal: int,
    n_spatial: int,
    n_boot: int = 50,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
):
    """Trial-axis bootstrap stability of the shared NM3F modules.

    Trials are exchangeable under the space-by-time model, so the plain
    iid bootstrap resamples whole trial sets.  The full fit (init seeded
    ``seed``) and the ``n_boot`` refits (resample ``r`` seeded ``seed +
    1 + row0 + r``) run as one batched loop, each fit on its own trial
    set and stopping on its own; each reference module is scored by its
    best-assignment cosine similarity across refits.

    Returns:
        ``(temporal BootstrapResult, spatial BootstrapResult)``: the
        reference components are the unit-norm ``(P, T)`` temporal and
        ``(Q, L)`` spatial modules of the full fit.
    """
    host, x = _trial_stack(xs, device, dtype)
    b = host.shape[0]
    if _resample_plan is None:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, b, size=(n_boot, b))
        row0 = 0
    else:
        idx, row0 = _resample_plan
        n_boot = idx.shape[0]
    inits = [_nm3f.init_nm3f(host, n_temporal, n_spatial, seed=seed)]
    inits += [_nm3f.init_nm3f(host[idx[r]], n_temporal, n_spatial,
                              seed=seed + 1 + row0 + r) for r in range(n_boot)]
    stack = torch.cat([x[None], x[torch.as_tensor(idx, device=x.device)]])
    states = _fit_stack(stack, inits, max_iter, tol, mesh=mesh,
                        caller="bootstrap_space_by_time")
    wn = to_numpy(_unit(states.w, -2).transpose(-1, -2)).astype(float)  # (R, P, T)
    sn = to_numpy(_unit(states.s, -1)).astype(float)  # (R, Q, L)
    sims_w = np.stack([_match_components(wn[0], wn[1 + r]) for r in range(n_boot)])
    sims_s = np.stack([_match_components(sn[0], sn[1 + r]) for r in range(n_boot)])
    return (
        BootstrapResult(reference_components=wn[0], similarities=sims_w),
        BootstrapResult(reference_components=sn[0], similarities=sims_s),
    )


def fit_nm3f_masked(
    xs,
    mask,
    w0,
    a0,
    s0,
    max_iter: int = 400,
    tol: float = 1e-6,
    check_every: int = 10,
    update_w: bool = True,
    update_s: bool = True,
) -> _nm3f.NM3FState:
    """Masked NM3F: minimize ``||mask * (X - W A S)||_F`` where ``xs`` lies.

    The loop and stopping rule of
    :func:`~muscle_synergies_tpu_torch.models.nm3f.fit_nm3f` on observed
    (mask = 1) entries: chunks of ``check_every`` updates, the last one
    cut at ``max_iter``, a fit converging only at a multiple of
    ``check_every`` when ``(previous - current) / max(initial, EPSILON)
    < tol``.  The masked updates rebuild the full reconstruction per
    half-step (no Gram shortcut exists under a mask).  ``update_w`` /
    ``update_s`` freeze a module set (the tMod/sMod specializations).
    """
    xs = as_tensor(xs)
    mask, w0, a0, s0 = (as_tensor(f, xs.device, xs.dtype) for f in (mask, w0, a0, s0))
    state = _nm3f._fit_restarts(xs, w0[None], a0[None], s0[None], max_iter, tol,
                                check_every, update_w, update_s, None, mask=mask[None])
    return _nm3f.NM3FState(*(f[0] for f in state))


class SpaceByTimeCVResult(NamedTuple):
    """Held-out module-count selection outcome.

    ``test_error``: ``(n_repeats, n_pairs)`` relative held-out errors,
    one column per ``(P, Q)`` candidate.  ``best``: the pair minimizing
    the mean held-out error.
    """

    pairs: tuple
    test_error: np.ndarray
    best: tuple

    @property
    def mean_test_error(self) -> np.ndarray:
        return self.test_error.mean(axis=0)


def _padded(w0, a0, s0, p_max: int, q_max: int):
    """NM3F factors zero-padded to ``p_max`` temporal and ``q_max``
    spatial modules."""
    p, q = w0.shape[1], s0.shape[0]
    return (np.pad(w0, ((0, 0), (0, p_max - p))),
            np.pad(a0, ((0, 0), (0, p_max - p), (0, q_max - q))),
            np.pad(s0, ((0, q_max - q), (0, 0))))


def _cv_grid(x, masks, inits, n_repeats, max_iter, tol, update_w=True,
             update_s=True, mesh=None, caller: str = "") -> np.ndarray:
    """Held-out errors ``(n_repeats, n_candidates)`` of one batched
    masked NM3F loop over the (repeat, candidate) grid."""
    per_repeat = len(inits) // n_repeats
    gm = masks.repeat_interleave(per_repeat, dim=0)
    fits = _fit_stack(x, inits, max_iter, tol, update_w, update_s, mask=gm,
                      mesh=mesh, caller=caller)
    rec = _nm3f._reconstruct(fits.w, fits.a, fits.s)
    return _heldout(x, gm, rec).reshape(n_repeats, per_repeat)


def cv_space_by_time_selection(
    xs,
    pairs: Sequence,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> SpaceByTimeCVResult:
    """Wold-style CV over ``(n_temporal, n_spatial)`` candidates.

    Hold out random entries across the whole trial stack, fit
    :func:`fit_nm3f_masked` on the rest for every (repeat, pair) as one
    batched loop with both module counts zero-padded to the grid maxima,
    and score each candidate's held-out reconstruction error.
    """
    host, x = _trial_stack(xs, device, dtype)
    b, t, l = host.shape
    pairs = tuple((int(p), int(q)) for p, q in pairs)
    p_max = max(p for p, _ in pairs)
    q_max = max(q for _, q in pairs)
    rng = np.random.default_rng(seed)
    masks_host, masks = _holdout_masks(rng, (n_repeats, b, t, l), holdout_fraction, x)
    inits = [_padded(*_nm3f.init_nm3f(host * masks_host[r], p, q, seed=seed + r),
                     p_max, q_max)
             for r in range(n_repeats) for p, q in pairs]
    test_error = _cv_grid(x, masks, inits, n_repeats, max_iter, tol, mesh=mesh,
                          caller="cv_space_by_time_selection")
    best = pairs[int(np.argmin(test_error.mean(axis=0)))]
    return SpaceByTimeCVResult(pairs, test_error, best)


# ---------------------------------------------------------------------------
# cross-set synergy comparison
# ---------------------------------------------------------------------------

class SynergyMatch(NamedTuple):
    """Best-assignment pairing between two synergy sets.

    Attributes:
        pairs: matched ``(i, j)`` index pairs (component ``i`` of set A
            with component ``j`` of set B), ``min(k_a, k_b)`` of them,
            ordered by ``i``.
        similarities: cosine similarity of each pair (shift-tolerant
            for time-varying sets), aligned with ``pairs``.
        similarity_matrix: the full ``(k_a, k_b)`` similarity matrix
            the assignment optimized over.
    """

    pairs: list
    similarities: np.ndarray
    similarity_matrix: np.ndarray

    @property
    def mean(self) -> float:
        """Mean matched similarity: the set-level agreement score."""
        return float(self.similarities.mean()) if len(self.pairs) else 0.0


def match_synergies(a, b, max_shift: Optional[int] = None) -> SynergyMatch:
    """Match two synergy sets and score their similarity.

    The one-to-one assignment between the two sets that maximizes total
    cosine similarity (Hungarian algorithm; rectangular sets pair
    ``min(k_a, k_b)`` components), on the host.

    Args:
        a / b: ``(k, L)`` spatial components (arrays, tensors or
            DataFrames) or ``(K, D, L)`` time-varying synergy stacks;
            both of one kind and trailing shape.
        max_shift: time-varying sets only: the lag tolerance of the
            shift-invariant cosine (default ``D // 2``).
    """
    a, b = (np.asarray(to_numpy(s) if isinstance(s, torch.Tensor) else s, dtype=float)
            for s in (a, b))
    if a.ndim != b.ndim or a.ndim not in (2, 3):
        raise ValueError(
            "expected two (k, L) spatial sets or two (K, D, L) "
            f"time-varying sets, got shapes {a.shape} and {b.shape}"
        )
    if a.shape[1:] != b.shape[1:]:
        raise ValueError(
            f"synergy shapes differ: {a.shape[1:]} vs {b.shape[1:]}"
        )
    if a.ndim == 2:
        if max_shift is not None:
            raise ValueError(
                "max_shift applies to (K, D, L) time-varying sets only"
            )
        sim = _normalize_rows(a) @ _normalize_rows(b).T
    else:
        if max_shift is None:
            max_shift = a.shape[1] // 2
        sim = _shifted_similarity(a, b, max_shift)

    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(-sim)
    order = np.argsort(rows)
    pairs = [(int(rows[t]), int(cols[t])) for t in order]
    return SynergyMatch(
        pairs=pairs,
        similarities=sim[rows[order], cols[order]],
        similarity_matrix=sim,
    )


# ---------------------------------------------------------------------------
# shared-factor (tMod / sMod) selection and stability
# ---------------------------------------------------------------------------

def _check_module_count(k: int, bound: int, what: str) -> None:
    if not 1 <= k <= bound:
        raise ValueError(f"{what} {k} outside [1, {bound}]")


def _cv_shared_factor_selection(
    xs,
    candidates,
    temporal: bool,
    holdout_fraction: float,
    n_repeats: int,
    seed: int,
    max_iter: int,
    tol: float,
    mesh=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> CVResult:
    """Wold-style CV core shared by the tMod/sMod selectors: one batched
    masked NM3F loop over the (repeat, candidate) grid, the free side
    zero-padded to the grid maximum and the other frozen at identity;
    the inits drawn from the masks' generator, after them."""
    host, x = _trial_stack(xs, device, dtype)
    b, t, l = host.shape
    candidates = tuple(int(k) for k in candidates)
    for k in candidates:
        _check_module_count(k, t if temporal else l, "candidate module count")
    k_max = max(candidates)
    rng = np.random.default_rng(seed)
    masks_host, masks = _holdout_masks(rng, (n_repeats, b, t, l), holdout_fraction, x)
    eye = np.eye(l if temporal else t)
    inits = []
    for r in range(n_repeats):
        x_obs = host * masks_host[r]
        for k in candidates:
            c = (max(x_obs.mean(), 0.0) / k) ** 0.5 if x_obs.size else 1.0
            if temporal:
                w0 = np.zeros((t, k_max))
                w0[:, :k] = rng.uniform(0, 2 * c, (t, k))
                a0 = np.zeros((b, k_max, l))
                a0[:, :k, :] = rng.uniform(0, 2 * c, (b, k, l))
                inits.append((w0, a0, eye))
            else:
                a0 = np.zeros((b, t, k_max))
                a0[:, :, :k] = rng.uniform(0, 2 * c, (b, t, k))
                s0 = np.zeros((k_max, l))
                s0[:k] = rng.uniform(0, 2 * c, (k, l))
                inits.append((eye, a0, s0))
    test_error = _cv_grid(x, masks, inits, n_repeats, max_iter, tol,
                          update_w=temporal, update_s=not temporal, mesh=mesh,
                          caller="cv_temporal_selection" if temporal
                          else "cv_shared_spatial_selection")
    best = candidates[int(np.argmin(test_error.mean(axis=0)))]
    return CVResult(candidates, test_error, best)


def cv_temporal_selection(
    xs,
    candidates: Sequence,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> CVResult:
    """Held-out module-count selection for the shared-temporal model.

    The tMod counterpart of :func:`cv_space_by_time_selection`: the
    masked trilinear fit runs with the spatial side frozen at identity
    (:func:`~muscle_synergies_tpu_torch.models.nm3f.find_temporal_synergies`'s
    model); ``best_rank`` is the selected module count.
    """
    return _cv_shared_factor_selection(
        xs, candidates, True, holdout_fraction, n_repeats, seed,
        max_iter, tol, mesh=mesh, device=device, dtype=dtype,
    )


def cv_shared_spatial_selection(
    xs,
    candidates: Sequence,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> CVResult:
    """Held-out module-count selection for the shared-spatial model: the
    temporal side frozen at identity, candidates are spatial module
    counts ``Q``."""
    return _cv_shared_factor_selection(
        xs, candidates, False, holdout_fraction, n_repeats, seed,
        max_iter, tol, mesh=mesh, device=device, dtype=dtype,
    )


def _bootstrap_shared_factor(
    xs, k: int, temporal: bool, n_boot: int, seed: int,
    max_iter: int, tol: float, mesh=None, _resample_plan=None,
    device="cuda", dtype: Optional[torch.dtype] = None,
) -> BootstrapResult:
    """Trial-axis bootstrap core shared by the tMod/sMod wrappers: the
    full fit (init seeded ``seed``) and the refits (``seed + 1 + row0 +
    r``) with one side frozen at identity, as one batched loop."""
    host, x = _trial_stack(xs, device, dtype)
    b, t, l = host.shape
    _check_module_count(k, t if temporal else l, "module count")
    eye = np.eye(l if temporal else t)
    rng = np.random.default_rng(seed)

    def random_init(x_sub, r):
        c = (max(x_sub.mean(), 0.0) / k) ** 0.5 if x_sub.size else 1.0
        local = np.random.default_rng(seed + 1 + r)
        if temporal:
            w0 = local.uniform(0, 2 * c, (t, k))
            a0 = local.uniform(0, 2 * c, (b, k, l))
            return w0, a0, eye
        a0 = local.uniform(0, 2 * c, (b, t, k))
        s0 = local.uniform(0, 2 * c, (k, l))
        return eye, a0, s0

    if _resample_plan is None:
        idx = rng.integers(0, b, size=(n_boot, b))
        row0 = 0
    else:
        idx, row0 = _resample_plan
        n_boot = idx.shape[0]
    inits = [random_init(host, -1)]
    inits += [random_init(host[idx[r]], row0 + r) for r in range(n_boot)]
    stack = torch.cat([x[None], x[torch.as_tensor(idx, device=x.device)]])
    states = _fit_stack(stack, inits, max_iter, tol, update_w=temporal,
                        update_s=not temporal, mesh=mesh,
                        caller="bootstrap_temporal_synergies" if temporal
                        else "bootstrap_shared_spatial_synergies")
    if temporal:
        mods = _unit(states.w, -2).transpose(-1, -2)  # (R, k, T)
    else:
        mods = _unit(states.s, -1)  # (R, k, L)
    mods = to_numpy(mods).astype(float)
    sims = np.stack([_match_components(mods[0], mods[1 + r]) for r in range(n_boot)])
    return BootstrapResult(reference_components=mods[0], similarities=sims)


def bootstrap_temporal_synergies(
    xs,
    n_temporal: int,
    n_boot: int = 50,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> BootstrapResult:
    """Trial-axis bootstrap stability of the shared-temporal model (the
    spatial side frozen at identity); the reference components are the
    unit-norm ``(P, T)`` temporal modules of the full fit."""
    return _bootstrap_shared_factor(
        xs, n_temporal, True, n_boot, seed, max_iter, tol, mesh=mesh,
        _resample_plan=_resample_plan, device=device, dtype=dtype,
    )


def bootstrap_shared_spatial_synergies(
    xs,
    n_spatial: int,
    n_boot: int = 50,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> BootstrapResult:
    """Trial-axis bootstrap stability of the shared-spatial model (the
    temporal side frozen at identity); the reference components are the
    unit-norm ``(Q, L)`` spatial modules of the full fit."""
    return _bootstrap_shared_factor(
        xs, n_spatial, False, n_boot, seed, max_iter, tol, mesh=mesh,
        _resample_plan=_resample_plan, device=device, dtype=dtype,
    )


# ---------------------------------------------------------------------------
# N-set synergy clustering (group-level common synergies)
# ---------------------------------------------------------------------------

class SynergyClusters(NamedTuple):
    """Group-level clustering of synergy sets from many subjects/conditions.

    Attributes:
        labels: one int array per input set: the cluster id (0-based)
            of each of that set's components.
        consensus: ``(n_clusters, L)`` or ``(n_clusters, D, L)``
            unit-norm cluster-mean synergies (time-varying members are
            lag-aligned to the cluster medoid before averaging).
        membership: ``(n_clusters, n_sets)`` int counts: how many of
            set ``j``'s components landed in cluster ``i``.
        similarity_matrix: the pooled ``(total, total)`` cosine
            similarity matrix the clustering ran on (shift-tolerant
            for time-varying sets).
        set_index: ``(total,)``: which input set each pooled row came
            from.
    """

    labels: list
    consensus: np.ndarray
    membership: np.ndarray
    similarity_matrix: np.ndarray
    set_index: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.membership.shape[0]

    @property
    def coverage(self) -> np.ndarray:
        """Fraction of input sets represented in each cluster."""
        return (self.membership > 0).mean(axis=1)

    @property
    def shared(self) -> np.ndarray:
        """Indices of clusters with a member from *every* input set."""
        return np.flatnonzero((self.membership > 0).all(axis=1))


def _shift_pattern(p: np.ndarray, sh: int) -> np.ndarray:
    """Delay a ``(D, L)`` pattern by ``sh`` lags with zero fill."""
    out = np.zeros_like(p)
    d = p.shape[0]
    if sh >= 0:
        out[sh:] = p[: d - sh]
    else:
        out[: d + sh] = p[-sh:]
    return out


def cluster_synergies(
    sets,
    n_clusters: Optional[int] = None,
    max_shift: Optional[int] = None,
) -> SynergyClusters:
    """Cluster synergy sets from many subjects/conditions at once.

    The N-set generalization of :func:`match_synergies`: pool every
    component from every set, run average-linkage hierarchical
    clustering on cosine distance (SciPy, on the host), and report which
    clusters are shared across all sets (``.shared`` / ``.coverage``)
    and the unit-norm consensus synergy of each cluster.

    Args:
        sets: two or more synergy sets, all ``(k_i, L)`` spatial
            components (arrays, tensors or DataFrames), or all
            ``(K_i, D, L)`` time-varying stacks with equal ``(D, L)``.
        n_clusters: where to cut the dendrogram; defaults to the
            rounded mean set size.  Hierarchical cutting can produce
            fewer non-empty clusters; the result reports the realized
            count.
        max_shift: time-varying sets only: lag tolerance of the
            shift-invariant cosine (default ``D // 2``).
    """
    arrays = [np.asarray(to_numpy(s) if isinstance(s, torch.Tensor) else s, dtype=float)
              for s in sets]
    if len(arrays) < 2:
        raise ValueError("need at least two synergy sets to cluster")
    ndim = arrays[0].ndim
    if ndim not in (2, 3) or any(a.ndim != ndim for a in arrays):
        raise ValueError(
            "expected all (k, L) spatial sets or all (K, D, L) "
            f"time-varying sets, got shapes {[a.shape for a in arrays]}"
        )
    trailing = arrays[0].shape[1:]
    if any(a.shape[1:] != trailing for a in arrays):
        raise ValueError(
            f"synergy shapes differ: {[a.shape[1:] for a in arrays]}"
        )
    if ndim == 2 and max_shift is not None:
        raise ValueError(
            "max_shift applies to (K, D, L) time-varying sets only"
        )

    pooled = np.concatenate(arrays, axis=0)
    set_index = np.concatenate(
        [np.full(a.shape[0], j) for j, a in enumerate(arrays)]
    )
    total = pooled.shape[0]
    if n_clusters is None:
        n_clusters = max(1, round(np.mean([a.shape[0] for a in arrays])))
    n_clusters = int(n_clusters)
    if not 1 <= n_clusters <= total:
        raise ValueError(
            f"n_clusters={n_clusters} out of range for {total} pooled "
            "components"
        )

    if ndim == 2:
        unit = _normalize_rows(pooled)
        sim = np.clip(unit @ unit.T, -1.0, 1.0)
    else:
        if max_shift is None:
            max_shift = trailing[0] // 2
        sim = np.eye(total)
        for i in range(total):
            for j in range(i + 1, total):
                sim[i, j] = sim[j, i] = _shifted_cosine(
                    pooled[i], pooled[j], max_shift
                )

    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    dist = np.maximum(1.0 - sim, 0.0)
    np.fill_diagonal(dist, 0.0)
    raw = fcluster(
        linkage(squareform(dist, checks=False), method="average"),
        t=n_clusters,
        criterion="maxclust",
    )
    # relabel 0-based in order of first appearance (fcluster ids are
    # arbitrary), so labels are deterministic in the pooled order
    remap: dict = {}
    labels_flat = np.array([remap.setdefault(r, len(remap)) for r in raw])
    n_real = len(remap)

    n_sets = len(arrays)
    membership = np.zeros((n_real, n_sets), dtype=int)
    np.add.at(membership, (labels_flat, set_index), 1)

    consensus = np.zeros((n_real,) + trailing)
    for c in range(n_real):
        members = np.flatnonzero(labels_flat == c)
        if ndim == 2:
            mean = unit[members].mean(axis=0)
        else:
            # lag-align members to the cluster medoid (the member most
            # similar to the rest) before averaging, else the model's
            # time-shift indeterminacy smears the consensus
            block = sim[np.ix_(members, members)]
            medoid = pooled[members[int(np.argmax(block.sum(axis=1)))]]
            aligned = []
            for m in members:
                _, sh = _best_shift(medoid, pooled[m], max_shift)
                shifted = _shift_pattern(pooled[m], sh)
                norm = np.linalg.norm(shifted)
                aligned.append(shifted / (norm if norm else 1.0))
            mean = np.mean(aligned, axis=0)
        norm = np.linalg.norm(mean)
        consensus[c] = mean / (norm if norm else 1.0)

    splits = np.cumsum([a.shape[0] for a in arrays])[:-1]
    return SynergyClusters(
        labels=list(np.split(labels_flat, splits)),
        consensus=consensus,
        membership=membership,
        similarity_matrix=sim,
        set_index=set_index,
    )
