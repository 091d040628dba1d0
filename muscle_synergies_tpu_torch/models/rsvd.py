"""Host-side randomized SVD and sklearn-exact NMF initialization.

A copy of :mod:`muscle_synergies_tpu.models.rsvd` (NumPy and SciPy
only).  The default NNDSVD path in
:mod:`muscle_synergies_tpu_torch.models.init` uses an exact SVD in torch
so batched initialization runs on the device.  sklearn
instead seeds NNDSVD from a *randomized* SVD (Halko et al. 2009,
Algorithm 4.3), so with an integer ``random_state`` its default init is
a deterministic function of the RandomState stream.  This module
replicates that computation bit-for-bit on host — same normal draws,
same LU/QR power-iteration normalization, same LAPACK driver, same
sign-flip convention — so default-init solver *trajectories* (not just
final losses) can be compared iterate-by-iterate against
``sklearn.decomposition.NMF``.

Capability parity target: the reference runs sklearn NMF with its
default init (reference: src/muscle_synergies/analysis.py:848-864);
sklearn resolves ``init=None`` to NNDSVDA over ``randomized_svd``
(sklearn ``_nmf._initialize_nmf``).  Initialization is a one-off host
computation (the hot path is the solver loop), so numpy/scipy here is
the right tool — exactly as the filter-design stage delegates to scipy.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
from scipy import linalg as _sla

__all__ = ["randomized_svd", "initialize_nmf_sklearn"]

RandomStateLike = Union[None, int, np.random.RandomState]


def _as_random_state(random_state: RandomStateLike) -> np.random.RandomState:
    """sklearn ``check_random_state`` semantics (legacy RandomState)."""
    if random_state is None:
        return np.random.mtrand._rand
    if isinstance(random_state, (int, np.integer)):
        return np.random.RandomState(random_state)
    if isinstance(random_state, np.random.RandomState):
        return random_state
    raise ValueError(
        f"{random_state!r} cannot be used to seed a numpy.random.RandomState"
    )


def _svd_flip_np(u, vt, u_based_decision=True):
    """Deterministic SVD signs, matching ``sklearn.utils.extmath.svd_flip``.

    Note sklearn multiplies by ``sign(pivot)`` directly, so an exactly
    zero pivot zeroes the column — preserved here for bit parity.
    """
    if u_based_decision:
        pivot_rows = np.argmax(np.abs(u), axis=0)
        signs = np.sign(u[pivot_rows, np.arange(u.shape[1])])
    else:
        pivot_cols = np.argmax(np.abs(vt), axis=1)
        signs = np.sign(vt[np.arange(vt.shape[0]), pivot_cols])
    return u * signs[np.newaxis, :], vt * signs[:, np.newaxis]


def _range_finder(
    a: np.ndarray,
    size: int,
    n_iter: int,
    power_iteration_normalizer: str,
    rng: np.random.RandomState,
) -> np.ndarray:
    """Orthonormal basis approximating range(a) (Halko Algorithm 4.3)."""
    q = rng.normal(size=(a.shape[1], size))
    if a.dtype == np.float32:
        q = q.astype(np.float32, copy=False)

    if power_iteration_normalizer == "auto":
        power_iteration_normalizer = "none" if n_iter <= 2 else "LU"

    def qr(m):
        return _sla.qr(m, mode="economic", check_finite=False)[0]

    if power_iteration_normalizer == "LU":
        normalize = lambda m: _sla.lu(  # noqa: E731
            m, permute_l=True, check_finite=False
        )[0]
    elif power_iteration_normalizer == "QR":
        normalize = qr
    elif power_iteration_normalizer == "none":
        normalize = lambda m: m  # noqa: E731
    else:
        raise ValueError(
            f"unknown power_iteration_normalizer: {power_iteration_normalizer!r}"
        )

    for _ in range(n_iter):
        q = normalize(a @ q)
        q = normalize(a.T @ q)
    return qr(a @ q)


def randomized_svd(
    m: np.ndarray,
    n_components: int,
    n_oversamples: int = 10,
    n_iter: Union[int, str] = "auto",
    power_iteration_normalizer: str = "auto",
    transpose: Union[bool, str] = "auto",
    flip_sign: bool = True,
    random_state: RandomStateLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncated randomized SVD, bit-matching sklearn's for a given seed.

    Returns ``(U, S, Vt)`` with ``U: (N, k)``, ``S: (k,)``,
    ``Vt: (k, L)``.  Defaults mirror ``sklearn.utils.extmath.
    randomized_svd``: ``n_iter="auto"`` resolves to 7 when
    ``k < 0.1 * min(N, L)`` else 4, the power iterations are
    LU-normalized when ``n_iter > 2``, the matrix is transposed when
    ``N < L``, and signs follow ``svd_flip`` (u-based, or v-based when
    transposed).
    """
    m = np.asarray(m)
    rng = _as_random_state(random_state)
    n_random = n_components + n_oversamples
    n_samples, n_features = m.shape

    if n_iter == "auto":
        n_iter = 7 if n_components < 0.1 * min(m.shape) else 4
    if transpose == "auto":
        transpose = n_samples < n_features
    if transpose:
        m = m.T

    q = _range_finder(m, n_random, n_iter, power_iteration_normalizer, rng)
    b = q.T @ m
    u_hat, s, vt = _sla.svd(b, full_matrices=False, lapack_driver="gesdd")
    u = q @ u_hat

    if flip_sign:
        u, vt = _svd_flip_np(u, vt, u_based_decision=not transpose)

    if transpose:
        return vt[:n_components].T, s[:n_components], u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components]


def initialize_nmf_sklearn(
    x: np.ndarray,
    n_components: int,
    init: Optional[str] = None,
    eps: float = 1e-6,
    random_state: RandomStateLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Initial ``(W, H)`` bit-matching ``sklearn _initialize_nmf``.

    Host-side numpy throughout: the NNDSVD split runs over the
    randomized SVD above, and the nndsvdar/random fills consume the
    RandomState stream in sklearn's exact order (H before W for
    ``random``; W-zeros before H-zeros for ``nndsvdar``).
    """
    x = np.asarray(x)
    if np.any(x < 0):
        raise ValueError("Negative values in data passed to NMF initialization")
    n, l = x.shape
    if init is not None and init != "random" and n_components > min(n, l):
        raise ValueError(
            f"init = '{init}' can only be used when "
            "n_components <= min(n_samples, n_features)"
        )
    if init is None:
        init = "nndsvda" if n_components <= min(n, l) else "random"

    if init == "random":
        avg = np.sqrt(x.mean() / n_components)
        rng = _as_random_state(random_state)
        h = np.abs(
            avg * rng.standard_normal(size=(n_components, l)).astype(x.dtype)
        )
        w = np.abs(
            avg * rng.standard_normal(size=(n, n_components)).astype(x.dtype)
        )
        return w, h
    if init not in {"nndsvd", "nndsvda", "nndsvdar"}:
        raise ValueError(
            f"Invalid init parameter: got {init!r} instead of one of "
            "(None, 'random', 'nndsvd', 'nndsvda', 'nndsvdar')"
        )

    u, s, vt = randomized_svd(x, n_components, random_state=random_state)
    w = np.zeros_like(u)
    h = np.zeros_like(vt)
    w[:, 0] = np.sqrt(s[0]) * np.abs(u[:, 0])
    h[0] = np.sqrt(s[0]) * np.abs(vt[0])

    for j in range(1, n_components):
        xj, yj = u[:, j], vt[j]
        x_p, y_p = np.maximum(xj, 0), np.maximum(yj, 0)
        x_n, y_n = np.abs(np.minimum(xj, 0)), np.abs(np.minimum(yj, 0))
        x_p_nrm, y_p_nrm = np.linalg.norm(x_p), np.linalg.norm(y_p)
        x_n_nrm, y_n_nrm = np.linalg.norm(x_n), np.linalg.norm(y_n)
        m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
        if m_p > m_n:
            uu, vv, sigma = x_p / x_p_nrm, y_p / y_p_nrm, m_p
        else:
            uu, vv, sigma = x_n / x_n_nrm, y_n / y_n_nrm, m_n
        lbd = np.sqrt(s[j] * sigma)
        w[:, j] = lbd * uu
        h[j] = lbd * vv

    w[w < eps] = 0
    h[h < eps] = 0

    if init == "nndsvda":
        avg = x.mean()
        w[w == 0] = avg
        h[h == 0] = avg
    elif init == "nndsvdar":
        rng = _as_random_state(random_state)
        avg = x.mean()
        n_zw = int((w == 0).sum())
        w[w == 0] = np.abs(avg * rng.standard_normal(size=n_zw) / 100)
        n_zh = int((h == 0).sum())
        h[h == 0] = np.abs(avg * rng.standard_normal(size=n_zh) / 100)
    return w, h
