"""NMF factor initialization (NNDSVD family + random), sklearn-matching.

Port of :mod:`muscle_synergies_tpu.models.init` with
``torch.linalg.svd`` (exact SVD, ``_svd_flip``'s sign convention).
NNDSVD splits each singular triplet into its positive and negative
parts and keeps the dominant one; ``nndsvda`` fills zeros with
``X.mean()``; ``nndsvdar`` with small random values; ``random`` draws
``|N(0, 1)| * sqrt(X.mean() / k)``.  The random draws are the JAX
package's ``jax.random.normal`` draws from ``PRNGKey(seed)``, computed
on the host by :mod:`.._prng` (1e-12 relative in float64) and moved to
``x``'s device; every problem of a batch gets the same draw, as under
the JAX package's ``vmap``.  A ``torch.Generator`` passed as
``generator=`` is used instead.

Every function takes ``(N, L)`` or a batch ``(B, N, L)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _prng
from .rsvd import initialize_nmf_sklearn

__all__ = ["initialize_nmf", "nndsvd"]


def _svd_flip(u: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic SVD sign convention (largest |u| entry positive)."""
    rows = u.abs().argmax(dim=-2, keepdim=True)  # (..., 1, k)
    signs = torch.sign(u.gather(-2, rows))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs, v * signs.transpose(-1, -2)


def _normals(key, shapes, like: torch.Tensor, generator: Optional[torch.Generator]):
    """Standard normal draws of ``shapes`` (each broadcast over ``like``'s
    batch dimensions): jax's from ``key``'s split, or ``generator``'s."""
    lead = like.shape[:-2]
    if generator is not None:
        return [torch.randn(lead + shape, generator=generator, dtype=like.dtype,
                            device=like.device) for shape in shapes]
    dtype = np.float32 if like.dtype == torch.float32 else np.float64
    return [torch.as_tensor(_prng.normal(k, shape, dtype), dtype=like.dtype,
                            device=like.device).expand(lead + shape)
            for k, shape in zip(_prng.split(key), shapes)]


def nndsvd(
    x: torch.Tensor,
    n_components: int,
    variant: str = "nndsvd",
    eps: float = 1e-6,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative Double SVD initialization of ``x ~ W @ H``.

    Args:
        x: ``(N, L)`` or ``(B, N, L)`` non-negative data.
        n_components: rank ``k`` (``k <= min(N, L)``).
        variant: ``"nndsvd"``, ``"nndsvda"`` or ``"nndsvdar"``.
        eps: entries below this are truncated to zero before filling.
        seed, generator: the ``nndsvdar`` fill's random source: the
            JAX package's draws from ``PRNGKey(seed)`` unless a
            ``torch.Generator`` is given.

    Returns:
        ``(W, H)`` with shapes ``(..., N, k)`` and ``(..., k, L)``.
    """
    if variant not in ("nndsvd", "nndsvda", "nndsvdar"):
        raise ValueError(f"unknown nndsvd variant: {variant}")
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    u, vt = _svd_flip(u[..., :n_components], vt[..., :n_components, :])
    s = s[..., :n_components]

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def safe(a, b):
        return a / torch.where(b == 0, torch.ones_like(b), b)

    root = s[..., :1].sqrt()
    cols_w = [root * u[..., :, 0].abs()]
    rows_h = [root * vt[..., 0, :].abs()]
    for j in range(1, n_components):
        xj, yj = u[..., :, j], vt[..., j, :]
        x_p, y_p = xj.clamp(min=0), yj.clamp(min=0)
        x_n, y_n = xj.clamp(max=0).abs(), yj.clamp(max=0).abs()
        x_p_nrm, y_p_nrm = norm(x_p), norm(y_p)
        x_n_nrm, y_n_nrm = norm(x_n), norm(y_n)
        m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
        take_p = m_p > m_n
        uu = torch.where(take_p, safe(x_p, x_p_nrm), safe(x_n, x_n_nrm))
        vv = torch.where(take_p, safe(y_p, y_p_nrm), safe(y_n, y_n_nrm))
        lbd = (s[..., j : j + 1] * torch.where(take_p, m_p, m_n)).sqrt()
        cols_w.append(lbd * uu)
        rows_h.append(lbd * vv)

    w = torch.stack(cols_w, dim=-1)
    h = torch.stack(rows_h, dim=-2)
    w = torch.where(w < eps, torch.zeros_like(w), w)
    h = torch.where(h < eps, torch.zeros_like(h), h)
    if variant == "nndsvd":
        return w, h
    avg = x.mean(dim=(-2, -1), keepdim=True)
    if variant == "nndsvda":
        return torch.where(w == 0, avg, w), torch.where(h == 0, avg, h)
    nw, nh = _normals(_prng.prng_key(seed), (w.shape[-2:], h.shape[-2:]), x,
                      generator)
    rw, rh = (avg * nw / 100).abs(), (avg * nh / 100).abs()
    return torch.where(w == 0, rw, w), torch.where(h == 0, rh, h)


def initialize_nmf(
    x: torch.Tensor,
    n_components: int,
    init: Optional[str] = None,
    eps: float = 1e-6,
    seed: int = 0,
    svd_method: str = "exact",
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial ``(W, H)`` for NMF, following sklearn's dispatch rules.

    ``init=None`` resolves to ``"nndsvda"`` when ``k <= min(N, L)`` and
    ``"random"`` otherwise.  ``svd_method="exact"`` (the default) runs
    ``torch.linalg.svd`` where ``x`` lies; ``"randomized"`` runs the
    host-side sklearn bit-replica (:mod:`.rsvd`, randomized SVD seeded
    by ``np.random.RandomState(seed)``) on each problem and places the
    factors back on ``x``'s device in its dtype, so they equal the JAX
    package's and sklearn's with ``random_state=seed``.
    """
    if svd_method == "randomized":
        host = x.detach().cpu().numpy()
        pairs = [initialize_nmf_sklearn(a, n_components, init=init, eps=eps,
                                        random_state=seed)
                 for a in host.reshape((-1,) + host.shape[-2:])]
        lead = host.shape[:-2]
        w = np.stack([p[0] for p in pairs]).reshape(lead + pairs[0][0].shape)
        h = np.stack([p[1] for p in pairs]).reshape(lead + pairs[0][1].shape)
        return (torch.as_tensor(w, dtype=x.dtype, device=x.device),
                torch.as_tensor(h, dtype=x.dtype, device=x.device))
    if svd_method != "exact":
        raise ValueError(
            f"svd_method must be 'exact' or 'randomized', got {svd_method!r}"
        )
    n, l = x.shape[-2:]
    if init is not None and init != "random" and n_components > min(n, l):
        raise ValueError(
            f"init = '{init}' can only be used when "
            "n_components <= min(n_samples, n_features)"
        )
    if init is None:
        init = "nndsvda" if n_components <= min(n, l) else "random"
    if init == "random":
        avg = (x.mean(dim=(-2, -1), keepdim=True) / n_components).sqrt()
        nh, nw = _normals(_prng.prng_key(seed), ((n_components, l), (n, n_components)),
                          x, generator)
        return (avg * nw).abs(), (avg * nh).abs()
    if init in ("nndsvd", "nndsvda", "nndsvdar"):
        return nndsvd(x, n_components, variant=init, eps=eps, seed=seed,
                      generator=generator)
    raise ValueError(
        f"Invalid init parameter: got {init!r} instead of one of "
        "(None, 'random', 'nndsvd', 'nndsvda', 'nndsvdar')"
    )
