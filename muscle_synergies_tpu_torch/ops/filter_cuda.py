"""Wrappers of the SOS filter kernels (``csrc/sosfiltfilt.cu``).

Two kernels share that source and its cascade:

- K3, :func:`sosfiltfilt_cuda`, replaces the TPU kernel
  ``sosfiltfilt_pallas`` (``muscle_synergies_tpu/ops/filter_pallas.py``).
  The edge extension stays plain torch around the kernel, as it stayed
  XLA around the Pallas call; the extension writes the trials folded
  time-major, ``(N_ext, B*C)``, so that a warp of the kernel reads 32
  neighbouring columns at each time step.  The kernel seeds both passes
  itself and writes the unpadded result straight back in the
  ``(B, N, C)`` layout.  Its launches count in :data:`launches`.
- K6, :func:`sosfilt_cuda`, replaces ``cascade_pallas`` (same file): one
  causal pass from given per-section states, returning the final ones.
  With no extension it reads and writes the ``(B, N, C)`` layout in
  place.  Its launches count in :data:`sosfilt_launches`.

Each ``*_cuda`` function launches its kernel for a CUDA float32 tensor
and raises on anything else; ``*_plain`` is its plain version on the
same inputs, on any device and dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import load
from .._common import check_cuda_f32
from .filters import _cascade, _normalize_sos, fold_extend, sosfilt_zi

__all__ = [
    "sosfiltfilt_cuda",
    "sosfiltfilt_plain",
    "sosfilt_cuda",
    "sosfilt_plain",
    "launches",
    "sosfilt_launches",
    "MAX_SECTIONS",
]

MAX_SECTIONS = 8  # csrc/sosfiltfilt.cu
launches = 0  # K3 launches since the last reset
sosfilt_launches = 0  # K6 launches since the last reset


def _lib():
    lib = load("sosfiltfilt")
    fn = lib.sosfiltfilt_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    causal = lib.sosfilt_f32
    causal.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    causal.restype = ctypes.c_int
    return fn, causal


def _coefficients(sos_np: np.ndarray, device) -> torch.Tensor:
    """``(S, 7)`` float64: b0, b1 - a1 b0, b2 - a2 b0, a1, a2, zi_unit."""
    b0, b1, b2, _, a1, a2 = sos_np.T
    zi = sosfilt_zi(sos_np)
    table = np.stack(
        [b0, b1 - a1 * b0, b2 - a2 * b0, a1, a2, zi[:, 0], zi[:, 1]], axis=1
    )
    return torch.as_tensor(table, dtype=torch.float64, device=device)


def _checked_sos(sos: np.ndarray, x: torch.Tensor, name: str) -> np.ndarray:
    """Device, dtype, layout and section-count checks shared by K3 and K6."""
    check_cuda_f32(name, x)
    if x.ndim != 3:
        raise ValueError(f"expected (B, N, C), got shape {tuple(x.shape)}")
    sos_np = _normalize_sos(sos)
    if sos_np.shape[0] > MAX_SECTIONS:
        raise ValueError(
            f"the kernel takes at most {MAX_SECTIONS} sections, got {sos_np.shape[0]}"
        )
    return sos_np


def sosfiltfilt_cuda(
    sos: np.ndarray, x: torch.Tensor, padlen: int, padtype: Optional[str]
) -> torch.Tensor:
    """Zero-phase filter a ``(B, N, C)`` CUDA float32 batch along axis 1.

    ``padlen`` is already resolved (see ``filters._resolve_padding``);
    ``padtype=None`` extends nothing.
    """
    global launches
    sos_np = _checked_sos(sos, x, "sosfiltfilt_cuda")
    b, n, c = x.shape
    if b * c >= 2**31 or n + 2 * padlen >= 2**31:
        raise ValueError(f"signal too large for the kernel: {tuple(x.shape)}")
    ext = fold_extend(x, padlen, padtype)  # overwritten by the kernel
    out = torch.empty((b, n, c), dtype=torch.float32, device=x.device)
    coef = _coefficients(sos_np, x.device)
    fn, _ = _lib()
    err = fn(
        ext.data_ptr(), out.data_ptr(), coef.data_ptr(), sos_np.shape[0],
        ext.shape[0], n, (ext.shape[0] - n) // 2, b * c, c,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sosfiltfilt kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def sosfiltfilt_plain(
    sos: np.ndarray, x: torch.Tensor, padlen: int, padtype: Optional[str]
) -> torch.Tensor:
    """K3's plain version: same ``(B, N, C)`` input, any device and dtype.

    Extends and folds the trials as the kernel does, seeds the forward
    pass with ``zi_unit * ext[0]``, runs it, seeds the backward pass
    with ``zi_unit * forward[-1]``, runs it over the reversed forward
    output, and keeps the ``N`` samples after the extension's head.
    """
    b, n, c = x.shape
    sos_np = _normalize_sos(sos)
    ext = fold_extend(x, padlen, padtype)
    zi_unit = torch.as_tensor(sosfilt_zi(sos_np), dtype=ext.dtype,
                              device=ext.device)[:, :, None]
    fwd, _ = _cascade(sos_np, ext, zi_unit * ext[0])
    rev = fwd.flip(0)
    y, _ = _cascade(sos_np, rev, zi_unit * rev[0])
    y = y.flip(0)
    pad = (ext.shape[0] - n) // 2
    return y[pad : pad + n].reshape(n, b, c).transpose(0, 1).contiguous()


def _columns(zi: torch.Tensor) -> torch.Tensor:
    """Per-trial states ``(B, S, 2, C)`` as the kernel's ``(S, 2, B*C)``."""
    b, s, _, c = zi.shape
    return zi.permute(1, 2, 0, 3).reshape(s, 2, b * c)


def _trials(zf: torch.Tensor, b: int) -> torch.Tensor:
    """The kernel's ``(S, 2, B*C)`` states as per-trial ``(B, S, 2, C)``."""
    s = zf.shape[0]
    return zf.reshape(s, 2, b, -1).permute(2, 0, 1, 3)


def sosfilt_cuda(
    sos: np.ndarray, x: torch.Tensor, zi: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal pass over a ``(B, N, C)`` CUDA float32 batch along axis 1 (K6).

    Args:
        zi: per-trial initial states ``(B, S, 2, C)``, any float dtype
            (the kernel keeps its state in float64), or ``None`` for
            zeros.

    Returns:
        ``(y, zf)``: the filtered ``(B, N, C)`` float32 batch and the
        final states ``(B, S, 2, C)`` in float32.
    """
    global sosfilt_launches
    sos_np = _checked_sos(sos, x, "sosfilt_cuda")
    b, n, c = x.shape
    n_sections = sos_np.shape[0]
    if b * c >= 2**31 or n >= 2**31 or b * n * c == 0:
        raise ValueError(f"the kernel cannot run a signal of shape {tuple(x.shape)}")
    if zi is None:
        zi_cols = torch.zeros((n_sections, 2, b * c), dtype=torch.float64,
                              device=x.device)
    else:
        if zi.shape != (b, n_sections, 2, c):
            raise ValueError(
                f"zi must have shape {(b, n_sections, 2, c)}, got {tuple(zi.shape)}"
            )
        if zi.device != x.device:
            raise ValueError(f"zi on {zi.device}, x on {x.device}")
        zi_cols = _columns(zi).to(torch.float64).contiguous()
    x = x.contiguous()
    y = torch.empty_like(x)
    zf = torch.empty_like(zi_cols)
    coef = _coefficients(sos_np, x.device)
    _, fn = _lib()
    err = fn(
        x.data_ptr(), y.data_ptr(), coef.data_ptr(), zi_cols.data_ptr(),
        zf.data_ptr(), n_sections, n, b * c, c,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sosfilt kernel launch failed: CUDA error {err}")
    sosfilt_launches += 1
    return y, _trials(zf, b).to(torch.float32)


def sosfilt_plain(
    sos: np.ndarray, x: torch.Tensor, zi: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: same ``(B, N, C)`` input, any device and dtype.

    Folds the trials time-major onto ``B*C`` columns and runs
    :func:`~.filters._cascade` from ``zi`` (zeros for ``None``); the
    states stay in ``x``'s dtype.
    """
    b, n, c = x.shape
    sos_np = _normalize_sos(sos)
    if zi is None:
        zi_cols = x.new_zeros((sos_np.shape[0], 2, b * c))
    else:
        zi_cols = _columns(zi.to(x.dtype))
    y, zf = _cascade(sos_np, x.transpose(0, 1).reshape(n, b * c), zi_cols)
    return y.reshape(n, b, c).transpose(0, 1).contiguous(), _trials(zf, b)
