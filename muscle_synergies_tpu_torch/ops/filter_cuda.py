"""Wrappers of the SOS filter kernels (``csrc/sosfiltfilt.cu``).

Two kernels share that source and its chunked cascade (see the source's
header: each pass is a local sweep per time chunk from a zero state, a
composition of the chunks' entry states with ``A^Lc``, and an emit
sweep from those states):

- K3, :func:`sosfiltfilt_cuda`, replaces the TPU kernel
  ``sosfiltfilt_pallas`` (``muscle_synergies_tpu/ops/filter_pallas.py``).
  It reads the ``(B, N, C)`` batch in place, builds the edge extension
  by index against each trial's own length (``lengths``), and writes the
  unpadded result back in the ``(B, N, C)`` layout, zeros past each
  trial's length, so ragged trials filter in one launch.  Its launches
  count in :data:`launches`.
- K6, :func:`sosfilt_cuda`, replaces ``cascade_pallas`` (same file): one
  causal pass from given per-section states, returning the final ones.
  Its launches count in :data:`sosfilt_launches`.

A wrapper call is one launch in those counts, whatever number of CUDA
kernels its phases take.  The chunk length :data:`CHUNK` (``Lc``) was
chosen on the card (``PERF.md``).  Each ``*_cuda`` function launches its
kernel for a CUDA float32 tensor and raises on anything else; ``*_plain``
is its plain version on the same inputs, on any device and dtype (the
sequential recurrence), and :func:`chunked_cascade_plain` mirrors the
kernels' chunk algebra for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import load
from .._common import check_cuda_f32, check_kernel_nans
from .filters import _cascade, _check_length, _normalize_sos, fold_extend, sosfilt_zi

__all__ = [
    "sosfiltfilt_cuda",
    "sosfiltfilt_plain",
    "sosfilt_cuda",
    "sosfilt_plain",
    "chunked_cascade_plain",
    "chunk_power",
    "launches",
    "sosfilt_launches",
    "CHUNK",
    "MAX_SECTIONS",
]

MAX_SECTIONS = 8  # csrc/sosfiltfilt.cu
CHUNK = 1024  # samples per time chunk of both kernels' scans
_PADTYPES = {None: 0, "odd": 1, "even": 2, "constant": 3}  # csrc Padtype
launches = 0  # K3 launches since the last reset
sosfilt_launches = 0  # K6 launches since the last reset


def _lib():
    lib = load("sosfiltfilt")
    fn = lib.sosfiltfilt_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    causal = lib.sosfilt_f32
    causal.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def _transition(sos_np: np.ndarray) -> np.ndarray:
    """The cascade's one-sample state map ``A``, ``(2S, 2S)`` float64.

    The state is ``(s1, s2)`` per section, in section order; section
    ``s``'s input is ``g_s . z + h_s x`` (the previous sections' outputs),
    so ``A`` is block lower-triangular.
    """
    n = sos_np.shape[0]
    a = np.zeros((2 * n, 2 * n))
    g = np.zeros(2 * n)  # section input's dependence on the state
    for s, (b0, b1, b2, _, a1, a2) in enumerate(sos_np):
        a[2 * s] = (b1 - a1 * b0) * g
        a[2 * s, 2 * s] -= a1
        a[2 * s, 2 * s + 1] += 1.0
        a[2 * s + 1] = (b2 - a2 * b0) * g
        a[2 * s + 1, 2 * s] -= a2
        g = b0 * g
        g[2 * s] += 1.0
    return a


def chunk_power(sos: np.ndarray, chunk: int) -> np.ndarray:
    """``A^chunk``: the state map of a whole chunk, ``(2S, 2S)`` float64.

    Raised in the host's extended precision and rounded once: for a low
    cutoff the power's entries reach 1e5 and float64 squarings lose up to
    six digits of them (2.6e-10 relative at 4 Hz, 2 kHz, order 4, chunks
    of 1,024).
    """
    a = _transition(_normalize_sos(sos)).astype(np.longdouble)
    return np.linalg.matrix_power(a, chunk).astype(np.float64)


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


def _host_lengths(lengths, b: int, n: int, padlen: int) -> np.ndarray:
    """Each trial's length on the host, checked to lie in ``(padlen, n]``."""
    if lengths is None:
        lens = np.full(b, n, dtype=np.int64)
    else:
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.detach().cpu()
        lens = np.asarray(lengths).astype(np.int64)
        if lens.shape != (b,):
            raise ValueError(f"lengths must have shape ({b},), got {lens.shape}")
        if (lens > n).any():
            raise ValueError(f"a length exceeds the batch's {n} samples: {lens.max()}")
    _check_length(int(lens.min()), padlen)  # every trial longer than padlen
    return lens


@functools.lru_cache(maxsize=64)
def _tables(sos_bytes: bytes, chunk: int, device: torch.device):
    """The coefficient table and ``A^chunk`` of one cascade on the card.

    Cached, so that a call copies nothing from the host: a copy from
    pageable memory waits for the stream's earlier kernels.
    """
    sos_np = np.frombuffer(sos_bytes).reshape(-1, 6)
    power = torch.as_tensor(chunk_power(sos_np, chunk), dtype=torch.float64,
                            device=device)
    return _coefficients(sos_np, device), power


def _launch_args(sos_np: np.ndarray, n_steps: int, columns: int, device):
    """Coefficients, ``A^CHUNK``, a workspace and the chunk count."""
    coef, power = _tables(np.ascontiguousarray(sos_np).tobytes(), CHUNK, device)
    n_chunks = -(-n_steps // CHUNK)
    ws = torch.empty((n_chunks, 2 * sos_np.shape[0], columns), dtype=torch.float64,
                     device=device)
    return coef, power, ws, n_chunks


def sosfiltfilt_cuda(
    sos: np.ndarray, x: torch.Tensor, padlen: int, padtype: Optional[str],
    lengths=None,
) -> torch.Tensor:
    """Zero-phase filter a ``(B, N, C)`` CUDA float32 batch along axis 1.

    ``padlen`` is already resolved (see ``filters._resolve_padding``);
    ``padtype=None`` extends nothing.  ``lengths`` (``(B,)`` integers,
    ``None`` for ``N`` each) filters each trial over its own first
    ``lengths[b]`` samples, extended against its own first and last
    sample, and zeroes the rest of its row.

    Raises:
        ValueError: before any launch, for a trial no longer than
            ``padlen`` (scipy's message) or longer than ``N``.
    """
    global launches
    sos_np = _checked_sos(sos, x, "sosfiltfilt_cuda")
    b, n, c = x.shape
    if padtype is None:
        padlen = 0
    n_ext = n + 2 * padlen
    if b * c >= 2**31 or n_ext >= 2**31:
        raise ValueError(f"signal too large for the kernel: {tuple(x.shape)}")
    checked = _host_lengths(lengths, b, n, padlen)
    if lengths is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=x.device)
    elif isinstance(lengths, torch.Tensor) and lengths.device == x.device:
        lens = lengths.to(torch.int32).contiguous()
    else:
        lens = torch.as_tensor(checked, dtype=torch.int32, device=x.device)
    x = x.contiguous()
    out = torch.empty_like(x)
    fwd = torch.empty((b, n_ext, c), dtype=torch.float32, device=x.device)
    coef, power, ws, n_chunks = _launch_args(sos_np, n_ext, b * c, x.device)
    fn, _ = _lib()
    err = fn(
        x.data_ptr(), out.data_ptr(), fwd.data_ptr(), ws.data_ptr(),
        lens.data_ptr(), coef.data_ptr(), power.data_ptr(), sos_np.shape[0],
        b, n, c, padlen, _PADTYPES[padtype], CHUNK, n_chunks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sosfiltfilt kernel launch failed: CUDA error {err}")
    launches += 1
    check_kernel_nans("sosfiltfilt", out)
    return out


def sosfiltfilt_plain(
    sos: np.ndarray, x: torch.Tensor, padlen: int, padtype: Optional[str],
    lengths=None,
) -> torch.Tensor:
    """K3's plain version: same ``(B, N, C)`` input, any device and dtype.

    Extends and folds the trials (:func:`~.filters.fold_extend`), seeds
    the forward pass with ``zi_unit * ext[0]``, runs it, seeds the
    backward pass with ``zi_unit * forward[-1]``, runs it over the
    reversed forward output, and keeps the ``N`` samples after the
    extension's head.  With ``lengths`` each trial is filtered alone over
    its own length (trials of one length together) and the rest of its
    row is zero.
    """
    b, n, c = x.shape
    if padtype is None:
        padlen = 0
    if lengths is None:
        return _filtfilt_plain(sos, x, padlen, padtype)
    lens = _host_lengths(lengths, b, n, padlen)
    out = torch.zeros_like(x)
    for length in np.unique(lens):
        idx = torch.as_tensor(np.flatnonzero(lens == length), device=x.device)
        out[idx, :length] = _filtfilt_plain(sos, x[idx, :length], padlen, padtype)
    return out


def _filtfilt_plain(sos, x, padlen, padtype):
    """:func:`sosfiltfilt_plain` of a batch of equal-length trials."""
    b, n, c = x.shape
    sos_np = _normalize_sos(sos)
    ext = fold_extend(x, padlen, padtype)
    zi_unit = torch.as_tensor(sosfilt_zi(sos_np), dtype=ext.dtype,
                              device=ext.device)[:, :, None]
    fwd, _ = _cascade(sos_np, ext, zi_unit * ext[0])
    rev = fwd.flip(0)
    y, _ = _cascade(sos_np, rev, zi_unit * rev[0])
    y = y.flip(0)
    return y[padlen : padlen + n].reshape(n, b, c).transpose(0, 1).contiguous()


def chunked_cascade_plain(
    sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor, chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' chunked scan of :func:`~.filters._cascade`, in torch.

    Same arguments and results as ``_cascade`` (``x`` ``(N, C)``, ``zi``
    ``(S, 2, C)``), computed as the CUDA kernels compute one pass: every
    chunk of ``chunk`` samples but the last runs from a zero state to its
    final state ``r_j`` (all chunks at once); the entry states follow from
    ``entry_j = A^chunk entry_{j-1} + r_{j-1}`` with ``entry_0 = zi``; then
    every chunk reruns from its entry state.  The final states are those
    at the end of the last (possibly short) chunk.  Used by the tests.
    """
    sos_np = _normalize_sos(sos)
    n, c = x.shape
    s = sos_np.shape[0]
    full = (n - 1) // chunk  # chunks before the last one
    # phase 1: every full chunk from a zero state, all at once
    body = x[: full * chunk].reshape(full, chunk, c).transpose(0, 1)
    body = body.reshape(chunk, full * c)
    r = torch.zeros((s, 2, full * c), dtype=x.dtype, device=x.device)
    if full:
        _, r = _cascade(sos_np, body, r)
    r = r.reshape(2 * s, full, c)
    # phase 2: the entry states, one chunk after another
    power = torch.as_tensor(chunk_power(sos_np, chunk), dtype=x.dtype, device=x.device)
    entries = [zi.reshape(2 * s, c)]
    for j in range(full):
        entries.append(power @ entries[-1] + r[:, j])
    # phase 3: every chunk again from its entry state
    y_body = body
    if full:
        start = torch.stack(entries[:full], dim=1).reshape(s, 2, full * c)
        y_body, _ = _cascade(sos_np, body, start)
    y_last, zf = _cascade(sos_np, x[full * chunk :], entries[full].reshape(s, 2, c))
    y_body = y_body.reshape(chunk, full, c).transpose(0, 1).reshape(full * chunk, c)
    return torch.cat([y_body, y_last]), zf


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
    coef, power, ws, n_chunks = _launch_args(sos_np, n, b * c, x.device)
    _, fn = _lib()
    err = fn(
        x.data_ptr(), y.data_ptr(), ws.data_ptr(), coef.data_ptr(),
        power.data_ptr(), zi_cols.data_ptr(), zf.data_ptr(), n_sections, n,
        b * c, c, CHUNK, n_chunks, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sosfilt kernel launch failed: CUDA error {err}")
    sosfilt_launches += 1
    check_kernel_nans("sosfilt", y, zf)
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
