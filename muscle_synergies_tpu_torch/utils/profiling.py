"""Tracing, timing and solver telemetry.

Port of :mod:`muscle_synergies_tpu.utils.profiling`:

- :class:`Timer`: a wall-clock scope;
- :func:`annotate`: a named scope in ``torch.profiler`` traces
  (``record_function``) and, once CUDA is initialised, in Nsight's
  (an NVTX range);
- :func:`solver_report`: iterations, convergence and errors of an
  ``MUState`` or ``CDState``, one fit or a batch, as NumPy arrays;
- :func:`debug_nans`: the counterpart of ``jax_debug_nans``, a scope
  that raises ``FloatingPointError`` at the first floating-point result
  holding a NaN.  PyTorch operations are checked by a
  ``TorchDispatchMode``; the hand-written kernels are launched through
  ``ctypes``, past the dispatcher, so their wrappers check their own
  outputs while the scope is on (:func:`.._common.check_kernel_nans`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import _common

__all__ = ["Timer", "annotate", "solver_report", "debug_nans"]


class Timer:
    """Wall-clock scope timer usable as a context manager.

    Example:
        >>> with Timer("fit") as t:
        ...     _ = sum(range(10))
        >>> t.elapsed >= 0
        True
    """

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self.verbose:
            print(f"[{self.name}] {self.elapsed * 1e3:.2f} ms")
        return False


@contextlib.contextmanager
def annotate(name: str):
    """Named scope that appears in ``torch.profiler`` traces, and as an
    NVTX range in Nsight's once CUDA is initialised."""
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            scopes.enter_context(torch.cuda.nvtx.range(name))
        yield


def solver_report(state, x=None) -> Dict:
    """Structured telemetry from a (possibly batched) solver state.

    Works with :class:`~muscle_synergies_tpu_torch.models.mu.MUState`
    and :class:`~muscle_synergies_tpu_torch.models.hals.CDState` (the
    kernels' states included).

    Returns:
        dict with ``n_iter`` (per fit), ``converged`` and its
        ``converged_fraction``, the MU state's ``error_at_last_check``,
        and when ``x`` is given the exact final Frobenius error per fit.
    """
    converged = _common.to_numpy(state.converged)
    report: Dict = {
        "n_iter": _common.to_numpy(state.n_iter),
        "converged": converged,
        "converged_fraction": float(np.mean(converged)),
    }
    if hasattr(state, "previous_error"):
        report["error_at_last_check"] = _common.to_numpy(state.previous_error)
    if x is not None:
        w = state.w
        h = state.h if hasattr(state, "h") else state.ht.transpose(-1, -2)
        diff = _common.as_tensor(x, w.device, w.dtype) - w @ h
        report["final_error"] = _common.to_numpy((diff * diff).sum(dim=(-2, -1)).sqrt())
    return report


# operations whose outputs are uninitialised memory, not results
_ALLOCATIONS = ("empty", "new_empty", "resize")


class _NaNCheck(TorchDispatchMode):
    """Raise at the first floating-point operation result holding a NaN,
    while :data:`.._common.DEBUG_NANS` is on (an inner
    ``debug_nans(False)`` turns it off)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if _common.DEBUG_NANS and not name.startswith(_ALLOCATIONS):
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scope with NaN checking toggled (restores the prior state).

    On, every PyTorch operation and every kernel launch that gives a
    floating-point result holding a NaN raises ``FloatingPointError``;
    each check reads the result back to the host, so the scope is for
    debugging, not for measurements.
    """
    previous = _common.DEBUG_NANS
    _common.DEBUG_NANS = enable
    try:
        with _NaNCheck() if enable else contextlib.nullcontext():
            yield
    finally:
        _common.DEBUG_NANS = previous
