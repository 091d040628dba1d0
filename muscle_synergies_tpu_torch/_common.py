"""Shared helpers: tensor placement, implementation choice, precision.

Every public entry point of the package takes ``device=`` and
``dtype=``; :func:`as_tensor` is the one place that applies them, and
:func:`entry_placement` resolves the dataset entry points' defaults
(the card, float32).

Precision: the batched solvers' plain versions, VAF and the NNDSVD
initialization run float32 matrix products.  On an NVIDIA card those
may use TF32 (about three decimal digits), which would perturb the
stopping statistics the way the TPU's bf16 matrix unit did for the JAX
package.  The package therefore turns TF32 off for both the matmul and
the cuDNN paths when it is imported; the hand-written kernels never
touch tensor cores at all.  A function that takes the JAX package's
``precision=`` runs its products under :func:`matmul_precision`, which
allows TF32 for those products only.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMPLS = ("auto", "torch", "cuda")

# Turned on by :func:`~muscle_synergies_tpu_torch.utils.profiling.debug_nans`:
# the kernels are launched through ctypes, past PyTorch's dispatcher, so
# each kernel wrapper checks its own outputs (:func:`check_kernel_nans`).
DEBUG_NANS = False

# the names jax.lax.Precision and its string forms take, by what they
# give a float32 product here: full float32, or TF32 allowed
_FULL_PRECISION = ("default", "highest", "float32")
_TF32_PRECISION = ("high", "tensorfloat32", "bfloat16")


def as_tensor(x, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` in ``dtype``.

    ``None`` keeps what the input already has: a tensor keeps its
    device and dtype, a NumPy array its float dtype (integers become
    float64), anything else becomes float64 on the CPU.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype if dtype is not None else x.dtype)
    arr = np.ascontiguousarray(x)  # torch takes no negative strides
    if dtype is None:
        dtype = torch.float32 if arr.dtype == np.float32 else torch.float64
    return torch.as_tensor(arr, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def entry_placement(device, dtype: Optional[torch.dtype]):
    """Where and in what type a dataset entry point computes.

    The entry points default to ``device="cuda"``: on the card,
    ``dtype=None`` means float32 (the JAX package's default without
    x64), so NumPy trials reach the kernels.  Asking for the card on a
    machine without one raises instead of running on the CPU; pass
    ``device="cpu"`` for the plain versions, where ``dtype=None`` keeps
    :func:`as_tensor`'s rule.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the entry points run on the card by "
                "default; pass device='cpu' to run the plain versions "
                "on the CPU"
            )
        if dtype is None:
            dtype = torch.float32
    return device, dtype


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``"auto"`` -> ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU one.

    The hand kernels are float32 only, so ``"auto"`` on a CUDA tensor of
    another dtype raises rather than quietly taking the plain version;
    pass ``impl="torch"`` to run the plain version on the card.  An
    explicit ``"cuda"`` is passed through and the kernel wrapper raises
    on what it cannot run.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    if not x.is_cuda:
        return "torch"
    if x.dtype != torch.float32:
        raise TypeError(
            f"impl='auto' on a CUDA {x.dtype} tensor: the CUDA kernels take "
            "float32 only; pass dtype=torch.float32, or impl='torch' for the "
            "plain version"
        )
    return "cuda"


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA float32 tensor on one card."""
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: needs CUDA tensors, got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: takes float32 only, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")


def check_kernel_nans(name: str, *outputs: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` if a kernel's floating-point output
    holds a NaN, while :data:`DEBUG_NANS` is on; one flag read otherwise."""
    if not DEBUG_NANS:
        return
    for out in outputs:
        if out.is_floating_point() and bool(torch.isnan(out).any()):
            raise FloatingPointError(f"{name}: the kernel's output holds a NaN")


def eager_loop(cond, body, carried):
    """``torch._higher_order_ops.while_loop``'s semantics, run eagerly:
    ``body(*carried)`` while ``cond(*carried)``, one host readback of
    the condition a body call.

    The transform cores take their loop as an argument: this one when
    they run, ``while_loop`` when ``torch.export`` traces them (whose
    own eager form would trace every call through dynamo).
    """
    carried = tuple(carried)
    while bool(cond(*carried)):
        carried = tuple(body(*carried))
    return carried


def repeat(n: int, step, carried, loop=eager_loop):
    """``step(*carried)`` applied ``n`` times: a Python loop under
    :func:`eager_loop`, a counted ``loop`` otherwise, so a traced
    program holds one step, not ``n``, and traces that much faster."""
    carried = tuple(carried)
    if loop is eager_loop:
        for _ in range(n):
            carried = tuple(step(*carried))
        return carried
    count = torch.zeros((), dtype=torch.int64, device=carried[0].device)
    out = loop(lambda j, *c: j < n, lambda j, *c: (j + 1, *step(*c)), (count, *carried))
    return tuple(out[1:])


def allows_tf32(precision) -> bool:
    """Whether a JAX-style matmul ``precision`` allows TF32 on the card.

    Takes ``None``, the names JAX takes in any case (``"default"``,
    ``"high"``, ``"highest"``, ``"bfloat16"``, ``"tensorfloat32"``,
    ``"float32"``), or an object whose ``.name`` is one of them (a
    ``jax.lax.Precision``).  ``None``, ``"default"``, ``"highest"`` and
    ``"float32"`` mean full float32, the package's default;
    ``"high"``, ``"tensorfloat32"`` and ``"bfloat16"`` allow TF32.

    Raises:
        ValueError: for anything else.
    """
    if precision is None:
        return False
    name = getattr(precision, "name", precision)
    key = name.lower() if isinstance(name, str) else None
    if key in _FULL_PRECISION:
        return False
    if key in _TF32_PRECISION:
        return True
    raise ValueError(
        f"precision must be None, one of {_FULL_PRECISION + _TF32_PRECISION} "
        f"(any case), or a jax.lax.Precision; got {precision!r}"
    )


@contextlib.contextmanager
def matmul_precision(precision) -> Iterator[None]:
    """Run the CUDA float32 matrix products inside at ``precision``.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` to
    :func:`allows_tf32`'s answer for the block and restores the caller's
    setting on the way out.  CPU products and other dtypes are unaffected.
    """
    tf32 = allows_tf32(precision)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
