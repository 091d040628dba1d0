"""Serve fitted models without the framework: ``torch.export``.

Port of :mod:`muscle_synergies_tpu.models.export`.  Fit a synergy model
once, then run ``transform`` on new trials from a process that has
neither this package nor the training code, only torch:
:func:`export_transform` captures a fitted model's transform (the whole
solver loop, its stopping rule and its default start included) as one
``torch.export`` program per platform, for one input signature, and
:func:`load_transform` turns the artifact back into ``fn(x) ->
np.ndarray``.

What is captured is the model's ``_transform_torch`` (the counterpart
of the JAX package's ``_transform_jax``) with
``torch._higher_order_ops.while_loop`` as its loop: each loop body is
one 10-iteration chunk (itself a counted ``while_loop``, so the
program holds one iteration) in which an iteration is applied only to
the trials still going (``torch.where``), so the program stops each
trial where the eager ``transform`` does.  The fitted factors are the
program's buffers; the default starts of the convolutive and
space-by-time transforms are drawn inside it (the JAX package's
Threefry draws in integer operations), so a symbolic batch size needs
nothing from the host.

The artifact is a zip archive: ``meta.json`` (format tag, model class,
signature, dtype, platforms) and one ``<platform>.pt2`` per platform,
each what ``torch.export.save`` writes.  This module imports nothing of
the package, so a serving process can load it from its file alone;
:func:`load_transform` needs torch and NumPy.

Differences from the JAX package: the platforms are ``"cpu"`` and
``"cuda"``, and a platform that cannot be traced here (``"cuda"``
without a card) raises rather than being dropped.  A program runs its
products at the full float32 precision of a process's default
(``torch.backends.cuda.matmul.allow_tf32`` off), whatever a model's
``precision`` says.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["export_transform", "load_transform"]

FORMAT = "muscle_synergies_tpu_torch.transform/1"
_MODELS = ("NMFModel", "CNMFModel", "NM3FModel")
_PLATFORMS = ("cpu", "cuda")


class _Transform(torch.nn.Module):
    """A fitted model's transform as a module: the factors as buffers,
    ``forward(x)`` the traceable core with ``while_loop``."""

    def __init__(self, model, factors):
        super().__init__()
        self.model = model
        self.n_factors = len(factors)
        for i, factor in enumerate(factors):
            self.register_buffer(f"factor{i}", factor)

    def forward(self, x):
        from torch._higher_order_ops import while_loop

        # each factor read once, outside the loop: a buffer that the
        # loop's closures read twice makes the tracer refuse aliasing
        factors = [getattr(self, f"factor{i}").clone() for i in range(self.n_factors)]
        return self.model._transform_torch(x, *factors, loop=while_loop)[0]


def _signature(shape):
    """``(example shape, dynamic_shapes entry)``: a string or ``None``
    dimension becomes a ``torch.export.Dim`` (one per name), traced at
    an example size of 2 or more (sizes 0 and 1 would be specialised)."""
    dims, example, spec = {}, [], {}
    for axis, d in enumerate(shape):
        if isinstance(d, int):
            example.append(d)
            continue
        if d is not None and not isinstance(d, str):
            raise TypeError(f"a dimension is an int, a name or None, got {d!r}")
        name = d if d is not None else f"dim{axis}"
        if name not in dims:
            dims[name] = torch.export.Dim(name, min=1)
        spec[axis] = dims[name]
        example.append(2 + list(dims).index(name))
    return tuple(example), spec


def _serialisable(program):
    """``program`` with every node's module-stack metadata as strings:
    the nodes of a nested ``while_loop``'s subgraphs carry a module's
    class where ``torch.export.save`` expects its qualified name."""
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            stack = node.meta.get("nn_module_stack")
            if stack:
                node.meta["nn_module_stack"] = {
                    key: (path, ty if isinstance(ty, str)
                          else f"{ty.__module__}.{ty.__qualname__}")
                    for key, (path, ty) in stack.items()}
    return program


def _platform_device(platform: str) -> torch.device:
    if platform not in _PLATFORMS:
        raise ValueError(f"platforms are {_PLATFORMS}, got {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' asked for, but there is no CUDA device "
                           "to trace it on; pass platforms=('cpu',)")
    return torch.device(platform)


def export_transform(
    model,
    shape: Sequence[Union[int, str, None]],
    *,
    dtype: torch.dtype = torch.float32,
    platforms: Optional[Tuple[str, ...]] = _PLATFORMS,
    path=None,
) -> bytes:
    """Capture a fitted estimator's ``transform`` as ``torch.export``
    programs.

    Args:
        model: a fitted ``NMFModel`` / ``CNMFModel`` / ``NM3FModel``.
        shape: the input signature: ``(T, L)`` for one trial, ``(B, T,
            L)`` for a stack (an ``NMFModel`` then transforms every trial,
            each stopping on its own).  A string or ``None`` entry is a
            symbolic dimension, e.g. ``("b", 200, 8)`` serves any batch
            size.
        dtype: the input dtype the programs take (float32 by default,
            the card's; float64 replays the CPU's float64 results).
        platforms: ``"cpu"`` and / or ``"cuda"``, one program each (by
            default both); ``"cuda"`` needs a card.
        path: also write the artifact here, atomically.

    Each program is traced after ``torch.compiler.reset()``, which also
    drops the process's other ``torch.compile`` caches.

    Returns:
        the artifact's bytes (module docstring).
    """
    name = type(model).__name__
    if name not in _MODELS:
        raise TypeError(f"cannot export {name}; expected NMFModel, CNMFModel or NM3FModel")
    factors = model._transform_factors()  # raises for an unfitted model
    example, spec = _signature(shape)
    platforms = tuple(platforms or _PLATFORMS)
    members = {}
    for platform in platforms:
        device = _platform_device(platform)
        module = _Transform(model, [torch.as_tensor(np.asarray(f), dtype=dtype,
                                                    device=device) for f in factors])
        x = 0.1 + torch.rand(example, generator=torch.Generator().manual_seed(0),
                             dtype=dtype).to(device)
        # while_loop traces its bodies through dynamo, whose caches keep
        # the shapes of an earlier export of the same code: a second export
        # with a symbolic batch would see the first one's batch as fixed
        torch.compiler.reset()
        program = torch.export.export(module, (x,), dynamic_shapes=(spec,),
                                      strict=False)
        buf = io.BytesIO()
        torch.export.save(_serialisable(program), buf)
        members[f"{platform}.pt2"] = buf.getvalue()
    meta = {"format": FORMAT, "class": name,
            "shape": [d if isinstance(d, (int, str)) else None for d in shape],
            "dtype": str(dtype).replace("torch.", ""), "platforms": list(platforms)}
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        for member, data in members.items():
            zf.writestr(member, data)
    blob = out.getvalue()
    if path is not None:
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, path)  # atomic publish
    return blob


def load_transform(source):
    """Rehydrate :func:`export_transform`'s bytes (or a file written by
    it) into ``fn(x) -> np.ndarray``.

    ``fn`` runs the program of ``x``'s device for a tensor; for an array
    it runs the CUDA program when the artifact has one and a card is
    there, else the CPU program.  ``fn.exported`` maps each platform to
    its ``torch.export.ExportedProgram``; ``fn.meta`` is the artifact's
    signature.  Only torch and NumPy are needed: none of this package's
    code runs.
    """
    blob = Path(source).read_bytes() if isinstance(source, (str, os.PathLike)) \
        else bytes(source)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"format {meta.get('format')!r}, expected {FORMAT!r}")
        exported = {p: torch.export.load(io.BytesIO(zf.read(f"{p}.pt2")))
                    for p in meta["platforms"]}
    modules = {p: program.module() for p, program in exported.items()}
    dtype = getattr(torch, meta["dtype"])

    def fn(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            platform = x.device.type
        elif "cuda" in modules and torch.cuda.is_available():
            platform = "cuda"
        else:
            platform = "cpu"
        if platform not in modules:
            raise ValueError(f"the artifact holds programs for {sorted(modules)}, "
                             f"not {platform!r}")
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            dtype=dtype, device=platform)
        with torch.no_grad():
            return modules[platform](x).cpu().numpy()

    fn.exported = exported
    fn.meta = meta
    return fn
