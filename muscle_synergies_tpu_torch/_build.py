"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with :mod:`ctypes`.  Libraries land in
``build/torch_kernels/`` beside the package, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
is reused.  A failed build raises; nothing falls back to the plain
PyTorch versions.

Usage::

    from muscle_synergies_tpu_torch import _build
    reports = _build.build_all()          # compile every kernel now
    lib = _build.load("mu_nmf")           # ctypes.CDLL, built on demand
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("sosfiltfilt", "cd_nmf", "mu_nmf", "beta_nmf", "cnmf")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME`` (default ``/usr/local/cuda``) or ``$PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if home.is_file():
        return str(home)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, by default "
            "/usr/local/cuda/bin, and on $PATH); the CUDA kernels cannot be built"
        )
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
    os.replace(tmp, out)
    (out.with_suffix(".log")).write_text(log)
    return log


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns each newly built kernel's ``nvcc -Xptxas -v`` report
    (registers, shared memory, spills); kernels already built are
    skipped and absent from the result.
    """
    with _lock:
        todo = {n: _library_path(n) for n in names}
        todo = {n: p for n, p in todo.items() if not p.is_file()}
        procs = {n: _start_build(n, p) for n, p in todo.items()}
        return {n: _finish_build(n, todo[n], proc) for n, proc in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]
