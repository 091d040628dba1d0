"""Native (C++) runtime components, bound through ctypes.

Currently: the Vicon CSV numeric-block decoder (``vicon_decode.cpp``,
the JAX package's source unchanged).  It builds at first use with
``g++ -O3`` into ``build/native/`` beside the package (never inside
it), named by a hash of the source and the flags, so a changed source
rebuilds; the build runs under the CUDA kernels' build lock.  A failed
build raises with the compiler's output: nothing falls back.

:func:`decode_block_plain` is the same decoder in numpy and Python,
with the same cell rules and the same error message.  The ingest uses
it only when ``MST_DISABLE_NATIVE=1`` asks for it; the tests hold the
native decoder against it.

Usage::

    from muscle_synergies_tpu_torch import native
    arr = native.decode_block(b"1,2\\n3,\\n", 2)   # [[1, 2], [3, nan]]
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import _build

SOURCE = Path(__file__).resolve().parent / "vicon_decode.cpp"
BUILD_DIR = _build.BUILD_DIR.parent / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the decoder library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvicon_decode-{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError(
            "g++ not found on $PATH: the native Vicon decoder cannot be "
            "built (MST_DISABLE_NATIVE=1 selects the plain decoder)"
        ) from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build the native Vicon decoder:\n{proc.stderr}"
        )
    os.replace(tmp, out)


def load_decoder() -> ctypes.CDLL:
    """The loaded decoder library, building it first if needed.

    Raises:
        RuntimeError: with the compiler's output, if the build fails.
    """
    global _lib
    if _lib is not None:
        return _lib
    with _build._lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            lib.msk_count_rows.restype = ctypes.c_long
            lib.msk_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_long]
            lib.msk_decode_block.restype = ctypes.c_long
            lib.msk_decode_block.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_long,
                np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
            ]
            _lib = lib
    return _lib


def _bad_row(row: int) -> ValueError:
    return ValueError(f"could not decode data block: bad numeric cell in row {row}")


def decode_block(text: bytes, num_cols: int) -> np.ndarray:
    """Decode a numeric CSV block natively into ``(rows, num_cols)`` float64.

    Raises:
        ValueError: naming the offending 1-based data row when a cell
            fails to parse.
    """
    lib = load_decoder()
    if isinstance(text, str):
        text = text.encode()
    # the newline count bounds the data rows (blank lines only shrink it)
    n_rows = text.count(b"\n") + 1
    out = np.empty((n_rows, num_cols), dtype=np.float64)
    got = ctypes.c_long(0)
    status = lib.msk_decode_block(text, len(text), num_cols, out, n_rows,
                                  ctypes.byref(got))
    if status != 0:
        raise _bad_row(status)
    return out[: got.value]


# what std::from_chars (general format) accepts, after the decoder has
# trimmed spaces and tabs and dropped one leading '+'
_NUMBER = re.compile(
    rb"-?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|inf(?:inity)?"
    rb"|(nan)(?:\([0-9A-Za-z_]*\))?)",
    re.IGNORECASE,
)
_PLAIN_DECIMAL = b"0123456789.-,"


def _cell(cell: bytes, row: int) -> float:
    """One cell by the native decoder's rules (``vicon_decode.cpp``)."""
    cell = cell.strip(b" \t")
    if cell[:1] == b"+":
        cell = cell[1:]
    if not cell:
        return math.nan  # empty, or a lone '+'
    match = _NUMBER.fullmatch(cell)
    if match is None:
        raise _bad_row(row)
    if match.group(1) is not None:  # nan, nan(chars), -nan
        return -math.nan if cell[:1] == b"-" else math.nan
    value = float(cell)
    lowered = cell.lower()
    if math.isinf(value) and b"inf" not in lowered:
        raise _bad_row(row)  # from_chars: out of range
    if value == 0.0 and cell.strip(b"-.0").lower()[:1] not in (b"", b"e"):
        raise _bad_row(row)  # from_chars: out of range (underflow)
    return value


def _in_range(values: List[float], cells: List[bytes]) -> bool:
    """Whether ``float()`` read plain decimal ``cells`` with neither
    overflow (inf) nor underflow (0.0 from a nonzero digit), the two
    cases ``std::from_chars`` rejects as out of range."""
    if math.inf in values or -math.inf in values:
        return False
    return 0.0 not in values or not any(
        v == 0.0 and c.translate(None, b"-.0") for v, c in zip(values, cells))


def decode_block_plain(text: bytes, num_cols: int) -> np.ndarray:
    """:func:`decode_block` in numpy and Python, with the same rules.

    Rows split on ``\\n`` (trailing ``\\r`` stripped), cells on ``,``;
    spaces and tabs around a cell are trimmed; an empty cell (or a lone
    ``+``) is NaN; cells beyond ``num_cols`` are ignored and short rows
    padded with NaN; a line with no content at all is skipped; numbers
    parse as ``std::from_chars`` parses them (``1.2E-03``, ``inf``,
    ``nan``), correctly rounded, so both decoders give the same bits.

    Raises:
        ValueError: naming the offending 1-based data row, in the
            native decoder's words.
    """
    if isinstance(text, str):
        text = text.encode()
    rows: List[List[float]] = []
    pad = [math.nan] * num_cols
    for line in text.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line.strip(b", \t\r"):
            continue  # no content in any column
        row = len(rows) + 1
        cells = line.split(b",", num_cols)[:num_cols]
        values = None
        if not line.translate(None, _PLAIN_DECIMAL):
            try:  # digits, dots and minus signs only: float() is exact here
                values = list(map(float, cells))
            except ValueError:
                values = None
            if values is not None and not _in_range(values, cells):
                values = None  # _cell raises as from_chars does
        if values is None:
            values = [_cell(c, row) for c in cells]
        if len(values) < num_cols:
            values += pad[len(values):]
        rows.append(values)
    if not rows:
        return np.empty((0, num_cols), dtype=np.float64)
    return np.array(rows, dtype=np.float64)


__all__ = ["decode_block", "decode_block_plain", "library_path", "load_decoder"]
