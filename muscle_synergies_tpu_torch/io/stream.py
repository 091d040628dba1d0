"""Streaming ingest: iterate a capture chunk-by-chunk, bounded memory.

Port of :mod:`muscle_synergies_tpu.io.stream` (numpy only).

The reference materializes the whole file before parsing (reference
load_csv.py:21-31 builds per-cell Python lists for every line); this
module walks the same two-section grammar incrementally, so captures
larger than memory can be reduced on the fly — e.g. a causal filter
pass carrying ``sosfilt`` state across chunks is *exactly* equal to
filtering the whole signal at once.

Core: :func:`stream_vicon_file` yields :class:`ViconChunk` blocks
(section header + a decoded ``(rows, num_cols)`` float array) in file
order, never holding more than ``chunk_rows`` lines of text.
Convenience: :class:`DeviceStream` narrows the stream to one device's
column slice and stops reading the file as soon as its section ends.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

import numpy as np

from .vicon import (
    ViconCSVError,
    _DeviceSpec,
    _decode_data_block,
    _err,
    _is_blank,
    _parse_section_header,
)
from ..data import DeviceType

__all__ = ["SectionHeader", "ViconChunk", "stream_vicon_file", "DeviceStream"]

_SECTION_TYPES = ("Devices", "Trajectories")


@dataclass
class SectionHeader:
    """The five parsed header lines of one section."""

    section_type: str
    frequency: int
    devices: List[_DeviceSpec]
    coords: List[str]
    units: List[str]

    @property
    def num_cols(self) -> int:
        return len(self.coords)


@dataclass
class ViconChunk:
    """A decoded slab of one section's data block."""

    header: SectionHeader
    row_offset: int  # 0-based row index of this chunk within the section
    data: np.ndarray  # (rows, header.num_cols) float64, NaN for blanks


def _open_lines(csv_filename: Union[str, os.PathLike]):
    """Open the capture as a text line stream (gzip-transparent)."""
    raw = open(csv_filename, "rb")
    try:
        head = raw.read(2)
        raw.seek(0)
        if head == b"\x1f\x8b":  # gzip magic
            import gzip

            # explicit utf-8: the whole-file parser decodes
            # utf-8, and locale defaults must not diverge
            return gzip.open(raw, "rt", encoding="utf-8"), raw
        import io as _io

        wrapper = _io.TextIOWrapper(raw, encoding="utf-8")
        return wrapper, raw
    except Exception:
        raw.close()
        raise


def stream_vicon_file(
    csv_filename: Union[str, os.PathLike],
    chunk_rows: int = 65536,
    stop_after: Optional[str] = None,
) -> Iterator[ViconChunk]:
    """Yield decoded chunks of the capture's two sections, in order.

    Every section yields at least one chunk (possibly with zero rows)
    so consumers always see each section's header.  Grammar errors
    raise :class:`ViconCSVError` with the 1-based line number, exactly
    like :func:`~muscle_synergies_tpu_torch.io.vicon.load_vicon_file`.

    ``stop_after`` names a section type after whose chunks iteration
    ends without reading (or validating) the rest of the file — e.g.
    ``"Devices"`` when only the fast section matters.
    """
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if stop_after is not None and stop_after not in _SECTION_TYPES:
        raise ValueError(
            f"stop_after must be one of {_SECTION_TYPES}, got {stop_after!r}"
        )
    text, raw = _open_lines(csv_filename)
    try:
        lineno = 0
        lines = iter(text)

        def next_line():
            nonlocal lineno
            line = next(lines, None)
            if line is not None:
                lineno += 1
                line = line.rstrip("\n")
            return line

        for section_idx, expected_type in enumerate(_SECTION_TYPES):
            # skip blank separator lines before the section
            line = next_line()
            while line is not None and _is_blank(line):
                line = next_line()
            if line is None:
                raise ViconCSVError(
                    "expected 2 sections (Devices, Trajectories), "
                    f"found {section_idx}"
                )

            # five header lines
            start_lineno = lineno
            header_lines = [line]
            while len(header_lines) < 5:
                line = next_line()
                if line is None or _is_blank(line):
                    raise _err(
                        start_lineno,
                        "section is too short (expected 5 header lines)",
                    )
                header_lines.append(line)
            frequency, devices, coords, units = _parse_section_header(
                header_lines, start_lineno, expected_type
            )
            header = SectionHeader(expected_type, frequency, devices, coords, units)

            # data block, flushed every chunk_rows lines
            row_offset = 0
            buffer: List[str] = []
            buffer_start = lineno + 1
            emitted = False

            def flush():
                nonlocal row_offset, buffer, buffer_start, emitted
                data = _decode_data_block(
                    "\n".join(buffer).encode(), header.num_cols, buffer_start
                )
                chunk = ViconChunk(header, row_offset, data)
                row_offset += data.shape[0]
                buffer = []
                buffer_start = lineno + 1
                emitted = True
                return chunk

            while True:
                line = next_line()
                if line is None or _is_blank(line):
                    break
                buffer.append(line)
                if len(buffer) == chunk_rows:
                    yield flush()
            if buffer or not emitted:
                yield flush()
            if stop_after == expected_type:
                return

        # anything non-blank after the two sections breaks the grammar,
        # matching the whole-file parser's section count check
        line = next_line()
        while line is not None:
            if not _is_blank(line):
                raise _err(
                    lineno,
                    "expected 2 sections (Devices, Trajectories), found more",
                )
            line = next_line()
    finally:
        text.close()
        raw.close()


def _find_device_spec(
    header: SectionHeader, device: Union[str, int]
) -> _DeviceSpec:
    if isinstance(device, int):
        plates = [
            s for s in header.devices if s.device_type is DeviceType.FORCE_PLATE
        ]
        try:
            return plates[device]
        except IndexError:
            raise KeyError(
                f"force-plate index {device} out of range ({len(plates)} plates)"
            ) from None
    if device.lower() == "emg":
        for spec in header.devices:
            if spec.device_type is DeviceType.EMG:
                return spec
    for spec in header.devices:
        if spec.name == device:
            return spec
    raise KeyError(
        f"no device {device!r}; available: "
        f"{[s.name for s in header.devices]}"
    )


class DeviceStream:
    """One device's samples, streamed chunk-by-chunk.

    The Devices-section header is parsed eagerly so ``spec`` /
    ``coords`` / ``units`` / ``frequency`` are available before any
    data is read; iteration then decodes only up to the end of the
    fast section (the trajectory block is never touched).

    Args:
        device: ``"emg"`` (default), a device name, or an integer
            force-plate index.

    Example — exact streaming causal filtering::

        stream = DeviceStream(path, "emg", chunk_rows=8192)
        zi = sosfilt_zi(sos)[:, :, None] * first_sample
        for chunk in stream:
            y, zi = sosfilt(sos, torch.as_tensor(chunk), zi=zi,
                            return_zf=True)
            consume(y)
    """

    def __init__(
        self,
        csv_filename: Union[str, os.PathLike],
        device: Union[str, int] = "emg",
        chunk_rows: int = 65536,
    ):
        self._path = csv_filename
        self._chunk_rows = chunk_rows
        gen = stream_vicon_file(csv_filename, chunk_rows=1, stop_after="Devices")
        try:
            header = next(gen).header
        finally:
            gen.close()
        self.spec = _find_device_spec(header, device)
        self._slice = slice(self.spec.first_col, self.spec.last_col + 1)
        self.frequency = header.frequency
        self.coords = header.coords[self._slice]
        self.units = header.units[self._slice]

    def __iter__(self) -> Iterator[np.ndarray]:
        chunks = stream_vicon_file(
            self._path, self._chunk_rows, stop_after="Devices"
        )
        for chunk in chunks:
            if chunk.data.shape[0]:
                yield chunk.data[:, self._slice]
