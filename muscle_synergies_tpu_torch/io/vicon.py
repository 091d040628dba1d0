"""Vicon Nexus CSV ingest: header sniffing + bulk numeric decode.

The reference implementation parses the file cell-by-cell through a
Python state machine (reference: src/muscle_synergies/vicon_data/
reader.py, aggregator.py, load_csv.py).  The grammar, however, is fixed:

    section 1:  "Devices"      <- section type line
                <int>          <- sampling frequency (forces/EMG rate)
                device headers <- one header every 3 columns, cols 0-1 blank
                coordinates    <- column labels; defines the column count
                units          <- physical units per column
                data rows...   <- floats; empty cell means missing (NaN)
                blank row
    section 2:  "Trajectories" (same 5-line header + data rows)

so this parser sniffs the five header lines per section and decodes the
whole numeric block at once with the native C++ decoder
(:mod:`muscle_synergies_tpu_torch.native`), landing each device as a
dense float64 array.  It is the port of :mod:`muscle_synergies_tpu.io.vicon`
without pandas: ``MST_DISABLE_NATIVE=1`` selects the plain numpy
decoder (:func:`~muscle_synergies_tpu_torch.native.decode_block_plain`,
same rules, same bits) in place of the JAX package's pandas fallback.
Semantics match the reference exactly:

- one device header every 3rd column starting at column 2
  (reference reader.py:380-443);
- in the Devices section every header except the last belongs to a
  force plate; headers come in "<name> - Force/Moment/CoP" triplets
  that are merged into one 9-column device named by the text before
  the first "-" (reference reader.py:446-516, 667-736);
- the last Devices header is the EMG device, spanning every column
  from its own to the end of the coordinates line
  (reference reader.py:723-736, aggregator.py:104-128);
- trajectory markers span 3 columns each (reference reader.py:757);
- the coordinates line, pruned of trailing blanks, fixes the column
  count for the rest of the section (reference reader.py:772-794);
- empty data cells decode as NaN (reference reader.py:927-955);
- parse errors report the 1-based line number
  (reference load_csv.py:128-134).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..data import DeviceData, DeviceType, ViconNexusData
from ..frames import ForcesEMGFrameTracker, SamplingFreq, TrajFrameTracker

__all__ = [
    "load_vicon_file",
    "load_vicon_files",
    "load_vicon_lines",
    "ViconCSVError",
    "ViconCSVLines",
    "Row",
]

#: A raw CSV row: one cell string per column (reference
#: vicon_data/definitions.py:18).
Row = List[str]


class ViconCSVLines(Enum):
    """The seven kinds of line in a Vicon Nexus export.

    Grammar vocabulary parity with the reference
    (vicon_data/definitions.py:45-86).  The bulk decoder does not walk
    a per-line state machine, but the grammar it recognizes is the
    same: each section is a 5-line header (type word, sampling
    frequency, device names, coordinates, units) followed by data
    lines, with a blank line between sections.
    """

    SECTION_TYPE_LINE = 1
    SAMPLING_FREQUENCY_LINE = 2
    DEVICE_NAMES_LINE = 3
    COORDINATES_LINE = 4
    UNITS_LINE = 5
    DATA_LINE = 6
    BLANK_LINE = 7


class ViconCSVError(ValueError):
    """Raised when a Vicon Nexus CSV file does not match the grammar."""


@dataclass
class _DeviceSpec:
    """A device discovered in the devices line: name, type, column span."""

    name: str
    device_type: DeviceType
    first_col: int
    last_col: int  # inclusive


@dataclass
class _Section:
    """One parsed section of the file."""

    section_type: str
    frequency: int
    devices: List[_DeviceSpec]
    coords: List[str]
    units: List[str]
    data: np.ndarray  # (num_rows, num_cols) float64, NaN for blanks


def _split_cells(line: str) -> List[str]:
    """Split one CSV line into cells.

    Plain ``split(",")`` on the fast path; quoted lines (a device name
    containing a comma, say) go through :mod:`csv` so cells stay atomic
    exactly as the reference's ``csv.reader`` row stream delivers them
    (reference load_csv.py:21-31).
    """
    if '"' in line:
        import csv

        return next(csv.reader([line]))
    return line.split(",")


def _prune_trailing(cells: List[str]) -> List[str]:
    """Strip each cell and drop trailing empty cells."""
    cells = [c.strip() for c in cells]
    while cells and not cells[-1]:
        cells.pop()
    return cells


def _is_blank(line: str) -> bool:
    """A section-separator line: only commas and plain whitespace.

    The explicit character set matches the byte-level splitter in
    :func:`_split_into_sections` (and the reference, whose BlankState
    requires every csv cell to be empty — a form-feed cell is content
    there too), so the streaming and whole-file parsers agree on what
    separates sections.
    """
    return not line.strip(", \t\r\n")


def _err(lineno: int, message: str) -> ViconCSVError:
    return ViconCSVError(f"error parsing line {lineno} of file: {message}")


def _parse_header_line(cells: List[str], lineno: int) -> List[Tuple[int, str]]:
    """Find device headers: one every 3 columns, starting at column 2."""
    if len(cells) < 3 or cells[0] or cells[1]:
        raise _err(
            lineno,
            "devices line should contain two blank columns then one device "
            "name every 3 columns",
        )
    headers = []
    for col in range(2, len(cells), 3):
        name = cells[col]
        if not name:
            raise _err(lineno, f"expected a device name in column {col}")
        headers.append((col, name))
        for filler in cells[col + 1 : col + 3]:
            if filler:
                raise _err(
                    lineno,
                    "devices line should contain one device name every 3 "
                    "columns with blanks in between",
                )
    return headers


def _force_plate_name(header: str) -> str:
    """Device name of a force-plate header such as "<name> - Force".

    Mirrors the reference renaming (reader.py:509-516): everything
    before the first "-", minus the trailing space.
    """
    return header.split("-")[0][:-1]


def _devices_from_forces_emg_headers(
    headers: List[Tuple[int, str]], num_cols: int, lineno: int
) -> List[_DeviceSpec]:
    if not headers:
        raise _err(lineno, "no device headers found in Devices section")
    plate_headers, (emg_col, emg_name) = headers[:-1], headers[-1]
    if len(plate_headers) % 3 != 0:
        raise _err(
            lineno,
            "expected force-plate headers to come in Force/Moment/CoP "
            f"triplets before the EMG device, found {len(plate_headers)}",
        )
    devices = []
    for i in range(0, len(plate_headers), 3):
        col, header = plate_headers[i]
        devices.append(
            _DeviceSpec(
                name=_force_plate_name(header),
                device_type=DeviceType.FORCE_PLATE,
                first_col=col,
                last_col=col + 8,
            )
        )
    devices.append(
        _DeviceSpec(
            name=emg_name,
            device_type=DeviceType.EMG,
            first_col=emg_col,
            last_col=num_cols - 1,
        )
    )
    return devices


def _devices_from_traj_headers(
    headers: List[Tuple[int, str]],
) -> List[_DeviceSpec]:
    return [
        _DeviceSpec(
            name=name,
            device_type=DeviceType.TRAJECTORY_MARKER,
            first_col=col,
            last_col=col + 2,
        )
        for col, name in headers
    ]


def _decode_data_block(
    data: bytes, num_cols: int, first_lineno: int
) -> np.ndarray:
    """Bulk-decode the numeric block of a section into float64.

    ``data`` is the raw data-block bytes (rows separated by newlines —
    CR tolerated).  Empty cells become NaN.  Columns beyond
    ``num_cols`` are ignored (they are padding in the Vicon export).
    Uses the native C++ decoder (built on demand; see
    :mod:`muscle_synergies_tpu_torch.native`; a failed build raises),
    or the plain decoder when ``MST_DISABLE_NATIVE=1``.
    """
    if not data.strip(b", \t\r\n"):
        return np.empty((0, num_cols), dtype=float)

    from .. import native

    decode = (
        native.decode_block_plain
        if os.environ.get("MST_DISABLE_NATIVE") == "1"
        else native.decode_block
    )
    try:
        return decode(data, num_cols)
    except ValueError as exc:
        raise _err(first_lineno, str(exc)) from exc


def _parse_section_header(
    lines: List[str], start_lineno: int, expected_type: str
) -> Tuple[int, List[_DeviceSpec], List[str], List[str]]:
    """Parse a section's 5 header lines.

    Returns ``(frequency, devices, coords, units)``.
    """
    if len(lines) < 5:
        raise _err(start_lineno, "section is too short (expected 5 header lines)")

    type_cells = _prune_trailing(_split_cells(lines[0]))
    if type_cells != [expected_type]:
        raise _err(
            start_lineno,
            f"expected section type line containing only {expected_type!r}, "
            f"got {type_cells!r}",
        )

    freq_cells = _prune_trailing(_split_cells(lines[1]))
    if len(freq_cells) != 1:
        raise _err(
            start_lineno + 1,
            "sampling frequency line should contain a single value",
        )
    try:
        frequency = int(freq_cells[0])
    except ValueError as exc:
        raise _err(start_lineno + 1, f"invalid sampling frequency: {exc}") from exc

    headers = _parse_header_line(
        _prune_trailing(_split_cells(lines[2])), start_lineno + 2
    )

    coords = _prune_trailing(_split_cells(lines[3]))
    num_cols = len(coords)

    # The units line is truncated to the column count but otherwise taken
    # verbatim (reference reader.py:797-836 keeps cells unstripped).
    units = _split_cells(lines[4])[:num_cols]
    if len(units) < num_cols:
        # writers may drop trailing commas for unitless columns; pad so
        # every device's units align with its coords
        units = units + [""] * (num_cols - len(units))

    if expected_type == "Devices":
        devices = _devices_from_forces_emg_headers(
            headers, num_cols, start_lineno + 2
        )
    else:
        devices = _devices_from_traj_headers(headers)
    return frequency, devices, coords, units


def _parse_section(
    chunk: bytes, start_lineno: int, expected_type: str
) -> _Section:
    """Parse one section (5 header lines + data-block bytes)."""
    parts = chunk.split(b"\n", 5)
    header = [p.rstrip(b"\r").decode() for p in parts[:5]]
    frequency, devices, coords, units = _parse_section_header(
        header, start_lineno, expected_type
    )
    data_bytes = parts[5] if len(parts) > 5 else b""
    data = _decode_data_block(data_bytes, len(coords), start_lineno + 5)
    return _Section(expected_type, frequency, devices, coords, units, data)


def _split_into_sections(data: bytes) -> List[Tuple[int, bytes]]:
    """Split capture bytes into (1-based start line, section bytes) chunks.

    Sections are maximal runs of non-blank lines; a blank line is one
    containing only commas/whitespace.  Line starts and blank
    candidates are found with vectorized numpy passes over the raw
    buffer (byte-level line splitting is UTF-8-safe) instead of a
    per-line Python scan — the capture has ~100k data lines and this
    is the ingest's second-hottest path after the float decode.
    """
    if b"\r" in data and data.count(b"\r\n") != data.count(b"\r"):
        # lone-CR terminators (classic-Mac exports): normalize once so
        # the newline-offset pass below sees every line boundary
        data = data.replace(b"\r\n", b"\n").replace(b"\r", b"\n")
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 0x0A)
    starts = np.empty(nl.size + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl + 1
    ends = np.empty(nl.size + 1, dtype=np.int64)
    ends[:-1] = nl
    ends[-1] = arr.size
    if starts.size and starts[-1] == arr.size:  # trailing-newline phantom
        starts, ends = starts[:-1], ends[:-1]
    if not starts.size:
        return []

    # cheap candidate test: empty line, or first byte comma/whitespace
    # (data lines start with a digit, header lines with a word char)
    first = arr[starts]
    cand = np.flatnonzero(
        (ends == starts)
        | (first == 0x2C)  # ,
        | (first == 0x20)  # space
        | (first == 0x09)  # tab
        | (first == 0x0D)  # CR
    )
    blank = [
        i
        for i in cand.tolist()
        if not data[starts[i] : ends[i]].strip(b", \t\r")
    ]

    sections = []
    prev = 0
    for b in blank + [starts.size]:
        if b > prev:
            sections.append(
                (prev + 1, data[starts[prev] : ends[b - 1]])
            )
        prev = b + 1
    return sections


def _read_bytes(csv_filename: Union[str, os.PathLike]) -> bytes:
    """Read the capture, transparently decompressing gzip archives."""
    with open(csv_filename, "rb") as stream:
        head = stream.read(2)
        stream.seek(0)
        if head == b"\x1f\x8b":  # gzip magic
            import gzip

            with gzip.open(stream, "rb") as gz:
                return gz.read()
        return stream.read()


def parse_vicon_bytes(data: bytes) -> List[_Section]:
    """Parse raw capture bytes into the two sections (Devices, Trajectories)."""
    chunks = _split_into_sections(data)
    if len(chunks) != 2:
        raise ViconCSVError(
            f"expected 2 sections (Devices, Trajectories), found {len(chunks)}"
        )
    (start1, bytes1), (start2, bytes2) = chunks
    section1 = _parse_section(bytes1, start1, "Devices")
    section2 = _parse_section(bytes2, start2, "Trajectories")
    return [section1, section2]


def parse_vicon_lines(lines: List[str]) -> List[_Section]:
    """Parse capture lines (the push-adapter path) into the two sections."""
    return parse_vicon_bytes("\n".join(lines).encode())


def parse_vicon_csv(csv_filename: Union[str, os.PathLike]) -> List[_Section]:
    """Parse the file into its two sections (Devices, Trajectories)."""
    return parse_vicon_bytes(_read_bytes(csv_filename))


def _build_device(
    spec: _DeviceSpec,
    section: _Section,
    frame_tracker,
) -> DeviceData:
    sl = slice(spec.first_col, spec.last_col + 1)
    return DeviceData(
        device_name=spec.name,
        device_type=spec.device_type,
        units=section.units[sl],
        frame_tracker=frame_tracker,
        array=section.data[:, sl],
        coords=section.coords[sl],
    )


def load_vicon_file(csv_filename: Union[str, os.PathLike]) -> ViconNexusData:
    """Load the CSV file exported by Vicon Nexus.

    Entry point mirroring the reference ``load_vicon_file``
    (reference load_csv.py:96-135): returns a :class:`ViconNexusData`
    with force plates, the single EMG device and trajectory markers.

    Raises:
        ViconCSVError: if the file does not follow the expected grammar
            (the message includes the 1-based line number) or if the
            number of EMG devices is not exactly one.
    """
    return _build_vicon_data(parse_vicon_csv(csv_filename))


def load_vicon_lines(lines: List[str]) -> ViconNexusData:
    """Build a :class:`ViconNexusData` from already-read capture lines.

    Line-level twin of :func:`load_vicon_file` — the entry point behind
    the compat package's push-style ``Reader``/``Builder`` factories
    (reference load_csv.py:44-93), where rows arrive one at a time
    instead of from a file.
    """
    return _build_vicon_data(parse_vicon_lines(lines))


def _build_vicon_data(sections: List[_Section]) -> ViconNexusData:
    forces_emg, traj = sections

    sampling_freq = SamplingFreq(
        freq_forces_emg=forces_emg.frequency,
        freq_traj=traj.frequency,
        num_frames=traj.data.shape[0],
    )
    fast_tracker = ForcesEMGFrameTracker(sampling_freq)
    slow_tracker = TrajFrameTracker(sampling_freq)

    forcepl = [
        _build_device(spec, forces_emg, fast_tracker)
        for spec in forces_emg.devices
        if spec.device_type is DeviceType.FORCE_PLATE
    ]
    emg_devices = [
        _build_device(spec, forces_emg, fast_tracker)
        for spec in forces_emg.devices
        if spec.device_type is DeviceType.EMG
    ]
    if len(emg_devices) != 1:
        raise ViconCSVError(
            f"found {len(emg_devices)} EMG devices - expected one"
        )
    markers = [_build_device(spec, traj, slow_tracker) for spec in traj.devices]

    return ViconNexusData(
        forcepl=forcepl,
        emg=emg_devices[0],
        traj=markers,
        sampling_freq=sampling_freq,
    )


def load_vicon_files(
    csv_filenames: Sequence[Union[str, os.PathLike]],
    max_workers: Optional[int] = None,
) -> List[ViconNexusData]:
    """Load several Vicon Nexus exports concurrently.

    Parsing is host-side and independent per file, so a thread pool
    (ctypes releases the GIL while the native decoder runs) overlaps file
    I/O and decoding across captures.  Results keep the input order.
    """
    import concurrent.futures

    paths = list(csv_filenames)
    if len(paths) == 1:
        return [load_vicon_file(paths[0])]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(load_vicon_file, paths))
