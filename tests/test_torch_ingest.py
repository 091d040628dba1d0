"""PyTorch port: Vicon ingest, its decoders, streaming and writers.

The port's ingest (``muscle_synergies_tpu_torch.io``, ``.data``,
``.frames``, ``.native``) is held to the JAX package's on the same
files: every device's name, type, units, coords, rates and array bit
for bit (NaN in the same places), the frame/subframe index math, the
pandas views, ``DeviceData.__eq__``, the 1-based line of each grammar
error, line endings, gzip and quoted cells.  The native decoder, the
plain decoder (``MST_DISABLE_NATIVE=1``) and the JAX loader agree bit
for bit on seeded random captures.  Streams equal the JAX package's
chunk for chunk.  The capture writers of both packages write files that
both loaders parse into the same arrays.
"""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu import testing as jtesting  # noqa: E402
from muscle_synergies_tpu.io import DeviceStream as JDeviceStream  # noqa: E402
from muscle_synergies_tpu.io import stream_vicon_file as j_stream  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import native  # noqa: E402
from muscle_synergies_tpu_torch import testing as ttesting  # noqa: E402
from muscle_synergies_tpu_torch.io import DeviceStream, stream_vicon_file  # noqa: E402
from muscle_synergies_tpu_torch.ops import filters  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the golden capture of the JAX package's ingest tests: 2 force plates
# and a 4-channel EMG at 300 Hz, 2 markers at 100 Hz, trailing blank
# columns, missing marker cells and scientific notation
GOLDEN_CSV = """\
Devices,,,,,,,,,,,,,,,,,,,,,,,,,
300,,,,,,,,,,,,,,,,,,,,,,,,,
,,Plate A - Force,,,Plate A - Moment,,,Plate A - CoP,,,Plate B - Force,,,Plate B - Moment,,,Plate B - CoP,,,MyEMG - Voltage,,,,,
Frame,Sub Frame,Fx,Fy,Fz,Mx,My,Mz,Cx,Cy,Cz,Fx,Fy,Fz,Mx,My,Mz,Cx,Cy,Cz,E1,E2,E3,E4,,
,,N,N,N,N.mm,N.mm,N.mm,mm,mm,mm,N,N,N,N.mm,N.mm,N.mm,mm,mm,mm,V,V,V,V,,
1,0,1,2,3,4,5,6,7,8,9,10,20,30,40,50,60,70,80,90,0.1,0.2,0.3,0.4,,
1,1,1.5,2,3,4,5,6,7,8,9,10,20,30,40,50,60,70,80,90,0.11,0.21,0.31,0.41,,
1,2,2,2,3,4,5,6,7,8,9,10,20,30,40,50,60,70,80,90,-0.1,1.2E-03,0.3,0.4,,
2,0,1,2,3,4,5,6,7,8,9,11,21,31,41,51,61,71,81,91,0.5,0.6,0.7,0.8,,
2,1,1,2,3,4,5,6,7,8,9,11,21,31,41,51,61,71,81,91,0.51,0.61,0.71,0.81,,
2,2,1,2,3,4,5,6,7,8,9,11,21,31,41,51,61,71,81,91,0.52,0.62,0.72,0.82,,
,,,,,,,,,,,,,,,,,,,,,,,,,
Trajectories,,,,,,,,,,,,,,,,,,,,,,,,,
100,,,,,,,,,,,,,,,,,,,,,,,,,
,,Subj:M1,,,Subj:M2,,
Frame,Sub Frame,X,Y,Z,X,Y,Z
,,mm,mm,mm,mm,mm,mm
1,0,100.5,200.25,300.125,,,
2,0,101.5,201.25,301.125,,,
"""


def _devices(data):
    return [data.emg] + list(data.forcepl) + list(data.traj)


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))


def _same_capture(port, ref):
    """Every device of the port's capture equals the JAX package's."""
    assert len(port.forcepl) == len(ref.forcepl)
    assert len(port.traj) == len(ref.traj)
    for a, b in zip(_devices(port), _devices(ref)):
        assert (a.name, a.dev_type.name, a.units, a.coords) == (
            b.name, b.dev_type.name, b.units, b.coords)
        assert a.sampling_frequency == b.sampling_frequency
        _same_bits(a.array, b.array)
    sp, sr = port.sampling_freq, ref.sampling_freq
    assert (sp.freq_forces_emg, sp.freq_traj, sp.num_frames, sp.num_subframes) == (
        sr.freq_forces_emg, sr.freq_traj, sr.num_frames, sr.num_subframes)


def _load_all(path, monkeypatch):
    """The port's capture by the native and the plain decoder, and the
    JAX package's (with its own default decoder)."""
    port = mt.load_vicon_file(path)
    with monkeypatch.context() as m:
        m.setenv("MST_DISABLE_NATIVE", "1")
        plain = mt.load_vicon_file(path)
    return port, plain, mst.load_vicon_file(path)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    path = tmp_path_factory.mktemp("vicon") / "golden.csv"
    path.write_text(GOLDEN_CSV)
    return mt.load_vicon_file(path), mst.load_vicon_file(path), path


@pytest.mark.parametrize("device", range(5))
def test_golden_devices_match_jax(golden, device):
    port, ref, _ = golden
    a, b = _devices(port)[device], _devices(ref)[device]
    assert (a.name, a.dev_type.name, a.units, a.coords) == (
        b.name, b.dev_type.name, b.units, b.coords)
    assert a.sampling_frequency == b.sampling_frequency
    _same_bits(a.array, b.array)
    assert (str(a), repr(a)) == (str(b), repr(b))


def test_golden_capture_api_matches_jax(golden):
    port, ref, _ = golden
    _same_capture(port, ref)
    assert port.describe() == ref.describe()
    assert repr(port) == repr(ref)
    for kind in ("emg", "fp", "force plate", "traj", "marker"):
        assert port.sampling_frequency(kind) == ref.sampling_frequency(kind)
    _same_bits(port.emg_array(), ref.emg_array())
    _same_bits(port.forcepl_array(), ref.forcepl_array())
    _same_bits(port.traj_array(), ref.traj_array())
    assert port["emg"] is port.emg and port[mt.DeviceType.EMG] is port.emg
    assert port["fp"] == port.forcepl and port["marker"] == port.traj
    for bad in ("accelerometer", "Fp-2"):
        with pytest.raises(ValueError) as want:
            ref[bad]
        with pytest.raises(ValueError) as got:
            port[bad]
        assert str(got.value) == str(want.value)


def test_frame_subframe_round_trips_match_jax(golden):
    port, ref, _ = golden
    for a, b in zip(_devices(port), _devices(ref)):
        last = a._frame_tracker.final_index
        assert last == b._frame_tracker.final_index
        for idx in range(last + 1):
            pair = a.to_framesubfr(idx)
            assert pair == b.to_framesubfr(idx)
            assert a.to_index(pair) == b.to_index(pair) == idx
            assert a.to_index(*pair) == idx
        assert a.to_index(slice((1, 0), (2, 0))) == b.to_index(slice((1, 0), (2, 0)))
        assert a.to_framesubfr(slice(0, last)) == b.to_framesubfr(slice(0, last))
        frames, subframes = np.array([1, 2, 2]), np.array([0, 0, 1])
        np.testing.assert_array_equal(a._frame_tracker.index_array(frames, subframes),
                                      b._frame_tracker.index_array(frames, subframes))
    for kind in ("emg", "traj"):
        assert port.to_index(kind, (2, 0)) == ref.to_index(kind, (2, 0))
        assert port.to_framesubfr(kind, 1) == ref.to_framesubfr(kind, 1)


@pytest.mark.parametrize("pair", [(-1, 0), (0, 3), (1, 3), (3, 0), (3, 2)])
def test_out_of_range_errors_match_jax(golden, pair):
    port, ref, _ = golden
    for a, b in zip(_devices(port), _devices(ref)):
        with pytest.raises(IndexError) as want:
            b.to_index(pair)
        with pytest.raises(IndexError) as got:
            a.to_index(pair)
        assert str(got.value) == str(want.value)
        with pytest.raises(IndexError) as got_index:
            a.to_framesubfr(99)
        with pytest.raises(IndexError) as want_index:
            b.to_framesubfr(99)
        assert str(got_index.value) == str(want_index.value)


def test_pandas_views_match_jax(golden):
    pd = pytest.importorskip("pandas")
    port, ref, _ = golden
    for a, b in zip(_devices(port), _devices(ref)):
        pd.testing.assert_frame_equal(a.df, b.df)
        pd.testing.assert_series_equal(a[(1, 1)], b[(1, 1)])
        pd.testing.assert_frame_equal(a[(1, 0):(2, 0)], b[(1, 0):(2, 0)])
        pd.testing.assert_series_equal(a.time_seq(), b.time_seq())
    pd.testing.assert_series_equal(port.get_cols("emg", cols="E1"),
                                   ref.get_cols("emg", cols="E1"))
    for got, want in zip(port.get_cols("fp", device_inds=[1], time=(1, 2), cols="Fz"),
                         ref.get_cols("fp", device_inds=[1], time=(1, 2), cols="Fz")):
        assert got == want
    pd.testing.assert_series_equal(port.time_seq("traj"), ref.time_seq("traj"))


def _device_pairs(pkg):
    """Pairs of DeviceData on which ``__eq__`` is held to the JAX one."""
    sf = pkg.SamplingFreq(300, 100, num_frames=2)
    fast = pkg.ForcesEMGFrameTracker(sf)
    base = np.array([[1.0, np.nan], [3.0, 4.0]] * 3)
    moved_nan = base.copy()
    moved_nan[0, 1], moved_nan[1, 1] = 2.0, np.nan
    signed_zero = base.copy()
    signed_zero[1, 0] = -0.0
    zero = signed_zero.copy()
    zero[1, 0] = 0.0

    def dev(array=base, name="EMG", units=("V", "V"), coords=("E1", "E2"),
            kind=pkg.DeviceType.EMG):
        return pkg.DeviceData(name, kind, units, fast, array=array, coords=coords)

    pairs = [
        (dev(), dev()),
        (dev(), dev(base.copy())),
        (dev(), dev(name="Other")),
        (dev(), dev(units=("V", "mV"))),
        (dev(), dev(coords=("E1", "E3"))),
        (dev(), dev(kind=pkg.DeviceType.FORCE_PLATE)),
        (dev(), dev(moved_nan)),
        (dev(), dev(base[:4])),
        (dev(signed_zero), dev(zero)),
        (dev(), dev(base + 1e-12)),
    ]
    pd = pytest.importorskip("pandas")
    frame = pd.DataFrame(base, columns=["E1", "E2"])
    ints = pd.DataFrame(np.arange(12).reshape(6, 2), columns=["E1", "E2"])
    pairs += [
        (pkg.DeviceData("EMG", pkg.DeviceType.EMG, ("V", "V"), fast, frame), dev()),
        (pkg.DeviceData("EMG", pkg.DeviceType.EMG, ("V", "V"), fast, ints),
         dev(np.arange(12.0).reshape(6, 2))),
    ]
    return pairs


def test_device_equality_matches_jax():
    port_pairs, ref_pairs = _device_pairs(mt), _device_pairs(mst)
    got = [a == b for a, b in port_pairs]
    want = [a == b for a, b in ref_pairs]
    assert got == want
    assert True in got and False in got


MALFORMED = {
    "wrong section word": lambda t: t.replace("Devices", "Gadgets", 1),
    "bad frequency": lambda t: t.replace("300,", "3a0,", 1),
    "bad device header layout": lambda t: t.replace(
        ",,Plate A - Force,,", "Oops,,Plate A - Force,,", 1),
    "non-numeric data cell": lambda t: t.replace("1,0,1,2,3", "1,0,xx,2,3", 1),
    "non-numeric trajectory cell": lambda t: t.replace("2,0,101.5", "2,0,1O1.5", 1),
    "missing section": lambda t: t.split("Trajectories")[0].rstrip(", \n"),
    "extra section": lambda t: t + ",,\nDevices,,\n300,,\n",
    "bad trajectory frequency": lambda t: t.replace("100,", "1e2,", 1),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_input_raises_as_jax(tmp_path, monkeypatch, case):
    path = tmp_path / "bad.csv"
    path.write_text(MALFORMED[case](GOLDEN_CSV))
    with pytest.raises(mst.ViconCSVError) as want:
        mst.load_vicon_file(path)
    with pytest.raises(mt.ViconCSVError) as got:
        mt.load_vicon_file(path)
    assert str(got.value) == str(want.value)
    assert "line" in str(got.value) or "sections" in str(got.value)
    monkeypatch.setenv("MST_DISABLE_NATIVE", "1")
    with pytest.raises(mt.ViconCSVError) as plain:
        mt.load_vicon_file(path)
    assert str(plain.value) == str(got.value)


ENCODINGS = {
    "crlf": lambda t: t.replace("\n", "\r\n").encode(),
    "lone cr": lambda t: t.replace("\n", "\r").encode(),
    "gzip": lambda t: gzip.compress(t.encode()),
    "quoted cells": lambda t: t.replace("Plate A - Force", '"Plate A, Left - Force"')
    .replace("Plate A - Moment", '"Plate A, Left - Moment"')
    .replace("Plate A - CoP", '"Plate A, Left - CoP"').encode(),
}


@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_line_endings_gzip_and_quotes_match_jax(tmp_path, monkeypatch, encoding):
    path = tmp_path / "capture.csv"
    path.write_bytes(ENCODINGS[encoding](GOLDEN_CSV))
    port, plain, ref = _load_all(path, monkeypatch)
    _same_capture(port, ref)
    _same_capture(plain, ref)
    if encoding == "quoted cells":
        assert port.forcepl[0].name == "Plate A, Left"


def _random_capture_text(rng):
    """A random grammar-conforming export: device counts, channel counts,
    rates, missing cells, trailing padding and number styles."""
    n_plates = int(rng.integers(0, 4))
    n_emg = int(rng.integers(1, 10))
    n_markers = int(rng.integers(1, 6))
    subframes = int(rng.integers(1, 5))
    n_frames = int(rng.integers(2, 30))
    slow = int(rng.integers(50, 200))

    def fmt(v):
        style = rng.integers(0, 4)
        if style == 0:
            return f"{v:.6g}"
        if style == 1:
            return f"{v:.3E}"
        if style == 2:
            return repr(float(v))
        return f"{v:.4f}"

    trailing = "," * int(rng.integers(0, 6))
    headers = [""] * 2
    for p in range(n_plates):
        for kind in ("Force", "Moment", "CoP"):
            headers += [f"Plate {p} - {kind}", "", ""]
    headers += [f"EMG unit {n_emg} - Voltage"]
    coords = ["Frame", "Sub Frame"] + (
        ["Fx", "Fy", "Fz", "Mx", "My", "Mz", "Cx", "Cy", "Cz"] * n_plates
    ) + [f"M{i}" for i in range(n_emg)]
    units = ["", ""] + (["N"] * 3 + ["N.mm"] * 3 + ["mm"] * 3) * n_plates + ["V"] * n_emg
    lines = ["Devices" + trailing, f"{slow * subframes}" + trailing,
             ",".join(headers) + trailing, ",".join(coords) + trailing,
             ",".join(units) + trailing]
    for i in range(n_frames * subframes):
        cells = [str(i // subframes + 1), str(i % subframes)]
        cells += ["" if rng.random() < 0.08 else fmt(v)
                  for v in rng.standard_normal(len(coords) - 2)]
        lines.append(",".join(cells) + trailing)
    lines.append("," * max(3, len(coords)))
    headers = [""] * 2
    for m in range(n_markers):
        headers += [f"S:{m}", "", ""]
    lines += ["Trajectories" + trailing, f"{slow}" + trailing,
              ",".join(headers) + trailing,
              ",".join(["Frame", "Sub Frame"] + ["X", "Y", "Z"] * n_markers) + trailing,
              ",".join(["", ""] + ["mm"] * (3 * n_markers)) + trailing]
    for i in range(n_frames):
        cells = [str(i + 1), "0"]
        cells += ["" if rng.random() < 0.15 else fmt(v)
                  for v in rng.standard_normal(3 * n_markers)]
        lines.append(",".join(cells) + trailing)
    return "\n".join(lines) + "\n", n_plates, n_emg, n_markers


@pytest.mark.parametrize("seed", range(20))
def test_decoders_agree_on_random_captures(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    text, n_plates, n_emg, n_markers = _random_capture_text(rng)
    path = tmp_path / f"fuzz_{seed}.csv"
    path.write_text(text)
    port, plain, ref = _load_all(path, monkeypatch)
    assert len(port.forcepl) == n_plates and len(port.traj) == n_markers
    assert port.emg.array.shape[1] == n_emg
    _same_capture(port, ref)
    _same_capture(plain, ref)


BLOCKS = {
    "gaps and padding": (b"1,2,3\n,,\n4,,6,7,8\n 9 ,\t10\t,\n", 3),
    "notation and signs": (b"1.2E-03,-4.5e+2,+7\n.5,1.,-0\n+,-.25,1e-310\n", 3),
    "inf and nan": (b"inf,-Infinity,nan\nNaN(1),-nan,INF\n", 3),
    "long mantissas": (b"0.12345678901234567890,123456789012345678901234\n", 2),
    "blank lines": (b"1,2\n\n , \t,\r\n3,4\r\n\n", 2),
    "no final newline": (b"1,2\n3,4", 2),
    "crlf": (b"1,2\r\n3,4\r\n", 2),
    "wide rows": (b"1,2,x,y\n3,4,5\n", 2),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_native_and_plain_decoders_agree_on_cells(case):
    text, num_cols = BLOCKS[case]
    got = native.decode_block(text, num_cols)
    want = native.decode_block_plain(text, num_cols)
    np.testing.assert_array_equal(got, want)  # NaN in the same places
    finite = np.isfinite(want)
    _same_bits(np.where(finite, got, 0.0), np.where(finite, want, 0.0))


@pytest.mark.parametrize("text", [b"1,2\n3,x\n", b"1,2\n\n3,--1\n", b"1,1e400\n",
                                  b"1,1e-400\n", b"++1,2\n", b"1,2\n3,\r4\n", b"1,.\n", b"1,1_0\n",
                                  b"1,2\n3," + b"9" * 400 + b"\n",
                                  b"1,2\n3,-0." + b"0" * 400 + b"1\n"])
def test_decoders_name_the_same_bad_row(text):
    with pytest.raises(ValueError) as got:
        native.decode_block(text, 2)
    with pytest.raises(ValueError) as want:
        native.decode_block_plain(text, 2)
    assert str(got.value) == str(want.value)
    assert "bad numeric cell in row" in str(got.value)


def test_threaded_native_decode_matches_plain(monkeypatch):
    rng = np.random.default_rng(3)
    block = np.round(rng.standard_normal((40_000, 5)), 6)
    text = "\n".join(",".join(map(repr, row)) for row in block.tolist()).encode()
    assert len(text) > 1 << 20  # the native decoder splits it over threads
    monkeypatch.setenv("MSK_DECODE_THREADS", "4")
    _same_bits(native.decode_block(text, 5), block)
    _same_bits(native.decode_block_plain(text, 5), block)


def test_native_library_builds_under_build_dir():
    package = os.path.join(REPO, "muscle_synergies_tpu_torch")
    before = {os.path.join(d, f) for d, _, fs in os.walk(package) for f in fs}
    native.load_decoder()
    path = native.library_path()
    assert path.is_file()
    assert path.parent == native.BUILD_DIR
    assert os.path.realpath(path.parent) == os.path.join(os.path.realpath(REPO),
                                                         "build", "native")
    after = {os.path.join(d, f) for d, _, fs in os.walk(package) for f in fs}
    written = [p for p in after - before if "__pycache__" not in p]
    assert not written, written
    assert not [p for p in after if p.endswith(".so")]


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "vicon_decode.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.load_decoder()
    assert "error" in str(err.value)
    assert native._lib is None


def test_load_vicon_files_and_lines_match_jax(tmp_path):
    paths = []
    for seed in range(3):
        text = _random_capture_text(np.random.default_rng(100 + seed))[0]
        paths.append(tmp_path / f"c{seed}.csv")
        paths[-1].write_text(text)
    ports = mt.io.load_vicon_files(paths, max_workers=3)
    for port, path in zip(ports, paths):
        _same_capture(port, mst.load_vicon_file(path))
    lines = GOLDEN_CSV.splitlines()
    _same_capture(mt.io.load_vicon_lines(lines), mst.io.load_vicon_lines(lines))


@pytest.mark.parametrize("chunk_rows", [1, 7, 65536])
def test_stream_chunks_match_jax(golden, chunk_rows):
    _, _, path = golden
    got = list(stream_vicon_file(path, chunk_rows=chunk_rows))
    want = list(j_stream(path, chunk_rows=chunk_rows))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.row_offset, a.header.section_type, a.header.frequency,
                a.header.coords, a.header.units, a.header.num_cols) == (
            b.row_offset, b.header.section_type, b.header.frequency,
            b.header.coords, b.header.units, b.header.num_cols)
        assert [(d.name, d.device_type.name, d.first_col, d.last_col)
                for d in a.header.devices] == [
            (d.name, d.device_type.name, d.first_col, d.last_col)
            for d in b.header.devices]
        _same_bits(a.data, b.data)
    first = list(stream_vicon_file(path, chunk_rows=chunk_rows, stop_after="Devices"))
    assert {c.header.section_type for c in first} == {"Devices"}
    assert len(first) == len(list(j_stream(path, chunk_rows=chunk_rows,
                                           stop_after="Devices")))


@pytest.mark.parametrize("device", ["emg", 0, 1, "Plate B"])
def test_device_stream_matches_jax(golden, device):
    _, _, path = golden
    port, ref = DeviceStream(path, device, chunk_rows=2), JDeviceStream(path, device,
                                                                        chunk_rows=2)
    assert (port.frequency, port.coords, port.units, port.spec.name) == (
        ref.frequency, ref.coords, ref.units, ref.spec.name)
    got, want = list(port), list(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_bits(a, b)


def test_stream_errors_match_jax(golden, tmp_path):
    _, _, path = golden
    for bad in ("nope", 7):
        with pytest.raises(KeyError) as want:
            JDeviceStream(path, bad)
        with pytest.raises(KeyError) as got:
            DeviceStream(path, bad)
        assert str(got.value) == str(want.value)
    for kw in (dict(chunk_rows=0), dict(stop_after="Forces")):
        with pytest.raises(ValueError) as want:
            next(j_stream(path, **kw))
        with pytest.raises(ValueError) as got:
            next(stream_vicon_file(path, **kw))
        assert str(got.value) == str(want.value)
    for case in ("missing section", "extra section"):
        bad = tmp_path / f"{case}.csv"
        bad.write_text(MALFORMED[case](GOLDEN_CSV))
        with pytest.raises(mst.ViconCSVError) as want:
            list(j_stream(bad))
        with pytest.raises(mt.ViconCSVError) as got:
            list(stream_vicon_file(bad))
        assert str(got.value) == str(want.value)


def test_streamed_causal_filter_equals_one_pass(tmp_path):
    path = tmp_path / "capture.csv"
    ttesting.write_synthetic_capture(str(path), state_len=120, n_markers=2, seed=5)
    whole = mt.load_vicon_file(path).emg.array
    sos = filters.sos_design(4, 10.0, 2000.0)
    zi = torch.as_tensor(filters.sosfilt_zi(sos))[:, :, None] * torch.as_tensor(whole[0])
    one, _ = filters.sosfilt(sos, torch.as_tensor(whole), zi=zi, return_zf=True)
    state, parts = zi, []
    for chunk in DeviceStream(path, "emg", chunk_rows=700):
        part, state = filters.sosfilt(sos, torch.as_tensor(chunk), zi=state,
                                      return_zf=True)
        parts.append(part)
    streamed = torch.cat(parts)
    assert streamed.shape == one.shape
    assert float((streamed - one).abs().max()) <= 1e-12 * float(one.abs().max())


WRITERS = {
    "defaults": dict(state_len=60),
    "rates and markers": dict(state_len=45, n_trechos=2, n_cycles=3, freq_forces=1500,
                              freq_traj=150, n_markers=3, seed=7),
}


@pytest.mark.parametrize("case", list(WRITERS))
def test_capture_writers_match_jax(tmp_path, case):
    kw = WRITERS[case]
    port_path = ttesting.write_synthetic_capture(str(tmp_path / "port.csv"), **kw)
    jax_path = jtesting.write_synthetic_capture(str(tmp_path / "jax.csv"), **kw)
    assert port_path == str(tmp_path / "port.csv")
    for load in (mt.load_vicon_file, mst.load_vicon_file):
        a, b = load(port_path), load(jax_path)
        for x, y in zip(_devices(a), _devices(b)):
            assert (x.name, x.units, x.coords) == (y.name, y.units, y.coords)
            _same_bits(x.array, y.array)
    port = mt.load_vicon_file(port_path)
    _same_capture(port, mst.load_vicon_file(port_path))
    assert port.emg.coords == ttesting.GAIT_MUSCLES == jtesting.GAIT_MUSCLES


def test_reference_twin_writer_matches_jax(tmp_path):
    port_path = ttesting.write_reference_fulldata_twin(str(tmp_path / "port.csv"))
    jax_path = jtesting.write_reference_fulldata_twin(str(tmp_path / "jax.csv"))
    a, b = mt.load_vicon_file(port_path), mst.load_vicon_file(jax_path)
    _same_capture(a, b)
    _same_capture(a, mst.load_vicon_file(port_path))
    assert len(a.traj) == len(ttesting.REFERENCE_TRAJ_MARKERS) == 40
    assert a.emg.array.shape == (124_460, 8)


@pytest.mark.parametrize("kw", [dict(n_samples=3000), dict(n_samples=500, seed=3,
                                                           unique_weight=0.3)])
def test_synthesized_gait_emg_matches_jax(kw):
    pd = pytest.importorskip("pandas")
    pd.testing.assert_frame_equal(ttesting.synthesize_gait_emg(**kw),
                                  jtesting.synthesize_gait_emg(**kw))
    assert ttesting.FP_COLS == jtesting.FP_COLS
    assert ttesting.FP_UNITS == jtesting.FP_UNITS
    assert ttesting.REFERENCE_TRAJ_MARKERS == jtesting.REFERENCE_TRAJ_MARKERS
