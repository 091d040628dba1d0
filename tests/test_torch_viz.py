"""PyTorch port: the plots against the JAX package's figures, by value.

Each of the six plots of ``viz``, ``ViconNexusData.plot_cols`` and
``segment.SegmentPlotter``'s public methods run with the JAX package's
arguments and ``show=False`` on the Agg backend, in both packages.  The
JAX package draws its heatmaps with seaborn, the port with matplotlib
alone; the figures must agree in the number of axes, every title, axis
label and tick label (after a draw), every line's x/y data, every mesh's
array and rectangle's extent (1e-12) and every annotation's text and
place.  Values, not pixels: the colormaps differ.  The port's array
forms (``columns=``, ``index=``) draw what the DataFrame forms draw.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
pd = pytest.importorskip("pandas")
pytest.importorskip("seaborn")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.collections import QuadMesh  # noqa: E402
from matplotlib.patches import Rectangle  # noqa: E402

from muscle_synergies_tpu import viz as jviz  # noqa: E402
import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.segment import SegmentPlotter as JPlotter  # noqa: E402
from muscle_synergies_tpu.testing import write_synthetic_capture  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import viz as tviz  # noqa: E402
from muscle_synergies_tpu_torch.segment import SegmentPlotter as TPlotter  # noqa: E402

MUSCLES = ["VL", "RF", "TA", "GM", "SOL"]


def _summary(fig):
    """Everything compared of a figure, axes by axes."""
    fig.canvas.draw()
    out = []
    for ax in fig.axes:
        out.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            xticks=[t.get_text() for t in ax.get_xticklabels()],
            yticks=[t.get_text() for t in ax.get_yticklabels()],
            limits=np.array([*ax.get_xlim(), *ax.get_ylim()]),
            lines=[(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float))
                   for ln in ax.get_lines()],
            meshes=[np.asarray(c.get_array(), float).ravel()
                    for c in ax.collections if isinstance(c, QuadMesh)],
            rects=[np.array([*r.get_xy(), r.get_width(), r.get_height()])
                   for r in ax.patches if isinstance(r, Rectangle)],
            texts=[(t.get_text(), tuple(t.get_position())) for t in ax.texts],
        ))
    suptitle = fig._suptitle.get_text() if fig._suptitle is not None else None
    return out, suptitle


def _same_figure(got, want):
    (g_axes, g_sup), (w_axes, w_sup) = _summary(got), _summary(want)
    assert g_sup == w_sup
    assert len(g_axes) == len(w_axes)
    for g, w in zip(g_axes, w_axes):
        for key in ("title", "xlabel", "ylabel", "xticks", "yticks", "texts"):
            assert g[key] == w[key], (key, g[key], w[key])
        np.testing.assert_allclose(g["limits"], w["limits"], rtol=1e-12, atol=1e-12)
        for key in ("meshes", "rects"):
            assert len(g[key]) == len(w[key]), key
            for a, b in zip(g[key], w[key]):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        assert len(g["lines"]) == len(w["lines"])
        for (gx, gy), (wx, wy) in zip(g["lines"], w["lines"]):
            np.testing.assert_allclose(gx, wx, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(gy, wy, rtol=1e-12, atol=1e-12)
    plt.close(got)
    plt.close(want)


def _figs(out):
    """The figure of a plot's return value (a figure or ``(fig, ax)``)."""
    return out[0] if isinstance(out, tuple) else out


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(5)
    return pd.DataFrame(np.abs(rng.standard_normal((120, 4))),
                        index=np.linspace(0, 1, 120), columns=MUSCLES[:4])


@pytest.mark.parametrize("kwargs", [
    dict(title="processed EMG"),
    dict(title="grid", plot_dims=(2, 2), xticks_off=True, ylabel="mV"),
])
def test_plot_signal_matches_jax(signal, kwargs):
    _same_figure(tviz.plot_signal(signal, show=False, **kwargs),
                 jviz.plot_signal(signal, show=False, **kwargs))
    # the array form, no pandas
    _same_figure(tviz.plot_signal(signal.to_numpy(), show=False, columns=MUSCLES[:4],
                                  index=signal.index.to_numpy(), **kwargs),
                 jviz.plot_signal(signal, show=False, **kwargs))
    with pytest.raises(ValueError, match="plot_dims"):
        tviz.plot_signal(signal, plot_dims=(3, 3), show=False)


@pytest.mark.parametrize("rank", [2, 4])
def test_synergy_heatmap_matches_jax(rank):
    comps = pd.DataFrame(np.random.default_rng(rank).random((rank, 5)), columns=MUSCLES)
    _same_figure(tviz.synergy_heatmap(comps, show=False),
                 jviz.synergy_heatmap(comps, show=False))
    names = [f"s{i}" for i in range(rank)]
    _same_figure(tviz.synergy_heatmap(comps.to_numpy(), names, show=False,
                                      columns=MUSCLES),
                 jviz.synergy_heatmap(comps, names, show=False))


def test_plot_fft_matches_jax(signal):
    _same_figure(tviz.plot_fft(signal, 100, show=False, device="cpu"),
                 jviz.plot_fft(signal, 100, show=False))


@pytest.mark.parametrize("fs", [None, 100])
def test_plot_time_varying_synergies_matches_jax(fs):
    rng = np.random.default_rng(11)
    res = types.SimpleNamespace(
        synergies={k: pd.DataFrame(rng.random((6, 5)), columns=MUSCLES) for k in range(3)},
        activations=pd.DataFrame(rng.random((40, 3)), index=np.linspace(0, 1, 40),
                                 columns=[f"synergy {k}" for k in range(3)]),
        vaf=0.8731)
    _same_figure(tviz.plot_time_varying_synergies(res, fs, show=False),
                 jviz.plot_time_varying_synergies(res, fs, show=False))
    arrays = types.SimpleNamespace(
        synergies={k: v.to_numpy() for k, v in res.synergies.items()},
        activations=res.activations.to_numpy(), vaf=res.vaf)
    got = tviz.plot_time_varying_synergies(arrays, fs, show=False,
                                           time=res.activations.index.to_numpy())
    # an array pattern has no muscle labels: seaborn's numbers there
    want = jviz.plot_time_varying_synergies(
        types.SimpleNamespace(synergies={k: pd.DataFrame(v) for k, v in
                                         arrays.synergies.items()},
                              activations=res.activations, vaf=res.vaf), fs, show=False)
    _same_figure(got, want)


@pytest.mark.parametrize("time_varying", [False, True])
def test_plot_synergy_clusters_matches_jax(time_varying):
    rng = np.random.default_rng(3)
    shape = (3, 4, 5) if time_varying else (3, 5)
    clusters = types.SimpleNamespace(
        consensus=rng.random(shape), membership=rng.integers(0, 3, (3, 2)),
        coverage=np.array([1.0, 0.5, 0.5]), shared=np.array([0]))
    for channels in (MUSCLES, None):
        _same_figure(tviz.plot_synergy_clusters(clusters, channels, ["p1", "p2"],
                                                show=False),
                     jviz.plot_synergy_clusters(clusters, channels, ["p1", "p2"],
                                                show=False))
    _same_figure(tviz.plot_synergy_clusters(clusters, show=False),
                 jviz.plot_synergy_clusters(clusters, show=False))


@pytest.mark.parametrize("fs", [None, 50])
def test_plot_space_by_time_matches_jax(fs):
    rng = np.random.default_rng(8)
    res = types.SimpleNamespace(
        temporal_modules=pd.DataFrame(rng.random((30, 3)),
                                      columns=[f"temporal {i}" for i in range(3)]),
        spatial_modules=pd.DataFrame(rng.random((2, 5)), columns=MUSCLES),
        coefficients=rng.random((4, 3, 2)), vaf=0.912)
    _same_figure(tviz.plot_space_by_time(res, fs, show=False),
                 jviz.plot_space_by_time(res, fs, show=False))


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    path = write_synthetic_capture(str(tmp_path_factory.mktemp("viz") / "c.csv"),
                                   state_len=200)
    return mst.load_vicon_file(path), mt.load_vicon_file(path)


@pytest.mark.parametrize("args,kwargs", [
    (("fp", "Fz"), dict(labels=["left", "right"])),
    (("fp", "Fx"), dict(device_inds=[1])),
    (("emg", "VL"), dict()),
])
def test_plot_cols_matches_jax(captures, args, kwargs):
    jdata, tdata = captures
    _same_figure(_figs(tdata.plot_cols(*args, show=False, **kwargs)),
                 _figs(jdata.plot_cols(*args, show=False, **kwargs)))


PLOTTER_CALLS = {
    "plot_reactions": ((), dict()),
    "plot_segment_og": (("swing",), dict(trecho=1, cycle=1, phase="BL",
                                        show_entire=False)),
    "plot_segment": ((1, 1, "BL"), dict(device_type="fp", col="Fz", show=False)),
    "plot_segment-device-first": (("force plate", "Fz"), dict(
        time=(2, 1), rectangle_label="cycle", show=False, show_entire=False,
        show_legend=True)),
    "plot_segment_grid": (("fp", "Fz"), dict(time=(1, 2, "DAA"), show_entire=False)),
    "plot_segment_grid-emg": (("emg", "GMED"), dict(time=2)),
}


@pytest.mark.parametrize("call", list(PLOTTER_CALLS))
def test_segment_plotter_matches_jax(captures, call):
    jdata, tdata = captures
    name = call.split("-")[0]
    args, kwargs = PLOTTER_CALLS[call]
    got = getattr(TPlotter(tdata), name)(*args, **kwargs)
    want = getattr(JPlotter(jdata), name)(*args, **kwargs)
    _same_figure(_figs(got), _figs(want))
