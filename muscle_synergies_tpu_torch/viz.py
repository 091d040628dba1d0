"""Plotting helpers mirroring the reference's visual API.

Port of :mod:`muscle_synergies_tpu.viz`, on matplotlib alone (imported
when a function runs): the JAX package draws its heatmaps with
``seaborn.heatmap``; :func:`_heatmap` draws the same mesh values, tick
positions and labels, axis labels, annotations and colorbar with
``pcolormesh``.  Every function takes what the JAX one takes (a
DataFrame where it takes one, which needs pandas only to be made), and
also plain arrays or tensors, with ``columns=`` (and ``index=``) for
the labels, so that no pandas is needed:

- :func:`plot_signal`     <- reference analysis.py:33-107
- :func:`synergy_heatmap` <- reference analysis.py:110-139
- :func:`plot_fft`        <- reference analysis.py:142-162
- :func:`plot_time_varying_synergies`, :func:`plot_synergy_clusters`,
  :func:`plot_space_by_time`: the JAX package's companions for the
  convolutive, group-level and space-by-time results.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ._common import to_numpy

__all__ = [
    "plot_signal",
    "synergy_heatmap",
    "plot_fft",
    "plot_time_varying_synergies",
    "plot_synergy_clusters",
    "plot_space_by_time",
]


def _labels(frame, axis: int, given=None):
    """Tick labels of a DataFrame's columns (axis 1) or index (axis 0),
    ``given`` ones for an array, else ``0..n-1`` (what seaborn gives an
    array)."""
    if given is not None:
        return list(given)
    names = getattr(frame, "columns" if axis else "index", None)
    if names is not None:
        return list(names)
    return list(range(np.shape(frame)[axis]))


def _axis_name(frame, axis: int) -> str:
    names = getattr(frame, "columns" if axis else "index", None)
    name = getattr(names, "name", None)
    return "" if name is None else name


def _skip_ticks(labels, every: int):
    n = len(labels)
    if every == 1:
        return np.arange(n) + 0.5, list(labels)
    return np.arange(0, n, every) + 0.5, list(labels)[::every]


def _auto_ticks(ax, labels, axis: int):
    """seaborn's ``"auto"`` ticks: as many labels as the axes' length
    holds at the tick font size, evenly thinned."""
    bbox = ax.get_window_extent().transformed(ax.figure.dpi_scale_trans.inverted())
    size = [bbox.width, bbox.height][axis]
    tick, = [ax.xaxis, ax.yaxis][axis].set_ticks([0])
    max_ticks = int(size // (tick.label1.get_size() / 72))
    if max_ticks < 1:
        return [], []
    return _skip_ticks(labels, len(labels) // max_ticks + 1)


def _luminance(rgba) -> float:
    rgb = np.asarray(rgba, dtype=float)[:3]
    rgb = np.where(rgb <= 0.03928, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return float(rgb.dot([0.2126, 0.7152, 0.0722]))


def _ticks(ax, spec, labels, axis: int):
    if spec is False:
        return [], []
    if isinstance(spec, str) and spec == "auto":
        return _auto_ticks(ax, labels, axis)
    return _skip_ticks(list(spec) if spec is not True else labels, 1)


def _heatmap(ax, data, *, xticklabels="auto", yticklabels="auto", annot=False,
             fmt=".2g", cbar=True, columns: Optional[Sequence] = None):
    """``seaborn.heatmap`` on matplotlib alone: one ``pcolormesh`` cell
    per entry over ``[0, n]`` with the y axis inverted, ticks at the
    cell centres (``"auto"`` thins them to fit, ``True`` keeps all,
    ``False`` none, a list gives them), the DataFrame's axis names as
    axis labels, each value written in its cell (dark on light cells,
    white on dark) and a colorbar beside the axes.  ``columns`` labels
    an array's columns (a DataFrame's own are used otherwise)."""
    import matplotlib.pyplot as plt

    values = to_numpy(data)
    rows, cols = values.shape
    for side in ("top", "right", "left", "bottom"):
        ax.spines[side].set_visible(False)
    finite = values.astype(float)
    mesh = ax.pcolormesh(values, cmap="magma", vmin=np.nanmin(finite),
                         vmax=np.nanmax(finite))
    ax.set(xlim=(0, cols), ylim=(0, rows))
    ax.invert_yaxis()
    if cbar:
        ax.figure.colorbar(mesh, ax=ax).outline.set_linewidth(0)
    xticks, xlabels = _ticks(ax, xticklabels, _labels(data, 1, columns), 0)
    yticks, ylabels = _ticks(ax, yticklabels, _labels(data, 0), 1)
    ax.set(xticks=xticks, yticks=yticks)
    xtl = ax.set_xticklabels(xlabels)
    ytl = ax.set_yticklabels(ylabels, rotation="vertical")
    plt.setp(ytl, va="center")
    ax.figure.canvas.draw()
    for labels, rotation in ((xtl, "vertical"), (ytl, "horizontal")):
        boxes = [t.get_window_extent() for t in labels]
        if boxes and max(b.count_overlaps(boxes) for b in boxes) > 1:
            plt.setp(labels, rotation=rotation)
    ax.set(xlabel=_axis_name(data, 1), ylabel=_axis_name(data, 0))
    if annot:
        mesh.update_scalarmappable()
        colors = mesh.get_facecolors()
        for i, (val, rgba) in enumerate(zip(values.flat, colors)):
            ax.text(i % cols + 0.5, i // cols + 0.5, format(val, fmt), ha="center",
                    va="center", color=".15" if _luminance(rgba) > 0.408 else "w")
    return mesh


def plot_signal(
    signal_df,
    *,
    title: str = "",
    plot_dims: Optional[Tuple[int, int]] = None,
    xlabel: str = "time (s)",
    ylabel: str = "V",
    xticks_off: bool = False,
    figsize: Tuple[int, int] = (18, 10),
    suptitle_fontsize: int = 20,
    show: bool = True,
    columns: Optional[Sequence] = None,
    index=None,
    **plot_kwargs,
):
    """Plot each column of ``signal_df`` as its own subplot.

    ``signal_df`` is a DataFrame (each column against its index), or an
    ``(N, L)`` array or tensor with ``columns=`` labels (default
    ``0..L-1``) and ``index=`` x values (default ``0..N-1``).
    ``plot_dims`` sets the subplot grid (defaults to one column);
    ``show=True`` displays the figure and returns ``None``, otherwise
    the figure is returned for further customization.
    """
    import matplotlib.pyplot as plt

    values = to_numpy(signal_df)
    names = _labels(signal_df, 1, columns)
    x = np.asarray(index if index is not None
                   else getattr(signal_df, "index", np.arange(values.shape[0])))
    if plot_dims is None:
        plot_dims = values.shape[1], 1
    if len(names) != int(np.prod(plot_dims)):
        raise ValueError(f"plot_dims {plot_dims} does not match {len(names)} columns")
    fig, axs = plt.subplots(plot_dims[0], plot_dims[1], figsize=figsize, squeeze=False)
    for j, (ax, col) in enumerate(zip(axs.flat, names)):
        ax.plot(x, values[:, j], label=col, **plot_kwargs)
        ax.set_title(col)
        if xticks_off:
            ax.set_xticks([])
        ax.set(xlabel=xlabel)
    fig.suptitle(title, fontsize=suptitle_fontsize)
    for row in range(min(2, axs.shape[0])):
        axs[row, 0].set_ylabel(ylabel)

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def synergy_heatmap(
    components,
    synergy_names: Optional[Sequence[str]] = None,
    show: bool = True,
    *,
    columns: Optional[Sequence] = None,
):
    """Annotated heatmap of synergy components (one synergy per row):
    a DataFrame, or an array with ``columns=`` muscle labels."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    if synergy_names is None:
        synergy_names = [f"synergy {i}" for i in range(1, len(components) + 1)]
    _heatmap(ax, components, annot=True, fmt=".2f", yticklabels=synergy_names,
             columns=columns)
    ax.set_title("Heatmap of muscle synergies")

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def plot_fft(
    signal_df,
    sampling_frequency: int,
    xlabel: str = "frequency",
    device="cuda",
    **kwargs,
):
    """Plot the positive-frequency amplitude spectrum of each column
    (computed on ``device``, the card by default); arrays take
    ``columns=`` as in :func:`plot_signal`."""
    from .ops import emg as _emg

    columns = kwargs.pop("columns", None)
    freqs, ampl = _emg.fft_spectrum(to_numpy(signal_df), sampling_frequency,
                                    device=device)
    return plot_signal(to_numpy(ampl), xlabel=xlabel, index=freqs,
                       columns=_labels(signal_df, 1, columns), **kwargs)


def plot_time_varying_synergies(
    result,
    sampling_frequency: Optional[int] = None,
    show: bool = True,
    *,
    time=None,
):
    """Visualize a :class:`~.models.cnmf.TimeVaryingSynergyResult`.

    The left column shows each synergy's spatiotemporal pattern (lags x
    muscles heatmap), the right column its activation train over the
    trial.  ``result.synergies`` maps each synergy to a ``(D, L)``
    DataFrame or array, ``result.activations`` is a ``(T, K)``
    DataFrame (its index is the time axis) or array (``time=`` gives
    its time axis, ``0..T-1`` by default).

    Args:
        result: output of ``find_time_varying_synergies``.
        sampling_frequency: when given, lag and time axes are labeled
            in seconds instead of samples.
        show: as in :func:`plot_signal`: show and return None, or
            return the figure for saving/testing.
    """
    import matplotlib.pyplot as plt

    k = len(result.synergies)
    fig, axes = plt.subplots(k, 2, figsize=(10, 2.4 * k), squeeze=False,
                             gridspec_kw={"width_ratios": [1, 2]})
    activations = result.activations
    acts = to_numpy(activations)
    if time is None:
        time = getattr(activations, "index", np.arange(acts.shape[0]))
    time = np.asarray(time, dtype=float)
    if sampling_frequency:
        time = time / sampling_frequency
    for ki in range(k):
        pattern = result.synergies[ki]
        _heatmap(axes[ki][0], pattern.T, cbar=False, xticklabels=False)
        axes[ki][0].set_ylabel(f"synergy {ki}")
        axes[ki][0].set_xlabel("lag (s)" if sampling_frequency else "lag (samples)")
        axes[ki][1].plot(time, acts[:, ki])
        axes[ki][1].set_xlabel("time (s)" if sampling_frequency else "time (samples)")
        axes[ki][1].set_ylabel("activation")
    fig.suptitle(f"Time-varying synergies (VAF {result.vaf:.3f})")
    fig.tight_layout()

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def plot_synergy_clusters(
    clusters,
    channel_names: Optional[Sequence] = None,
    set_names: Optional[Sequence] = None,
    show: bool = True,
):
    """Visualize a :class:`~.models.stability.SynergyClusters`.

    The left side shows each cluster's unit-norm consensus synergy (a
    channel heatmap for spatial sets, one lags x muscles heatmap per
    cluster for time-varying sets), the right side the clusters x sets
    membership counts with each cluster's coverage: shared synergies
    read as fully filled rows.

    Args:
        clusters: output of ``cluster_synergies`` (or
            ``DatasetResult.cluster_subjects``).
        channel_names: muscle labels for the consensus heatmap columns.
        set_names: labels of the input sets (e.g. subject ids) for the
            membership columns.
        show: as in :func:`plot_signal`.
    """
    import matplotlib.pyplot as plt

    consensus = to_numpy(clusters.consensus)
    membership = to_numpy(clusters.membership)
    k, n_sets = membership.shape
    if set_names is None:
        set_names = [f"set{j}" for j in range(n_sets)]
    row_labels = [f"c{i} ({cov * 100:.0f}%)" for i, cov in enumerate(clusters.coverage)]
    channels = list(channel_names) if channel_names is not None else "auto"

    if consensus.ndim == 2:
        fig, axes = plt.subplots(1, 2, figsize=(11, max(0.6 * k + 1.8, 3)),
                                 gridspec_kw={"width_ratios": [1.6, 1]})
        _heatmap(axes[0], consensus, annot=True, fmt=".2f", xticklabels=channels,
                 yticklabels=row_labels)
        axes[0].set_title("consensus synergies")
        member_ax = axes[1]
    else:
        fig = plt.figure(figsize=(11, max(2.2 * k, 3)))
        gs = fig.add_gridspec(k, 2, width_ratios=[1.6, 1])
        for i in range(k):
            ax = fig.add_subplot(gs[i, 0])
            _heatmap(ax, consensus[i].T, cbar=False, xticklabels=False,
                     yticklabels=channels)
            ax.set_ylabel(row_labels[i])
            ax.set_xlabel("lag (samples)" if i == k - 1 else "")
        member_ax = fig.add_subplot(gs[:, 1])

    _heatmap(member_ax, membership, annot=True, fmt="d", xticklabels=list(set_names),
             yticklabels=row_labels, cbar=False)
    member_ax.set_title("membership (components per set)")

    fig.suptitle(f"Synergy clusters: {len(clusters.shared)}/{k} shared across all "
                 f"{n_sets} sets")
    fig.tight_layout()

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def plot_space_by_time(
    result,
    sampling_frequency: Optional[int] = None,
    show: bool = True,
):
    """Visualize a :class:`~.models.nm3f.SpaceByTimeResult`.

    Three panels: the shared temporal modules as line plots, the shared
    spatial modules as a muscle heatmap, and the dataset-mean mixing
    coefficients (temporal x spatial).  The modules are DataFrames (as
    ``find_space_by_time_synergies`` gives them) or arrays.

    Args:
        result: output of ``find_space_by_time_synergies``.
        sampling_frequency: when given, the time axis is labeled in
            seconds instead of samples.
        show: as in :func:`plot_signal`.
    """
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.2))
    temporal = result.temporal_modules
    values = to_numpy(temporal)
    time = np.arange(len(values), dtype=float)
    if sampling_frequency:
        time = time / sampling_frequency
    names = _labels(temporal, 1, None if hasattr(temporal, "columns") else
                    [f"temporal {i}" for i in range(values.shape[1])])
    for j, name in enumerate(names):
        axes[0].plot(time, values[:, j], label=name)
    axes[0].legend(fontsize="small")
    axes[0].set_xlabel("time (s)" if sampling_frequency else "time (samples)")
    axes[0].set_title("temporal modules")

    _heatmap(axes[1], result.spatial_modules, annot=True, fmt=".2f")
    axes[1].set_ylabel("spatial module")
    axes[1].set_title("spatial modules")

    mean_a = to_numpy(result.coefficients).mean(axis=0)
    _heatmap(axes[2], mean_a, annot=True, fmt=".2f",
             xticklabels=[f"s{j}" for j in range(mean_a.shape[1])],
             yticklabels=[f"t{i}" for i in range(mean_a.shape[0])])
    axes[2].set_title("mean coefficients")

    fig.suptitle(f"Space-by-time decomposition (VAF {result.vaf:.3f})")
    fig.tight_layout()

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig
