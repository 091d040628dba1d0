"""Command-line entry point: ``python -m muscle_synergies_tpu_torch``.

Port of :mod:`muscle_synergies_tpu.__main__` with its four subcommands,
flags, defaults, validation messages and report keys:

``describe``
    Parse a Vicon Nexus CSV export and print the capture summary
    (devices, shapes, sampling rates).

``analyze``
    Run the full pipeline on one capture (load, preprocess with the
    linear envelope or a moving RMS, time/amplitude normalization, VAF
    rank sweep, or time-varying synergies) and write a JSON report.

``analyze-dataset``
    The batched path over many captures: one rank sweep of every
    ``(rank, capture)`` pair, the pipelined load (``--prefetch``), the
    time-varying model or a shared-module model.

``export-transform``
    Serialize a saved model's ``transform`` with ``torch.export``.

Everything runs on the card unless ``--platform cpu`` is given; without
a card and without that flag the command exits and says so, rather
than running on the CPU.  ``--impl`` also takes the JAX package's
``xla``/``pallas``, which name the plain version and the kernels.  No
subcommand needs pandas: the captures are read as arrays
(``DeviceData.array`` and ``coords``) and the reports are built from
the solvers' arrays.  ``--plot`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cli_precision(args):
    """``--precision default`` -> None (full float32), else the name."""
    return None if args.precision == "default" else args.precision


def _parse_ranks(spec: str):
    """``"4"`` -> (4, None); ``"2:5"`` / ``"2-5"`` -> (2, 5).

    Raises ``argparse.ArgumentTypeError`` with the offending spec on
    anything else (empty bounds, non-integers, inverted ranges).
    """
    def _bad(why):
        raise argparse.ArgumentTypeError(
            f"invalid --ranks {spec!r}: {why} (expected e.g. '3' or '2:5')"
        )

    sep = ":" if ":" in spec else "-" if "-" in spec.strip("-") else None
    try:
        if sep:
            lo_s, hi_s = spec.split(sep, 1)
            lo, hi = int(lo_s), int(hi_s)
        else:
            lo, hi = int(spec), None
    except ValueError:
        _bad("not an integer or integer range")
    if lo < 1:
        _bad("ranks start at 1")
    if hi is not None and hi < lo:
        _bad("range upper bound below lower bound")
    return lo, hi


def _parse_modules(spec: str):
    """``"3:2"`` -> (3, 2): temporal x spatial module counts."""
    try:
        p_s, q_s = spec.split(":", 1)
        p, q = int(p_s), int(q_s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid --space-by-time {spec!r}: expected 'P:Q' module "
            "counts, e.g. '3:2'"
        )
    if p < 1 or q < 1:
        raise argparse.ArgumentTypeError(
            f"invalid --space-by-time {spec!r}: module counts start at 1"
        )
    return p, q


_IMPLS = ["auto", "xla", "pallas", "torch", "cuda"]


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m muscle_synergies_tpu_torch",
        description="muscle-synergy analysis on an NVIDIA card (PyTorch/CUDA)",
    )
    parser.add_argument(
        "--platform", choices=["cpu", "cuda"], default=None,
        help="where to compute: 'cuda' (the card, the default) or 'cpu' "
             "(the plain PyTorch versions)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_desc = sub.add_parser("describe", help="summarize a Vicon CSV export")
    p_desc.add_argument("csv", help="path to the Vicon Nexus CSV export")

    p_an = sub.add_parser("analyze", help="EMG -> synergies pipeline")
    p_an.add_argument("csv", help="path to the Vicon Nexus CSV export")
    p_an.add_argument(
        "--ranks", type=_parse_ranks, default=None,
        help="rank or range to sweep, e.g. '3' or '2:5' (default 1:4; "
             "--time-varying requires an explicit single value)",
    )
    p_an.add_argument(
        "--solver", choices=["cd", "mu"], default=None,
        help="NMF solver (default: cd, sklearn's default)",
    )
    p_an.add_argument(
        "--beta-loss", default="frobenius",
        help="frobenius | kullback-leibler | itakura-saito | float beta "
             "(non-Frobenius requires --solver mu)",
    )
    p_an.add_argument("--max-iter", type=int, default=100_000)
    p_an.add_argument("--tol", type=float, default=1e-6)
    p_an.add_argument(
        "--alpha-w", type=float, default=0.0,
        help="sklearn-scaled sparsity strength on W (default 0: none)",
    )
    p_an.add_argument(
        "--alpha-h", default="same",
        help="sparsity strength on H: a float, or 'same' as --alpha-w "
             "(default)",
    )
    p_an.add_argument(
        "--l1-ratio", type=float, default=0.0,
        help="L1/L2 mix for the sparsity penalties (0 = pure L2, "
             "1 = pure L1; default 0)",
    )
    p_an.add_argument(
        "--inner-iter", type=int, default=1,
        help="accelerated-MU inner repetitions per outer iteration "
             "(Frobenius MU only; 1 = sklearn-exact)",
    )
    p_an.add_argument(
        "--time-varying", type=int, metavar="LAGS", default=None,
        help="extract d'Avella-style time-varying synergies instead of "
             "time-invariant NMF: each synergy is a LAGS-sample "
             "spatiotemporal pattern (convolutive NMF; takes a single "
             "--ranks value)",
    )
    p_an.add_argument(
        "--n-inits", type=int, default=4,
        help="random restarts for --time-varying, batched into one "
             "device dispatch (default 4)",
    )
    p_an.add_argument(
        "--impl", choices=_IMPLS, default="auto",
        help="--time-varying solver implementation: auto (the "
             "convolutive kernel on the card), torch or cuda (the JAX "
             "names xla and pallas map onto these two)",
    )
    p_an.add_argument(
        "--precision", choices=["default", "highest"], default="default",
        help="matmul precision of the --time-varying plain contractions "
             "(both mean full float32 here; the kernel is float32 "
             "throughout)",
    )
    p_an.add_argument(
        "--rms", type=float, metavar="SECONDS", default=None,
        help="moving-RMS smoothing window instead of the filtered "
             "envelope (e.g. 0.5)",
    )
    p_an.add_argument(
        "--envelope-hz", type=float, default=4.0,
        help="low-pass cutoff for the linear envelope (default 4 Hz)",
    )
    p_an.add_argument(
        "--reduce-to", type=int, default=200,
        help="time-normalization length (default 200)",
    )
    p_an.add_argument(
        "--output", "-o", default=None,
        help="write the JSON report here (default: stdout)",
    )
    p_an.add_argument(
        "--components", action="store_true",
        help="include the synergy component matrices in the report",
    )
    p_an.add_argument(
        "--plot", metavar="DIR", default=None,
        help="save figures here: processed signals and one synergy "
             "heatmap per rank (PNG; needs matplotlib)",
    )
    p_an.add_argument(
        "--save-model", metavar="PATH", default=None,
        help="persist the fitted model as a pickle-free .npz: the "
             "whole run (VAF table + components + models, reload with "
             "models.load_synergy_run) for time-invariant NMF, or a "
             "CNMFModel (CNMFModel.load) for --time-varying",
    )

    p_ds = sub.add_parser(
        "analyze-dataset",
        help="batched EMG -> synergies across many captures (one device "
             "program for the whole trial x rank grid)",
    )
    p_ds.add_argument("csvs", nargs="+", help="Vicon Nexus CSV exports")
    p_ds.add_argument(
        "--ranks", type=_parse_ranks, default=None,
        help="rank or range to sweep (default 1:4; --time-varying "
             "requires an explicit single value)",
    )
    p_ds.add_argument(
        "--subjects", default=None,
        help="comma-separated subject label per capture (enables "
             "grouped reporting)",
    )
    p_ds.add_argument("--solver", choices=["cd", "mu"], default=None)
    p_ds.add_argument("--beta-loss", default="frobenius")
    p_ds.add_argument("--max-iter", type=int, default=10_000)
    p_ds.add_argument("--tol", type=float, default=1e-6)
    p_ds.add_argument(
        "--alpha-w", type=float, default=0.0,
        help="sklearn-scaled sparsity strength on W (default 0: none)",
    )
    p_ds.add_argument(
        "--alpha-h", default="same",
        help="sparsity strength on H: a float, or 'same' as --alpha-w "
             "(default)",
    )
    p_ds.add_argument(
        "--l1-ratio", type=float, default=0.0,
        help="L1/L2 mix for the sparsity penalties (0 = pure L2, "
             "1 = pure L1; default 0)",
    )
    p_ds.add_argument(
        "--rms", type=float, metavar="SECONDS", default=None,
        help="moving-RMS window instead of the filtered envelope",
    )
    p_ds.add_argument("--reduce-to", type=int, default=200)
    p_ds.add_argument(
        "--impl", choices=_IMPLS, default="auto",
        help="batched-solver implementation (default auto: the kernels "
             "on the card; torch or cuda, or the JAX names xla and "
             "pallas for them)",
    )
    p_ds.add_argument(
        "--precision", choices=["default", "highest"], default="default",
        help="matmul precision for the --time-varying/--space-by-time/"
             "--temporal-modules/--spatial-modules models' plain "
             "contractions (both mean full float32 here; the plain rank "
             "sweep runs the float32 kernels and rejects this flag)",
    )
    p_ds.add_argument(
        "--vaf-threshold", type=float, default=0.90,
        help="threshold for the minimum-rank report (default 0.90)",
    )
    p_ds.add_argument(
        "--prefetch", type=int, metavar="N", default=0,
        help="pipeline the load: a producer thread parses the next "
             "captures and stages them on the card (up to N chunks "
             "ahead, pinned memory and a side CUDA stream) while the "
             "current chunk preprocesses and fits (plain rank sweep "
             "only; 0 = off)",
    )
    p_ds.add_argument(
        "--chunk-files", type=int, metavar="K", default=2,
        help="captures per pipeline stage under --prefetch (default 2)",
    )
    p_ds.add_argument(
        "--time-varying", type=int, metavar="LAGS", default=None,
        help="extract time-varying (convolutive) synergies per capture "
             "instead of the NMF rank sweep; takes a single --ranks "
             "value (the synergy count)",
    )
    p_ds.add_argument(
        "--space-by-time", type=_parse_modules, metavar="P:Q",
        default=None,
        help="extract a Delis-style space-by-time decomposition of the "
             "whole dataset instead of the NMF rank sweep: P shared "
             "temporal modules x Q shared spatial modules with one "
             "coefficient matrix per capture (e.g. '3:2')",
    )
    p_ds.add_argument(
        "--temporal-modules", type=int, metavar="P", default=None,
        help="extract the shared-temporal model (Delis tMod) instead "
             "of the NMF rank sweep: P temporal modules shared by the "
             "whole dataset, one muscle-weight matrix per capture",
    )
    p_ds.add_argument(
        "--spatial-modules", type=int, metavar="Q", default=None,
        help="extract the shared-spatial model (Delis sMod) instead "
             "of the NMF rank sweep: Q spatial modules shared by the "
             "whole dataset, one activation train per capture",
    )
    p_ds.add_argument(
        "--n-inits", type=int, default=4,
        help="random restarts for the --time-varying/--space-by-time/"
             "--temporal-modules/--spatial-modules models (all "
             "restarts join one batched solve; default 4)",
    )
    p_ds.add_argument(
        "--cluster-subjects", type=int, metavar="RANK", default=None,
        help="after the rank sweep, cluster the per-subject averaged "
             "components at RANK across subjects (group-level "
             "shared-vs-specific synergies); requires --subjects with "
             "at least two distinct labels and RANK inside --ranks",
    )
    p_ds.add_argument(
        "--save-model", metavar="PATH", default=None,
        help="persist the fitted shared-module model as a pickle-free "
             ".npz NM3FModel (reload with NM3FModel.load); only the "
             "shared-module models have one servable artifact, so this "
             "requires --space-by-time, --temporal-modules or "
             "--spatial-modules",
    )
    p_ds.add_argument("--output", "-o", default=None)

    p_ex = sub.add_parser(
        "export-transform",
        help="serialize a saved model's transform with torch.export: "
             "serve it with torch alone, no framework code",
    )
    p_ex.add_argument(
        "model", help="a .npz written by --save-model / model.save()"
    )
    p_ex.add_argument(
        "--shape", required=True,
        help="input signature, comma-separated; non-integer entries "
             "declare symbolic dims (any size at call time), e.g. "
             "'200,8' or 'b,200,8'",
    )
    p_ex.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32",
        help="input dtype baked into the artifact (default float32)",
    )
    p_ex.add_argument(
        "--platforms", default="cpu,cuda",
        help="comma-separated targets, cpu and/or cuda (default "
             "cpu,cuda; cuda needs a card)",
    )
    p_ex.add_argument(
        "--rank", type=int, default=None,
        help="when the .npz holds a whole find_synergies run: which "
             "rank's model to export",
    )
    p_ex.add_argument(
        "--output", "-o", required=True,
        help="write the serialized artifact here",
    )
    return parser


def _emit(args, report) -> int:
    """Write the JSON report to ``--output`` or stdout."""
    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, or a clean exit."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("--plot needs matplotlib, which is not installed; "
                         "drop --plot")
    matplotlib.use("Agg")  # headless: files, not windows
    import matplotlib.pyplot as plt

    return plt


def _save_figure(plt, fig, directory: str, name: str) -> None:
    import os

    fig.savefig(os.path.join(directory, name), bbox_inches="tight")
    plt.close(fig)


def _cmd_export_transform(args) -> int:
    """``export-transform``: persisted npz -> ``torch.export`` artifact."""
    from collections.abc import Mapping

    import torch

    from muscle_synergies_tpu_torch.models.export import export_transform
    from muscle_synergies_tpu_torch.models.persist import (
        RUN_FORMAT,
        _load_run_models,
        load_model,
    )

    try:
        model = load_model(args.model, device=args.device)
    except ValueError as exc:
        if RUN_FORMAT not in str(exc):
            raise SystemExit(f"{args.model}: {exc}")
        model = _load_run_models(args.model, device=args.device)
        if isinstance(model, Mapping):
            if args.rank is None:
                raise SystemExit(
                    f"{args.model} holds a rank sweep over "
                    f"{sorted(model)}; pick one with --rank"
                )
            if args.rank not in model:
                raise SystemExit(
                    f"--rank {args.rank} not in the sweep {sorted(model)}"
                )
            model = model[args.rank]

    shape = tuple(
        int(d) if d.strip().lstrip("-").isdigit() else d.strip()
        for d in args.shape.split(",")
    )
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p)
    try:
        export_transform(model, shape, dtype=dtype, platforms=platforms,
                         path=args.output)
    except (TypeError, ValueError, RuntimeError) as exc:
        raise SystemExit(str(exc))
    print(f"exported {type(model).__name__}.transform to {args.output}")
    return 0


def _validate_time_varying_flags(args):
    """Reject flag combinations --time-varying cannot honor.

    Runs before any ingest or preprocessing, so a bad invocation fails
    in milliseconds; every time-invariant-only sibling flag is rejected
    loudly rather than silently ignored.
    """
    if args.ranks is None:
        raise SystemExit(
            "--time-varying requires an explicit --ranks K (the "
            "synergy count), e.g. --ranks 2"
        )
    lo, hi = args.ranks
    if hi is not None:
        raise SystemExit(
            "--time-varying takes a single --ranks value (the synergy "
            f"count), not the range {lo}:{hi}"
        )
    if args.solver is not None:
        raise SystemExit(
            "--time-varying has a single solver (convolutive MU); "
            "drop --solver"
        )
    if args.beta_loss != "frobenius":
        raise SystemExit(
            "--time-varying is Frobenius-only; drop --beta-loss"
        )
    if args.alpha_w != 0.0 or args.l1_ratio != 0.0:
        raise SystemExit(
            "--time-varying has no sparsity penalties; drop "
            "--alpha-w/--l1-ratio"
        )
    if getattr(args, "alpha_h", "same") != "same":
        raise SystemExit(
            "--time-varying has no sparsity penalties; drop --alpha-h"
        )
    if getattr(args, "inner_iter", 1) != 1:
        raise SystemExit(
            "--inner-iter applies to the Frobenius MU solver only; "
            "drop it for --time-varying"
        )
    if getattr(args, "vaf_threshold", 0.90) != 0.90:
        raise SystemExit(
            "--vaf-threshold belongs to the rank-sweep report; drop it "
            "for --time-varying"
        )
    return lo


def _load(path):
    """Load a capture, turning parse errors into clean CLI messages."""
    from muscle_synergies_tpu_torch.io import ViconCSVError, load_vicon_file

    try:
        return load_vicon_file(path)
    except FileNotFoundError:
        raise SystemExit(f"{path}: no such file")
    except ViconCSVError as exc:
        raise SystemExit(f"{path}: {exc}")


def _float_or_name(value: str):
    try:
        return float(value)
    except ValueError:
        return value


def _alpha_h(args):
    try:
        return float(args.alpha_h)
    except ValueError:
        if args.alpha_h != "same":
            raise SystemExit(
                f"invalid --alpha-h {args.alpha_h!r}: expected a float "
                "or 'same'"
            )
        return "same"


def _cmd_describe(args) -> int:
    data = _load(args.csv)
    print(data.describe())
    print(f"forces/EMG sampling rate: {data.sampling_frequency('emg')} Hz")
    if data.traj:  # marker-less (EMG/force-only) captures are valid
        print(f"trajectory sampling rate: {data.sampling_frequency('traj')} Hz")
    print(f"EMG samples: {data.emg.array.shape[0]}")
    return 0


def _preprocess(args, emg, fs):
    """``analyze``'s chain on one capture's EMG array where ``--platform``
    says: the envelope (or zero-centre and moving RMS), time
    normalization, amplitude normalization; returns the ``(N, L)``
    NumPy result and its time axis (the DataFrame index the JAX
    package's chain gives it)."""
    import numpy as np

    from muscle_synergies_tpu_torch._common import as_tensor, entry_placement, to_numpy
    from muscle_synergies_tpu_torch.ops import emg as ops

    device, dtype = entry_placement(args.device, None)
    x = as_tensor(np.asarray(emg, dtype=float), device, dtype)
    if args.rms is not None:
        proc = ops.moving_rms(ops.zero_center(x), window_size=args.rms,
                              sampling_frequency=fs)
    else:
        proc = ops.linear_envelope(x, critical_freqs=args.envelope_hz,
                                   sampling_frequency=fs, order=4).abs()
    index = np.arange(proc.shape[0])
    if args.reduce_to:
        proc = ops.time_normalize(proc, args.reduce_to)
        index = np.linspace(0, 1, args.reduce_to)
    return to_numpy(ops.normalize(proc).abs()).astype(float), index


def _smoothing(args):
    return ({"rms_window_s": args.rms} if args.rms is not None
            else {"envelope_lowpass_hz": args.envelope_hz})


def _cmd_analyze(args) -> int:
    import numpy as np

    from muscle_synergies_tpu_torch.models.persist import _save_run
    from muscle_synergies_tpu_torch.models.select import _find_synergies_arrays

    if args.time_varying is not None:
        _validate_time_varying_flags(args)
    elif args.ranks is None:
        args.ranks = (1, 4)
    plt = _pyplot() if args.plot else None
    data = _load(args.csv)
    muscles = list(data.emg.coords)
    fs = data.emg.sampling_frequency

    try:
        proc, index = _preprocess(args, data.emg.array, fs)
    except ValueError as exc:
        # e.g. a capture shorter than the filter's edge padding
        raise SystemExit(f"{args.csv}: {exc}")

    lo, hi = args.ranks
    if args.time_varying is not None:
        return _analyze_time_varying(args, proc, index, muscles, fs, plt)
    solver = args.solver if args.solver is not None else "cd"
    beta_loss = _float_or_name(args.beta_loss)
    alpha_h = _alpha_h(args)
    try:
        run = _find_synergies_arrays(
            proc, lo, hi, solver=solver, beta_loss=beta_loss,
            max_iter=args.max_iter, tol=args.tol,
            alpha_W=args.alpha_w, alpha_H=alpha_h,
            l1_ratio=args.l1_ratio, inner_iter=args.inner_iter,
            # a rank range solves as ONE zero-rank-padded batch (one
            # kernel launch on the card) instead of a loop over ranks
            sweep="batched" if hi is not None else "loop",
            device=args.device,
        )
    except ValueError as exc:
        # invalid parameter combinations (e.g. --solver cd with a
        # non-Frobenius --beta-loss) get the same clean exit as
        # missing/malformed capture files
        raise SystemExit(str(exc))

    report = {
        "file": args.csv,
        "sampling_frequency": float(fs),
        "muscles": muscles,
        "pipeline": {
            "smoothing": _smoothing(args),
            "reduce_to": args.reduce_to,
            "solver": solver,
            "beta_loss": args.beta_loss,
            "max_iter": args.max_iter,
            "tol": args.tol,
        },
        "ranks": {},
    }
    for row, k in zip(run.vaf_rows, run.ranks):
        entry = {
            "vaf_overall": float(row[0]),
            "vaf_per_muscle": {m: float(v) for m, v in zip(muscles, row[1:])},
            "n_iter": int(run.models[k].n_iter_),
            "reconstruction_err": float(run.models[k].reconstruction_err_),
        }
        if args.components:
            entry["components"] = np.asarray(run.components[k]).tolist()
        report["ranks"][str(k)] = entry

    if plt is not None:
        import os

        from muscle_synergies_tpu_torch.viz import plot_signal, synergy_heatmap

        os.makedirs(args.plot, exist_ok=True)
        _save_figure(plt, plot_signal(proc, title="processed EMG", show=False,
                                      columns=muscles, index=index),
                     args.plot, "processed_signals.png")
        for k in run.ranks:
            _save_figure(plt, synergy_heatmap(run.components[k], show=False,
                                              columns=muscles),
                         args.plot, f"synergies_rank{k}.png")
        print(f"figures in {args.plot}")

    if args.save_model:
        if hi is None:  # one run: one unlabeled VAF row
            saved = _save_run(run.vaf_rows, ["All signals"] + muscles, [0],
                              run.components[lo], muscles, run.models[lo],
                              args.save_model)
        else:
            saved = _save_run(run.vaf_rows, ["All signals"] + muscles, run.ranks,
                              run.components, {k: muscles for k in run.ranks},
                              run.models, args.save_model)
        print(f"model saved to {saved}")
    return _emit(args, report)


def _analyze_time_varying(args, proc, index, muscles, fs, plt) -> int:
    """``analyze --time-varying LAGS``: convolutive-NMF branch.

    The time-invariant flags that have no convolutive counterpart were
    rejected up front by :func:`_validate_time_varying_flags`.
    """
    from muscle_synergies_tpu_torch.models.cnmf import (
        CNMFModel,
        TimeVaryingSynergyResult,
        _fit_time_varying,
        _matrix,
    )

    lo = _validate_time_varying_flags(args)
    try:
        fit = _fit_time_varying(
            _matrix(proc, args.device, None), lo, args.time_varying,
            max_iter=args.max_iter, tol=args.tol, n_inits=args.n_inits, seed=0,
            impl=args.impl, precision=_cli_precision(args),
        )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "file": args.csv,
        "sampling_frequency": float(fs),
        "muscles": muscles,
        "pipeline": {
            "smoothing": _smoothing(args),
            "reduce_to": args.reduce_to,
            "model": "time-varying",
            "lags": args.time_varying,
            "n_inits": args.n_inits,
            "max_iter": args.max_iter,
            "tol": args.tol,
        },
        "rank": lo,
        "vaf_overall": float(fit.vaf),
        "vaf_per_muscle": {m: float(v) for m, v in zip(muscles, fit.vaf_per_muscle)},
        "n_iter": int(fit.n_iter),
        "restart_errors": [float(e) for e in fit.restart_errors],
    }
    if args.components:
        report["synergies"] = {str(k): fit.s[k].tolist() for k in range(lo)}

    if plt is not None:
        import os

        from muscle_synergies_tpu_torch.viz import (
            plot_signal,
            plot_time_varying_synergies,
        )

        os.makedirs(args.plot, exist_ok=True)
        _save_figure(plt, plot_signal(proc, title="processed EMG", show=False,
                                      columns=muscles, index=index),
                     args.plot, "processed_signals.png")
        res = TimeVaryingSynergyResult(
            synergies={k: fit.s[k] for k in range(lo)}, activations=fit.c,
            vaf=fit.vaf, vaf_per_muscle=fit.vaf_per_muscle, n_iter=fit.n_iter,
            restart_errors=fit.restart_errors)
        _save_figure(plt, plot_time_varying_synergies(res, sampling_frequency=None,
                                                      show=False, time=index),
                     args.plot, "time_varying_synergies.png")
        print(f"figures in {args.plot}")

    if args.save_model:
        model = CNMFModel(
            lo, args.time_varying, tol=args.tol, max_iter=args.max_iter,
            n_inits=args.n_inits, impl=args.impl, precision=_cli_precision(args),
            device=args.device,
        )
        model._set_fitted(fit.s, fit.n_iter, fit.restart_errors)
        print(f"model saved to {model.save(args.save_model)}")
    return _emit(args, report)


def _cmd_analyze_dataset(args) -> int:
    import numpy as np

    import muscle_synergies_tpu_torch as mst
    from muscle_synergies_tpu_torch.utils import PipelineConfig

    chosen = [
        name
        for name, value in (
            ("--time-varying", args.time_varying),
            ("--space-by-time", args.space_by_time),
            ("--temporal-modules", args.temporal_modules),
            ("--spatial-modules", args.spatial_modules),
        )
        if value is not None
    ]
    if len(chosen) > 1:
        raise SystemExit(
            " and ".join(chosen) + " are different models; pick one"
        )
    if args.time_varying is not None:
        _validate_time_varying_flags(args)
    elif args.space_by_time is not None:
        _validate_shared_model_flags(args, "--space-by-time")
    elif args.temporal_modules is not None:
        _validate_shared_model_flags(args, "--temporal-modules")
    elif args.spatial_modules is not None:
        _validate_shared_model_flags(args, "--spatial-modules")
    elif args.ranks is None:
        args.ranks = (1, 4)
    if args.save_model is not None \
            and args.space_by_time is None \
            and args.temporal_modules is None \
            and args.spatial_modules is None:
        raise SystemExit(
            "--save-model on analyze-dataset requires a shared-module "
            "model (--space-by-time, --temporal-modules or "
            "--spatial-modules); the rank-sweep and --time-varying "
            "results are per-trial — persist those from "
            "`analyze --save-model`"
        )
    solver = args.solver if args.solver is not None else "cd"
    subjects = None
    if args.subjects:  # validate the cheap flag before any ingest
        subjects = [s.strip() for s in args.subjects.split(",")]
        if len(subjects) != len(args.csvs):
            raise SystemExit(
                f"--subjects gives {len(subjects)} labels for "
                f"{len(args.csvs)} captures"
            )
    if args.cluster_subjects is not None:
        if chosen:
            raise SystemExit(
                "--cluster-subjects applies to the plain NMF rank "
                "sweep only"
            )
        if subjects is None or len(dict.fromkeys(subjects)) < 2:
            raise SystemExit(
                "--cluster-subjects requires --subjects with at least "
                "two distinct labels"
            )

    if args.prefetch < 0:
        raise SystemExit(f"--prefetch must be >= 0, got {args.prefetch}")
    if args.chunk_files < 1:
        raise SystemExit(
            f"--chunk-files must be >= 1, got {args.chunk_files}"
        )
    pipelined = args.prefetch > 0 and not chosen
    if args.prefetch > 0 and chosen:
        raise SystemExit(
            "--prefetch applies to the plain NMF rank sweep only"
        )
    if pipelined:
        # the pipelined loader parses inside the producer thread: the
        # per-file validation (existence, grammar, matching rates)
        # surfaces through analyze_dataset_pipelined instead
        trials = fs = None
    else:
        captures = [_load(p) for p in args.csvs]
        fs = captures[0].emg.sampling_frequency
        for path, cap in zip(args.csvs, captures):
            if cap.emg.sampling_frequency != fs:
                raise SystemExit(
                    f"{path}: EMG sampling rate "
                    f"{cap.emg.sampling_frequency} != {fs} of {args.csvs[0]}"
                )
        trials = [cap.emg for cap in captures]

    shared_model = (
        args.space_by_time is not None
        or args.temporal_modules is not None
        or args.spatial_modules is not None
    )
    if not shared_model:
        # the shared-module branches set module counts through their
        # own flags and reject --ranks up front
        lo, hi = args.ranks
        ranks = tuple(range(lo, (hi if hi is not None else lo) + 1))
        if (
            args.cluster_subjects is not None
            and args.cluster_subjects not in ranks
        ):
            raise SystemExit(
                f"--cluster-subjects {args.cluster_subjects} is outside "
                f"the swept ranks {list(ranks)}"
            )
    beta_loss = _float_or_name(args.beta_loss)
    alpha_h = _alpha_h(args)
    if not args.reduce_to:
        # analyze_dataset requires a common time base for the batch;
        # "skip" (0) cannot work across ragged captures
        raise SystemExit("--reduce-to must be a positive length")
    config = PipelineConfig(
        use_rms=args.rms is not None,
        rms_window_s=args.rms if args.rms is not None else 0.5,
        reduce_to=args.reduce_to,
    )
    if not chosen and args.precision != "default":
        raise SystemExit(
            "--precision applies to the convolutive/shared-factor "
            "models' plain contractions; the rank sweep runs the "
            "float32 kernels — drop it"
        )
    if args.time_varying is not None:
        return _analyze_dataset_time_varying(args, trials, fs, config, subjects)
    if args.space_by_time is not None:
        return _analyze_dataset_space_by_time(args, trials, fs, config, subjects)
    if args.temporal_modules is not None or args.spatial_modules is not None:
        return _analyze_dataset_shared_factor(args, trials, fs, config, subjects)
    kwargs = dict(
        ranks=ranks, config=config, solver=solver, beta_loss=beta_loss,
        max_iter=args.max_iter, tol=args.tol, impl=args.impl, subjects=subjects,
        alpha_W=args.alpha_w, alpha_H=alpha_h, l1_ratio=args.l1_ratio,
        device=args.device,
    )
    try:
        if pipelined:
            res = mst.analyze_dataset_pipelined(
                args.csvs, chunk_files=args.chunk_files, prefetch=args.prefetch,
                **kwargs,
            )
            fs = res.sampling_frequency
        else:
            res = mst.analyze_dataset(trials, fs, **kwargs)
    except FileNotFoundError as exc:
        raise SystemExit(f"{exc.filename or exc}: no such file")
    except mst.ViconCSVError as exc:
        raise SystemExit(str(exc))
    except ValueError as exc:
        raise SystemExit(str(exc))

    vaf = np.asarray(res.vaf_overall)  # (R, B)
    min_ranks = res.min_rank_reaching(args.vaf_threshold)
    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "ranks": list(ranks),
        # per-trial sections are lists aligned with "files" (paths may
        # legitimately repeat, so they cannot key a mapping)
        "vaf_overall": [
            {str(k): float(vaf[i, b]) for i, k in enumerate(ranks)}
            for b in range(len(args.csvs))
        ],
        "n_iter": np.asarray(res.n_iter).T.tolist(),  # [trial][rank]
        f"min_rank_reaching_{args.vaf_threshold:g}": [
            (int(r) if r > 0 else None) for r in np.asarray(min_ranks)
        ],
    }
    if subjects:
        report["subjects"] = subjects
        report["subject_mean_vaf"] = {
            subj: {str(k): float(v) for k, v in zip(ranks, means)}
            for subj, means in res._subject_vaf_means().items()
        }
    if args.cluster_subjects is not None:
        clusters = res.cluster_subjects(args.cluster_subjects)
        report["synergy_clusters"] = {
            "rank": args.cluster_subjects,
            "subjects": list(dict.fromkeys(subjects)),
            "n_clusters": clusters.n_clusters,
            "shared": [int(c) for c in clusters.shared],
            "coverage": [float(c) for c in clusters.coverage],
            # membership[cluster][subject]: component counts
            "membership": np.asarray(clusters.membership).tolist(),
            "consensus": np.asarray(clusters.consensus).tolist(),
        }
    return _emit(args, report)


def _validate_shared_model_flags(args, name):
    """Reject flags the shared-module models cannot honor (pre-ingest).

    Shared by ``--space-by-time``, ``--temporal-modules`` and
    ``--spatial-modules``: all three run the batched trilinear MU.
    """
    if args.ranks is not None:
        raise SystemExit(
            f"{name} sets the module count itself; drop --ranks"
        )
    if args.solver is not None:
        raise SystemExit(
            f"{name} has a single solver (trilinear MU); drop --solver"
        )
    if args.beta_loss != "frobenius":
        raise SystemExit(f"{name} is Frobenius-only; drop --beta-loss")
    if args.alpha_w != 0.0 or args.l1_ratio != 0.0 or args.alpha_h != "same":
        raise SystemExit(
            f"{name} has no sparsity penalties; drop "
            "--alpha-w/--alpha-h/--l1-ratio"
        )
    if args.impl != "auto":
        raise SystemExit(
            f"{name} runs the batched plain trilinear updates; drop --impl"
        )
    if args.vaf_threshold != 0.90:
        raise SystemExit(
            "--vaf-threshold belongs to the rank-sweep report; drop it "
            f"for {name}"
        )
    count = (
        args.temporal_modules
        if args.temporal_modules is not None
        else args.spatial_modules
    )
    if name != "--space-by-time" and count is not None and count < 1:
        raise SystemExit(f"{name} must be >= 1, got {count}")


def _analyze_dataset_space_by_time(args, trials, fs, config, subjects) -> int:
    """``analyze-dataset --space-by-time P:Q``: the NM3F branch."""
    import numpy as np

    import muscle_synergies_tpu_torch as mst

    p, q = args.space_by_time
    try:
        res = mst.analyze_dataset_space_by_time(
            trials, fs, n_temporal=p, n_spatial=q, config=config,
            max_iter=args.max_iter, tol=args.tol, n_inits=args.n_inits,
            subjects=subjects or None, precision=_cli_precision(args),
            device=args.device,
        )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "model": "space-by-time",
        "n_temporal": p,
        "n_spatial": q,
        "n_inits": args.n_inits,
        "vaf_overall": float(res.vaf_overall),
        "vaf_per_trial": [float(v) for v in res.vaf_per_trial],
        "vaf_per_muscle": np.asarray(res.vaf_per_channel).tolist(),
        "n_iter": int(res.n_iter),
        "restart_errors": [float(e) for e in res.restart_errors],
        "coefficients": np.asarray(res.coefficients).tolist(),
    }
    if subjects:
        report["subjects"] = subjects
    # the shared modules ARE the dataset-level result; always included
    report["temporal_modules"] = np.asarray(res.w).tolist()
    report["spatial_modules"] = {
        "columns": [str(c) for c in res.channel_names or range(res.s.shape[1])],
        "rows": np.asarray(res.s).tolist(),
    }

    if args.save_model:
        from muscle_synergies_tpu_torch.models import NM3FModel

        model = NM3FModel.from_result(
            res, tol=args.tol, max_iter=args.max_iter,
            n_inits=args.n_inits, precision=_cli_precision(args),
            device=args.device,
        )
        print(f"model saved to {model.save(args.save_model)}")
    return _emit(args, report)


def _analyze_dataset_shared_factor(args, trials, fs, config, subjects) -> int:
    """``--temporal-modules P`` / ``--spatial-modules Q``: tMod / sMod."""
    import numpy as np

    from muscle_synergies_tpu_torch.dataset import preprocess_trials
    from muscle_synergies_tpu_torch.models.nm3f import (
        NM3FModel,
        _fit_shared_spatial,
        _fit_temporal,
    )

    temporal = args.temporal_modules is not None
    k = args.temporal_modules if temporal else args.spatial_modules
    fit_args = (args.max_iter, args.tol, args.n_inits, 0, _cli_precision(args),
                args.device, None)
    try:
        xs = preprocess_trials(trials, fs, config, device=args.device)
        if temporal:
            res = _fit_temporal(xs, k, *fit_args)
        else:
            res, _ = _fit_shared_spatial(xs, k, *fit_args)
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "model": "temporal" if temporal else "shared-spatial",
        "n_modules": k,
        "n_inits": args.n_inits,
        "vaf_overall": float(res.vaf),
        "vaf_per_trial": [float(v) for v in res.vaf_per_trial],
        "n_iter": int(res.n_iter),
        "restart_errors": [float(e) for e in res.restart_errors],
    }
    if subjects:
        report["subjects"] = subjects
    names = [str(c) for c in trials[0].coords]
    if temporal:
        report["temporal_modules"] = np.asarray(res.temporal_modules).tolist()
        report["weights"] = {
            "columns": names,
            "per_capture": np.asarray(res.weights).tolist(),
        }
    else:
        report["spatial_modules"] = {
            "columns": names,
            "rows": np.asarray(res.spatial_modules).tolist(),
        }
        report["activations"] = np.asarray(res.activations).tolist()

    if args.save_model:
        kwargs = dict(
            tol=args.tol, max_iter=args.max_iter, n_inits=args.n_inits,
            precision=_cli_precision(args), device=args.device,
        )
        model = (
            NM3FModel.from_temporal_result(res, **kwargs)
            if temporal
            else NM3FModel.from_shared_spatial_result(res, **kwargs)
        )
        print(f"model saved to {model.save(args.save_model)}")
    return _emit(args, report)


def _analyze_dataset_time_varying(args, trials, fs, config, subjects) -> int:
    """``analyze-dataset --time-varying LAGS``: the convolutive branch."""
    import numpy as np

    import muscle_synergies_tpu_torch as mst

    lo = _validate_time_varying_flags(args)
    try:
        res = mst.analyze_dataset_time_varying(
            trials, fs, n_synergies=lo, n_lags=args.time_varying,
            config=config, max_iter=args.max_iter, tol=args.tol,
            n_inits=args.n_inits, subjects=subjects, impl=args.impl,
            precision=_cli_precision(args), device=args.device,
        )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "model": "time-varying",
        "lags": args.time_varying,
        "n_inits": args.n_inits,
        "rank": lo,
        "vaf_overall": [float(v) for v in res.vaf_overall],
        "vaf_per_muscle": np.asarray(res.vaf_per_channel).tolist(),
        "n_iter": [int(n) for n in res.n_iter],
        "restart_errors": np.asarray(res.restart_errors).tolist(),
    }
    if subjects:
        report["subjects"] = subjects
        report["subject_mean_vaf"] = {
            str(s): float(m)
            for s, m in res._subject_vaf_means().items()
        }
    return _emit(args, report)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    args.device = args.platform or "cuda"
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "no CUDA device: this command runs on the card by default; "
                "pass --platform cpu to run the plain versions on the CPU"
            )
    if args.command == "describe":
        return _cmd_describe(args)
    if args.command == "analyze-dataset":
        return _cmd_analyze_dataset(args)
    if args.command == "export-transform":
        return _cmd_export_transform(args)
    return _cmd_analyze(args)


if __name__ == "__main__":
    sys.exit(main())
