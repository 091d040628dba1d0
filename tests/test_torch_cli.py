"""PyTorch port: ``python -m muscle_synergies_tpu_torch`` against the JAX CLI.

Both packages' ``main(argv)`` run in this process on the same small
captures (``testing.write_synthetic_capture``, ``state_len=300,
n_trechos=2``, and one of ``state_len=320`` for a ragged dataset), the
port with ``--platform cpu`` (float64 there, as the JAX package under
the test configuration's x64).  Reports: every key equal, VAF within
1e-8, every other number within 1e-6, iteration counts equal; one
documented exception, the CD fits at rank 1, whose NNDSVD start is
already optimal so that their stopping iteration is rounding noise
(``tests/test_torch_dataset.py``): their ``n_iter`` is not compared.
Every ``SystemExit`` of ``tests/test_cli.py`` gives the port the same
code and message, but for two messages that name the JAX package's
XLA/Pallas routes (the same rule, the same last words).  ``describe``,
``analyze`` and ``analyze-dataset`` run with pandas and matplotlib
blocked; ``--plot`` writes the JAX CLI's file names; a saved run and an
exported transform round-trip.
"""

import argparse
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu import __main__ as jcli  # noqa: E402
from muscle_synergies_tpu.testing import write_synthetic_capture  # noqa: E402
from muscle_synergies_tpu_torch import __main__ as tcli  # noqa: E402


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    a = write_synthetic_capture(str(root / "a.csv"), state_len=300, n_trechos=2)
    b = write_synthetic_capture(str(root / "b.csv"), state_len=320, n_trechos=2,
                                seed=7)
    return a, b


def _run(cli, argv, out):
    """``main(argv + -o out)`` of one package; the report it wrote."""
    port = ["--platform", "cpu"] if cli is tcli else []
    assert cli.main(port + argv + ["-o", str(out)]) == 0
    return json.loads(out.read_text())


def _close(got, want, path, exempt):
    if path in exempt:
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _close(got[key], want[key], f"{path}/{key}", exempt)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}/{i}", exempt)
    elif isinstance(want, float):
        atol = 1e-8 if "vaf" in path else 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-6 * (atol > 1e-8), atol=atol,
                                   err_msg=path)
    else:  # ints (iterations, ranks, counts), strings, bools, None
        assert got == want and type(got) is type(want), (path, got, want)


def _rank1_cd_exempt(argv, report):
    """Paths of the CD fits at rank 1 in a report (module docstring)."""
    if "mu" in argv or "--time-varying" in argv or "ranks" not in report:
        return set()
    if argv[0] == "analyze":
        return {"/ranks/1/n_iter"} if "1" in report["ranks"] else set()
    if 1 not in report["ranks"]:
        return set()
    i = report["ranks"].index(1)
    return {f"/n_iter/{b}/{i}" for b in range(len(report["files"]))}


CASES = {
    "analyze-sweep-rms": ["analyze", "A", "--ranks", "2:3", "--rms", "0.5",
                          "--max-iter", "500", "--tol", "1e-5", "--components"],
    "analyze-envelope-cd": ["analyze", "A", "--ranks", "1:3", "--max-iter", "300",
                            "--tol", "1e-5", "--components"],
    "analyze-single-mu": ["analyze", "A", "--ranks", "2", "--rms", "0.5",
                          "--max-iter", "200", "--tol", "1e-4", "--solver", "mu"],
    "analyze-kl": ["analyze", "A", "--ranks", "2:3", "--rms", "0.5", "--max-iter",
                   "200", "--tol", "1e-4", "--solver", "mu", "--beta-loss",
                   "kullback-leibler"],
    "analyze-time-varying": ["analyze", "A", "--ranks", "2", "--rms", "0.5",
                             "--time-varying", "8", "--n-inits", "2",
                             "--max-iter", "300", "--tol", "1e-4", "--components"],
    "dataset-subjects": ["analyze-dataset", "A", "A", "--ranks", "1:2", "--rms",
                         "0.5", "--max-iter", "300", "--tol", "1e-5",
                         "--subjects", "s1,s2"],
    "dataset-cluster": ["analyze-dataset", "A", "B", "--ranks", "1:2", "--rms", "0.5",
                        "--max-iter", "300", "--tol", "1e-5", "--subjects", "s1,s2",
                        "--cluster-subjects", "2"],
    "dataset-ragged-envelope": ["analyze-dataset", "A", "B", "A", "--ranks", "2:3",
                                "--max-iter", "300", "--tol", "1e-5"],
    "dataset-prefetch": ["analyze-dataset", "A", "A", "B", "--ranks", "1:2", "--rms",
                         "0.5", "--max-iter", "300", "--tol", "1e-5", "--prefetch",
                         "2", "--chunk-files", "2", "--subjects", "s1,s1,s2"],
    "dataset-sparse-mu": ["analyze-dataset", "A", "--ranks", "2", "--rms", "0.5",
                          "--max-iter", "300", "--tol", "1e-5", "--solver", "mu",
                          "--alpha-w", "0.1", "--l1-ratio", "1.0"],
    "dataset-time-varying": ["analyze-dataset", "A", "B", "--ranks", "2",
                             "--time-varying", "8", "--n-inits", "2", "--rms",
                             "0.5", "--max-iter", "200", "--tol", "1e-4",
                             "--subjects", "s1,s1"],
    "dataset-space-by-time": ["analyze-dataset", "A", "B", "--space-by-time", "3:2",
                              "--n-inits", "2", "--rms", "0.5", "--max-iter", "200",
                              "--tol", "1e-4", "--subjects", "s1,s1"],
    "dataset-temporal": ["analyze-dataset", "A", "B", "--temporal-modules", "3",
                         "--n-inits", "2", "--rms", "0.5", "--max-iter", "150",
                         "--tol", "1e-4"],
    "dataset-spatial": ["analyze-dataset", "A", "B", "--spatial-modules", "2",
                        "--n-inits", "2", "--rms", "0.5", "--max-iter", "150",
                        "--tol", "1e-4"],
}


def _argv(case, caps):
    return [{"A": caps[0], "B": caps[1]}.get(a, a) for a in CASES[case]]


@pytest.mark.parametrize("case", list(CASES))
def test_reports_match_the_jax_cli(case, caps, tmp_path):
    argv = _argv(case, caps)
    want = _run(jcli, argv, tmp_path / "jax.json")
    got = _run(tcli, argv, tmp_path / "torch.json")
    _close(got, want, "", _rank1_cd_exempt(argv, want))


# every SystemExit of tests/test_cli.py: argv, and True where the message
# names the JAX package's XLA/Pallas route (then only its last words match)
ERRORS = [
    (["analyze", "A", "--ranks", "-3"], False),
    (["analyze", "A", "--ranks", ":4"], False),
    (["analyze", "A", "--ranks", "5:2"], False),
    (["analyze", "A", "--ranks", "abc"], False),
    (["analyze", "A", "--ranks", "0"], False),
    (["describe", "BAD"], False),
    (["analyze", "MISSING", "--ranks", "2"], False),
    (["analyze-dataset", "A", "A", "--ranks", "2", "--rms", "0.5",
      "--cluster-subjects", "2"], False),
    (["analyze-dataset", "A", "A", "--ranks", "2", "--rms", "0.5", "--subjects",
      "a,a", "--cluster-subjects", "2"], False),
    (["analyze-dataset", "A", "A", "--ranks", "1:2", "--rms", "0.5", "--subjects",
      "a,b", "--cluster-subjects", "3"], False),
    (["analyze-dataset", "A", "A", "--space-by-time", "2:2", "--rms", "0.5",
      "--subjects", "a,b", "--cluster-subjects", "2"], False),
    (["analyze-dataset", "A", "--subjects", "a,b", "--ranks", "1", "--rms", "0.5",
      "--max-iter", "50"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8", "--ranks", "2:3"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8", "--ranks", "2",
      "--beta-loss", "kullback-leibler"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8", "--ranks", "2",
      "--alpha-w", "0.1"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8", "--ranks", "2",
      "--alpha-h", "0.3"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8", "--ranks", "2",
      "--solver", "mu"], False),
    (["analyze", "A", "--rms", "0.5", "--time-varying", "8", "--ranks", "2",
      "--inner-iter", "3"], False),
    (["analyze-dataset", "A", "--ranks", "2:3", "--time-varying", "8"], False),
    (["analyze-dataset", "A", "--space-by-time", "3:2", "--time-varying", "8",
      "--ranks", "2"], False),
    (["analyze-dataset", "A", "--space-by-time", "3:2", "--ranks", "2"], False),
    (["analyze-dataset", "A", "--space-by-time", "nope"], False),
    (["analyze-dataset", "A", "--ranks", "1", "--rms", "0.5", "--max-iter", "50",
      "--alpha-h", "bogus"], False),
    (["analyze-dataset", "A", "--temporal-modules", "3", "--spatial-modules", "2"],
     False),
    (["analyze-dataset", "A", "--spatial-modules", "2", "--ranks", "2"], False),
    (["analyze-dataset", "A", "--temporal-modules", "0"], False),
    (["analyze-dataset", "A", "--temporal-modules", "2", "--impl", "xla"], True),
    (["analyze-dataset", "A", "--prefetch", "2", "--space-by-time", "2:2", "--rms",
      "0.5"], False),
    (["analyze-dataset", "A", "--prefetch", "2", "--chunk-files", "0", "--rms",
      "0.5"], False),
    (["analyze-dataset", "A", "--prefetch", "-1"], False),
    (["analyze-dataset", "A", "MISSING", "--prefetch", "1", "--ranks", "1", "--rms",
      "0.5"], False),
    (["analyze-dataset", "A", "--ranks", "2", "--rms", "0.5", "--precision",
      "highest"], True),
    (["analyze-dataset", "A", "--ranks", "2", "--precision", "sloppy"], False),
    (["analyze-dataset", "A", "--ranks", "2", "--reduce-to", "0"], False),
    (["analyze-dataset", "A", "--ranks", "2", "--save-model", "NOPE"], False),
]


def _exit(cli, argv, capsys):
    port = ["--platform", "cpu"] if cli is tcli else []
    with pytest.raises(SystemExit) as info:
        cli.main(port + argv)
    return info.value.code, capsys.readouterr().err


@pytest.mark.parametrize("argv,names_route", ERRORS,
                         ids=[" ".join(a).replace("/", "") for a, _ in ERRORS])
def test_system_exits_match_the_jax_cli(argv, names_route, caps, tmp_path, capsys):
    bad = tmp_path / "bad.csv"
    bad.write_text("NotDevices\n300\n")
    paths = {"A": caps[0], "BAD": str(bad), "MISSING": str(tmp_path / "missing.csv"),
             "NOPE": str(tmp_path / "nope")}
    argv = [paths.get(a, a) for a in argv]
    (jcode, jerr), (tcode, terr) = _exit(jcli, argv, capsys), _exit(tcli, argv, capsys)
    if jcode == 2:  # argparse: usage and the same error line
        assert tcode == 2
        assert terr.splitlines()[-1].split(": ", 1)[1] == \
            jerr.splitlines()[-1].split(": ", 1)[1]
    elif names_route:
        assert isinstance(tcode, str) and tcode.split()[-2:] == jcode.split()[-2:], \
            (tcode, jcode)
    else:
        assert tcode == jcode


def test_no_card_and_no_platform_names_platform_cpu(caps):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    for argv in (["describe", caps[0]], ["analyze", caps[0], "--ranks", "2"]):
        with pytest.raises(SystemExit) as info:
            tcli.main(argv)
        assert "--platform cpu" in str(info.value.code)


@pytest.fixture
def no_pandas_or_matplotlib(monkeypatch):
    for name in ("pandas", "matplotlib", "seaborn"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("argv", [
    ["describe", "A"],
    ["analyze", "A", "--ranks", "1:3", "--max-iter", "200", "--components"],
    ["analyze", "A", "--ranks", "2", "--time-varying", "6", "--n-inits", "2",
     "--max-iter", "50", "--components"],
    ["analyze-dataset", "A", "B", "--ranks", "1:2", "--max-iter", "200",
     "--subjects", "s1,s2", "--cluster-subjects", "2"],
    ["analyze-dataset", "A", "B", "--ranks", "1:2", "--max-iter", "200",
     "--prefetch", "1", "--chunk-files", "1"],
    ["analyze-dataset", "A", "B", "--ranks", "2", "--time-varying", "6",
     "--n-inits", "2", "--max-iter", "50", "--subjects", "s1,s1"],
    ["analyze-dataset", "A", "B", "--space-by-time", "2:2", "--n-inits", "2",
     "--max-iter", "50"],
    ["analyze-dataset", "A", "B", "--temporal-modules", "2", "--n-inits", "2",
     "--max-iter", "50"],
    ["analyze-dataset", "A", "B", "--spatial-modules", "2", "--n-inits", "2",
     "--max-iter", "50"],
], ids=lambda a: "-".join(a[:1] + [x for x in a if x.startswith("--")][:2]))
def test_commands_run_without_pandas_or_matplotlib(argv, caps, no_pandas_or_matplotlib,
                                                   capsys):
    argv = [{"A": caps[0], "B": caps[1]}.get(a, a) for a in argv]
    assert tcli.main(["--platform", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    if argv[0] != "describe":
        json.loads(out)


def test_plot_without_matplotlib_exits_naming_it(caps, no_pandas_or_matplotlib,
                                                 tmp_path):
    with pytest.raises(SystemExit, match="matplotlib"):
        tcli.main(["--platform", "cpu", "analyze", caps[0], "--ranks", "2",
                   "--plot", str(tmp_path / "figs")])


@pytest.mark.parametrize("extra,names", [
    (["--ranks", "2:3"], {"processed_signals.png", "synergies_rank2.png",
                          "synergies_rank3.png"}),
    (["--ranks", "2", "--time-varying", "8", "--n-inits", "2"],
     {"processed_signals.png", "time_varying_synergies.png"}),
])
def test_plot_writes_the_jax_cli_figures(extra, names, caps, tmp_path):
    argv = ["analyze", caps[0], "--rms", "0.5", "--max-iter", "100", "--tol", "1e-4",
            *extra]
    _run(jcli, argv + ["--plot", str(tmp_path / "jax")], tmp_path / "j.json")
    _run(tcli, argv + ["--plot", str(tmp_path / "torch")], tmp_path / "t.json")
    got = {p.name for p in (tmp_path / "torch").iterdir()}
    assert got == {p.name for p in (tmp_path / "jax").iterdir()} == names
    assert all((tmp_path / "torch" / n).stat().st_size > 1000 for n in names)


def test_save_model_round_trips_and_exports(caps, tmp_path, capsys):
    from muscle_synergies_tpu.models import load_synergy_run as j_load_run
    from muscle_synergies_tpu_torch.models import load_synergy_run, load_transform

    report = _run(tcli, ["analyze", caps[0], "--ranks", "2:3", "--rms", "0.5",
                         "--max-iter", "300", "--tol", "1e-4", "--save-model",
                         str(tmp_path / "run")], tmp_path / "r.json")
    assert "model saved to" in capsys.readouterr().out
    for run in (load_synergy_run(tmp_path / "run.npz", device="cpu"),
                j_load_run(tmp_path / "run.npz")):
        assert sorted(run.model) == [2, 3]
        for rank in (2, 3):
            assert run.model[rank].n_iter_ == report["ranks"][str(rank)]["n_iter"]
            np.testing.assert_allclose(
                run.vaf_values.loc[rank, "All signals"],
                report["ranks"][str(rank)]["vaf_overall"], rtol=0, atol=0)

    base = ["--platform", "cpu", "export-transform", str(tmp_path / "run.npz"),
            "--shape", "b,8", "-o", str(tmp_path / "t.pt2")]
    with pytest.raises(SystemExit, match="--rank"):
        tcli.main(base)
    with pytest.raises(SystemExit, match="cuda"):
        tcli.main(base + ["--rank", "2", "--platforms", "tpu"])
    assert tcli.main(base + ["--rank", "2", "--platforms", "cpu", "--dtype",
                             "float64"]) == 0
    fn = load_transform(tmp_path / "t.pt2")
    x = np.abs(np.random.default_rng(3).normal(size=(37, 8)))
    model = load_synergy_run(tmp_path / "run.npz", device="cpu").model[2]
    np.testing.assert_allclose(fn(x), model.transform(x), rtol=1e-12, atol=1e-14)


def test_time_varying_save_model_loads_in_both_packages(caps, tmp_path):
    from muscle_synergies_tpu.models import CNMFModel as JCNMF
    from muscle_synergies_tpu_torch.models import CNMFModel

    _run(tcli, ["analyze", caps[0], "--ranks", "2", "--time-varying", "6", "--rms",
                "0.5", "--max-iter", "50", "--n-inits", "2", "--save-model",
                str(tmp_path / "tv")], tmp_path / "r.json")
    for model in (CNMFModel.load(tmp_path / "tv.npz", device="cpu"),
                  JCNMF.load(tmp_path / "tv.npz")):
        assert model.synergies_.shape == (2, 6, 8)
        assert model.n_components_ == 2 and model.n_lags_ == 6


def _actions(parser):
    """``{(subcommand, option or dest): action}`` of a parser."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                for a in sub._actions:
                    out[(name, a.option_strings[0] if a.option_strings else a.dest)] = a
        else:
            out[("", action.option_strings[0] if action.option_strings
                 else action.dest)] = action
    return out


def test_parser_keeps_every_jax_subcommand_option_and_default():
    mine, theirs = _actions(tcli._build_parser()), _actions(jcli._build_parser())
    assert set(theirs) <= set(mine), sorted(set(theirs) - set(mine))
    differ = {("", "--platform"), ("export-transform", "--platforms")}
    for key, want in theirs.items():
        got = mine[key]
        assert (got.dest, got.nargs, got.required) == \
            (want.dest, want.nargs, want.required), key
        assert getattr(got.type, "__name__", None) == \
            getattr(want.type, "__name__", None), key
        if key in differ:
            continue
        assert got.default == want.default, key
        if want.choices is not None:
            assert set(want.choices) <= set(got.choices), key
            assert key[1] == "--impl" or set(got.choices) == set(want.choices), key
    assert mine[("", "--platform")].choices == ["cpu", "cuda"]
    assert mine[("export-transform", "--platforms")].default == "cpu,cuda"
