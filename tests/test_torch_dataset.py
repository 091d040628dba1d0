"""PyTorch port: the whole dataset slice, conversion and import hygiene.

``analyze_dataset`` of both packages on the same float64 EMG (6 trials x
1500 samples x 8 channels at 1000 Hz, ranks 1-3): VAF to 1e-8, factors
to 1e-6, iteration counts and convergence flags equal.  One documented
exception: for CD at rank 1 the NNDSVD start already is the optimum (the
Perron pair of the non-negative data), so the first violation, and with
it every later ratio, is float64 rounding noise; its stopping iteration
then depends on summation order, and only its factors and VAF are held
to the reference.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import no_leftover_group  # noqa: E402,F401

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.dataset import preprocess_trials as j_preprocess_trials  # noqa: E402
from muscle_synergies_tpu.models.batch import fit_cd_batch as j_fit_cd_batch  # noqa: E402
from muscle_synergies_tpu.models.batch import fit_mu_batch as j_fit_mu_batch  # noqa: E402
from muscle_synergies_tpu.utils.config import FilterSpec as JFilterSpec  # noqa: E402
from muscle_synergies_tpu.utils.config import PipelineConfig as JConfig  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import convert  # noqa: E402
from muscle_synergies_tpu_torch.models.batch import (  # noqa: E402
    fit_cd_batch,
    fit_mu_batch,
)
from muscle_synergies_tpu_torch.ops import filter_cuda  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1000.0
RANKS = (1, 2, 3)
FIT = dict(max_iter=500, tol=1e-4)
CPU = dict(device="cpu")  # the port's entry points default to the card


def _emg(n_trials, n_samples, seed):
    """EMG with a 3-synergy envelope: non-negative mixes times noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / FS
    out = []
    for _ in range(n_trials):
        acts = np.abs(np.sin(2 * np.pi * (1.0 + rng.random(3))[None, :] * t[:, None]
                             + rng.random(3)))
        env = acts @ rng.random((3, 8)) + 0.05
        out.append(env * rng.standard_normal((n_samples, 8)))
    return out


TRIALS = _emg(6, 1500, seed=41)


@pytest.fixture(scope="module", params=["cd", "mu"])
def both(request):
    solver = request.param
    jres = mst.analyze_dataset(TRIALS, FS, ranks=RANKS, solver=solver, **FIT)
    tres = mt.analyze_dataset(TRIALS, FS, ranks=RANKS, solver=solver, **FIT, **CPU)
    return solver, jres, tres


def test_slice_vaf_and_factors_match_jax(both):
    _, jres, tres = both
    assert tres.w.shape == jres.w.shape == (3, 6, 200, 3)
    assert tres.h.shape == jres.h.shape == (3, 6, 3, 8)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.vaf_per_channel, jres.vaf_per_channel,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.w, jres.w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.h, jres.h, rtol=0, atol=1e-6)


def test_slice_iterations_and_convergence_match_jax(both):
    solver, jres, tres = both
    first = 1 if solver == "cd" else 0  # see the module docstring
    np.testing.assert_array_equal(tres.n_iter[first:], jres.n_iter[first:])
    np.testing.assert_array_equal(tres.converged[first:], jres.converged[first:])
    assert tres.n_iter.dtype == np.int32 and tres.converged.dtype == bool


def test_ragged_trials_match_jax():
    trials = [TRIALS[0], TRIALS[1][:1100], TRIALS[2][:1100], TRIALS[3][:1300]]
    jres = mst.analyze_dataset(trials, FS, ranks=(2,), solver="mu", **FIT)
    tres = mt.analyze_dataset(trials, FS, ranks=(2,), solver="mu", **FIT, **CPU)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tres.n_iter, jres.n_iter)
    pre = mt.preprocess_trials(trials, FS, **CPU).numpy()
    np.testing.assert_allclose(pre, np.asarray(j_preprocess_trials(trials, FS)),
                               rtol=0, atol=1e-9)


def test_batch_array_input_and_penalties_match_jax():
    xs = np.stack(TRIALS[:3])
    kw = dict(ranks=(2,), solver="cd", alpha_W=0.01, l1_ratio=0.5, **FIT)
    jres = mst.analyze_dataset(xs, FS, **kw)
    tres = mt.analyze_dataset(xs, FS, **kw, **CPU)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tres.n_iter, jres.n_iter)


def test_subject_tables_match_jax():
    mapping = {"s1": TRIALS[:3], "s2": TRIALS[3:]}
    jres = mst.analyze_dataset(mapping, FS, ranks=(1, 2), solver="mu", **FIT)
    tres = mt.analyze_dataset(mapping, FS, ranks=(1, 2), solver="mu", **FIT, **CPU)
    assert tres.subjects == jres.subjects
    np.testing.assert_allclose(tres.subject_table().to_numpy(),
                               jres.subject_table().to_numpy(), rtol=0, atol=1e-8)
    assert tres.subject_min_rank(0.5).to_dict() == jres.subject_min_rank(0.5).to_dict()
    np.testing.assert_allclose(tres.subject_components(2, "s2").to_numpy(),
                               jres.subject_components(2, "s2").to_numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tres.min_rank_reaching(0.9),
                                  jres.min_rank_reaching(0.9))
    assert tres.components(2, 0).shape == (2, 8)
    assert tres.trials_of("s1") == [0, 1, 2]


@pytest.mark.parametrize("kind", ["rank sweep", "time-varying"])
def test_subject_mean_core_matches_jax_table(kind):
    """``subject_table("mean")`` stands on the array core the command
    line reports from (no pandas): the JAX table's labels and values,
    subjects in first-appearance order, and the core equal to the table."""
    mapping = {"s2": TRIALS[:2], "s1": TRIALS[2:5]}
    if kind == "rank sweep":
        kw = dict(ranks=(1, 2), solver="mu", **FIT)
        jres = mst.analyze_dataset(mapping, FS, **kw)
        tres = mt.analyze_dataset(mapping, FS, **kw, **CPU)
    else:
        kw = dict(n_synergies=2, n_lags=4, n_inits=2, max_iter=200, tol=1e-4)
        jres = mst.analyze_dataset_time_varying(mapping, FS, **kw)
        tres = mt.analyze_dataset_time_varying(mapping, FS, **kw, **CPU)
    jt, tt = jres.subject_table("mean"), tres.subject_table("mean")
    assert type(tt) is type(jt)
    assert list(tt.index) == list(jt.index) == ["s2", "s1"]
    assert tt.index.name == jt.index.name == "subject"
    if kind == "rank sweep":
        assert list(tt.columns) == list(jt.columns)
    else:
        assert tt.name == jt.name
    np.testing.assert_allclose(tt.to_numpy(), jt.to_numpy(), rtol=0, atol=1e-8)
    grouped = tres.vaf_table().groupby(level="subject", sort=False).mean()
    np.testing.assert_allclose(tt.to_numpy(), grouped.to_numpy(), rtol=1e-15, atol=0)
    core = tres._subject_vaf_means()
    assert list(core) == ["s2", "s1"]
    for subject, means in core.items():
        np.testing.assert_array_equal(np.asarray(tt.loc[subject]), means)


def test_unported_options_raise(tmp_path):
    # ROADMAP item 8b ported the mesh and the orbax store: a mesh without
    # the (data, time) axes is refused with a warning, and fits locally
    mesh = mt.parallel.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.warns(UserWarning, match=r"lacks the \['time'\] axis"):
        mt.analyze_dataset(TRIALS[:2], FS, mesh=mesh, max_iter=10, **CPU)
    assert mt.utils.GridCheckpoint(tmp_path, backend="orbax").completed_keys() == []
    with pytest.raises(ValueError, match="solver"):
        mt.analyze_dataset(TRIALS[:2], FS, solver="als", **CPU)


def test_pipeline_config_json_round_trips_between_packages():
    cfg = JConfig(envelope=JFilterSpec(order=2, critical_freqs=(20.0, 300.0),
                                       band_type="bandpass"),
                  solver="mu", solver_impl="pallas", tol=1e-5)
    mine = convert.pipeline_config(cfg.to_json())
    assert mine.envelope.critical_freqs == (20.0, 300.0)
    assert json.loads(mine.to_json()) == json.loads(cfg.to_json())
    assert JConfig.from_json(mine.to_json()) == cfg
    assert mt.PipelineConfig.from_json(mt.PipelineConfig().to_json()) == mt.PipelineConfig()
    np.testing.assert_array_equal(mine.envelope.design(FS), cfg.envelope.design(FS))


def test_convert_jax_states_and_results():
    rng = np.random.default_rng(5)
    xs, w0, h0 = rng.random((3, 30, 6)), rng.random((3, 30, 2)), rng.random((3, 2, 6))
    # a JAX-side init fed to both packages through convert
    tw, th = convert.initial_factors(w0, h0, dtype=torch.float64)
    js = j_fit_cd_batch(xs, w0, h0, max_iter=50)
    ts = fit_cd_batch(torch.as_tensor(xs), tw, th, max_iter=50)
    cs = convert.cd_state(js)
    assert cs.ht.shape == (3, 6, 2) and cs.converged.dtype == torch.bool
    np.testing.assert_allclose(ts.ht.numpy(), cs.ht.numpy(), rtol=0, atol=1e-10)
    assert torch.equal(convert.h_from_ht(convert.ht_from_h(th)), th)
    jm = j_fit_mu_batch(xs, w0, h0, max_iter=50)
    ms = convert.mu_state(jm)
    tm = fit_mu_batch(torch.as_tensor(xs), tw, th, max_iter=50)
    np.testing.assert_array_equal(ms.n_iter.numpy(), tm.n_iter.numpy())
    np.testing.assert_allclose(ms.previous_error.numpy(), tm.previous_error.numpy(),
                               rtol=1e-10)
    jres = mst.analyze_dataset(TRIALS[:2], FS, ranks=(1, 2), solver="mu", **FIT)
    res = convert.dataset_result(jres)
    assert isinstance(res, mt.DatasetResult) and res.ranks == (1, 2)
    np.testing.assert_array_equal(res.vaf_overall, jres.vaf_overall)
    np.testing.assert_array_equal(res.min_rank_reaching(0.9), jres.min_rank_reaching(0.9))
    with pytest.raises(ValueError, match="ranks"):
        convert.initial_factors(w0, h0[:, :1])


def test_port_imports_neither_jax_nor_pandas():
    code = (
        "import sys, numpy as np\n"
        "import muscle_synergies_tpu_torch as m\n"
        "rng = np.random.default_rng(0)\n"
        "trials = [rng.random((400, 4)) for _ in range(3)]\n"
        "r = m.analyze_dataset(trials, 1000.0, ranks=(1, 2), max_iter=30, device='cpu')\n"
        "assert r.vaf_overall.shape == (2, 3)\n"
        "r = m.analyze_dataset(trials, 1000.0, ranks=(1, 2), max_iter=30, solver='mu',\n"
        "                      beta_loss='kullback-leibler', device='cpu')\n"
        "assert r.vaf_overall.shape == (2, 3)\n"
        "r = m.analyze_dataset_time_varying(trials, 1000.0, n_synergies=2, n_lags=5,\n"
        "                                   n_inits=2, max_iter=30, device='cpu')\n"
        "assert r.vaf_overall.shape == (3,) and r.restart_errors.shape == (3, 2)\n"
        "import os, tempfile\n"
        "from muscle_synergies_tpu_torch.testing import write_synthetic_capture\n"
        "path = os.path.join(tempfile.mkdtemp(), 'capture.csv')\n"
        "write_synthetic_capture(path, state_len=60, n_markers=2)\n"
        "data = m.load_vicon_file(path)\n"
        "seg = m.segment.Segmenter(data)\n"
        "cut = []\n"
        "for trecho, cycles in seg.segments.items():\n"
        "    for cycle in cycles:\n"
        "        t = seg.get_times_of(trecho, cycle)\n"
        "        a, b = data.emg.to_index(t.start), data.emg.to_index(t.stop)\n"
        "        cut.append(data.emg.array[a:b + 1])\n"
        "r = m.analyze_dataset(cut, 2000.0, ranks=(1, 2), max_iter=30, device='cpu')\n"
        "assert r.vaf_overall.shape == (2, 8)\n"
        "r = m.analyze_dataset([data.emg], 2000.0, ranks=(1,), max_iter=30, device='cpu')\n"
        "assert r.channel_names == list(data.emg.coords)\n"
        "r = m.analyze_dataset_space_by_time(trials, 1000.0, 2, 2, max_iter=30,\n"
        "                                    n_inits=2, device='cpu')\n"
        "assert r.coefficients.shape == (3, 2, 2)\n"
        "cm = m.models.CNMFModel(2, 3, max_iter=30, device='cpu')\n"
        "assert cm.fit_transform(trials[0][:40]).shape == (40, 2)\n"
        "assert cm.transform(np.stack([trials[1][:40]] * 2)).shape == (2, 40, 2)\n"
        "nm = m.models.NM3FModel(2, 2, max_iter=30, device='cpu')\n"
        "assert nm.fit_transform(np.stack([t[:40] for t in trials])).shape == (3, 2, 2)\n"
        "assert nm.transform(trials[0][:40]).shape == (2, 2)\n"
        "st = m.models.stability\n"
        "boot = st.bootstrap_synergies(trials[0][:60], 2, n_boot=3, max_iter=30,\n"
        "                              device='cpu')\n"
        "assert boot.similarities.shape == (3, 2)\n"
        "cv = st.cv_rank_selection(trials[0][:60], (1, 2), n_repeats=2, max_iter=30,\n"
        "                          device='cpu')\n"
        "assert cv.best_rank in (1, 2)\n"
        "cl = st.cluster_synergies([boot.reference_components, trials[1][:3]])\n"
        "assert len(cl.labels) == 2\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'pandas', 'sklearn'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO  # no site hooks that could pull in jax themselves
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


CAUSAL = dict(envelope=dict(zero_lag=False))
CONFIGS = {"rms": dict(use_rms=True), "causal": CAUSAL}


def _configs(name):
    kw = dict(CONFIGS[name])
    if "envelope" in kw:
        return (JConfig(envelope=JFilterSpec(**kw["envelope"])),
                mt.PipelineConfig(envelope=mt.FilterSpec(**kw["envelope"])))
    return JConfig(**kw), mt.PipelineConfig(**kw)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_preprocess_rms_and_causal_envelopes_match_jax(name, ragged, monkeypatch):
    jcfg, tcfg = _configs(name)
    trials = TRIALS[:4]
    if ragged:
        trials = [TRIALS[0], TRIALS[1][:1100], TRIALS[2][:1300], TRIALS[3][:1100]]
    calls = []
    plain = filter_cuda.sosfilt_plain
    monkeypatch.setattr(filter_cuda, "sosfilt_plain",
                        lambda *a: calls.append(a[1].shape) or plain(*a))
    mine = mt.preprocess_trials(trials, FS, tcfg, **CPU).numpy()
    # the causal envelope filters ragged trials as one padded batch
    assert len(calls) == (1 if name == "causal" else 0)
    ref = np.asarray(j_preprocess_trials(trials, FS, jcfg))
    assert mine.shape == ref.shape == (4, 200, 8)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)
    if not ragged:  # one (B, N, L) array is the same batch
        batch = mt.preprocess_trials(np.stack(trials), FS, tcfg, **CPU).numpy()
        np.testing.assert_allclose(batch, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_config_preprocess_matches_jax(name):
    jcfg, tcfg = _configs(name)
    mine = tcfg.preprocess(TRIALS[4], FS, **CPU).numpy()
    np.testing.assert_allclose(mine, np.asarray(jcfg.preprocess(TRIALS[4], FS)),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("name, solver", [("rms", "cd"), ("causal", "mu")])
def test_analyze_dataset_under_rms_and_causal_configs_matches_jax(name, solver):
    jcfg, tcfg = _configs(name)
    trials = _emg(4, 2000, seed=43)
    kw = dict(ranks=RANKS, solver=solver, **FIT)
    jres = mst.analyze_dataset(trials, FS, config=jcfg, **kw)
    tres = mt.analyze_dataset(trials, FS, config=tcfg, **kw, **CPU)
    np.testing.assert_allclose(tres.vaf_overall, jres.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.h, jres.h, rtol=0, atol=1e-6)
    first = 1 if solver == "cd" else 0  # see the module docstring
    np.testing.assert_array_equal(tres.n_iter[first:], jres.n_iter[first:])
