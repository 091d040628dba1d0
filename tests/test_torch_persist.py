"""PyTorch port: pickle-free persistence (``models/persist.py``).

Mirrors ``tests/test_persist.py`` in float64 on the CPU: every model
kind (CD, MU-KL, float beta with sparsity, the legacy ``alpha``, CNMF,
NM3F) and single runs and sweeps round-trip with bit-equal factors and
transforms; the format tags are the JAX package's byte for byte, and
files cross-load both ways: a JAX-saved ``.npz`` loads in the port with
bit-equal factors and the same hyperparameters, and its port
``transform`` is within 1e-6 of the JAX package's (the bar of
``tests/test_torch_cnmf_models.py`` and ``tests/test_torch_nm3f.py``);
a port-saved file loads in the JAX package the same way.
"""

import json
import warnings

import numpy as np
import pandas
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from muscle_synergies_tpu.models import persist as jpersist  # noqa: E402
import muscle_synergies_tpu.models as jmodels  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch.models import (  # noqa: E402
    CNMFModel,
    NM3FModel,
    NMFModel,
    SynergyRunResult,
    persist,
)

RNG = np.random.default_rng(7)
MUSCLES = [f"m{i}" for i in range(5)]
EMG = pandas.DataFrame(RNG.uniform(0.1, 1.0, (60, 3)) @ RNG.uniform(0.1, 1.0, (3, 5)),
                       columns=MUSCLES)
FRAME = RNG.uniform(0.1, 1.0, (40, 4))  # the convolutive model's trial
STACK = RNG.uniform(0.1, 1.0, (3, 20, 5))  # the space-by-time model's trials
NEW_STACK = RNG.uniform(0.1, 1.0, (2, 20, 5))
CPU = dict(device="cpu")

# kind: (the port's model class, constructor arguments, fit input, input for transform)
KINDS = {
    "cd": ("NMFModel", ((), dict(n_components=2, random_state=0, max_iter=300)), EMG, EMG),
    "mu_kl": ("NMFModel", ((), dict(n_components=2, solver="mu",
                                    beta_loss="kullback-leibler", random_state=1,
                                    max_iter=200)), EMG, EMG),
    "float_beta_sparsity": ("NMFModel", ((), dict(n_components=2, solver="mu",
                                                  beta_loss=1.5, alpha_W=0.01,
                                                  l1_ratio=0.5, random_state=2,
                                                  max_iter=150)), EMG, EMG),
    "legacy_alpha": ("NMFModel", ((), dict(n_components=2, solver="mu", alpha=0.02,
                                           regularization="components", random_state=3,
                                           max_iter=150)), EMG, EMG),
    "cnmf": ("CNMFModel", ((2, 3), dict(max_iter=40, n_inits=2, random_state=0)), FRAME,
             FRAME[:30]),
    "nm3f": ("NM3FModel", ((2, 2), dict(max_iter=30, n_inits=2, random_state=0)), STACK,
             NEW_STACK),
}
FACTORS = {"NMFModel": ("components_",), "CNMFModel": ("synergies_", "restart_errors_"),
           "NM3FModel": ("temporal_modules_", "spatial_modules_", "restart_errors_")}
SCALARS = ("n_iter_", "reconstruction_err_", "n_components_", "n_lags_", "n_temporal_",
           "n_spatial_", "vaf_", "_legacy_alpha", "beta_loss", "solver", "tol", "max_iter",
           "random_state", "precision")


def _fit(package, kind):
    cls, (args, kwargs), x, _ = KINDS[kind]
    extra = CPU if package is mt.models else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return getattr(package, cls)(*args, **kwargs, **extra).fit(x)


def _transform(model, x):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return model.transform(x)


def _same_model(a, b):
    for attr in FACTORS[type(a).__name__]:
        x, y = np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr))
        assert x.dtype == y.dtype, attr
        np.testing.assert_array_equal(x, y, err_msg=attr)
    for attr in SCALARS:
        if hasattr(a, attr) or hasattr(b, attr):
            assert getattr(a, attr) == getattr(b, attr), attr


def test_format_tags_are_the_jax_packages():
    assert persist.MODEL_FORMAT == jpersist.MODEL_FORMAT == "muscle_synergies_tpu.model/1"
    assert persist.RUN_FORMAT == jpersist.RUN_FORMAT == "muscle_synergies_tpu.synergy_run/1"


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip(kind, tmp_path):
    model = _fit(mt.models, kind)
    path = persist.save_model(model, tmp_path / kind)
    assert path.name == f"{kind}.npz" and not list(tmp_path.glob("*.tmp.npz"))
    loaded = type(model).load(path, device="cpu")
    _same_model(model, loaded)
    x = KINDS[kind][3]
    out = _transform(model, x)
    np.testing.assert_array_equal(out, _transform(loaded, x))
    np.testing.assert_array_equal(model.inverse_transform(out), loaded.inverse_transform(out))


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_jax_saved_model_loads_in_the_port(kind, tmp_path):
    theirs = _fit(jmodels, kind)
    path = jpersist.save_model(theirs, tmp_path / kind)
    mine = mt.load_model(path, device="cpu")
    assert type(mine).__name__ == type(theirs).__name__
    _same_model(theirs, mine)
    x = KINDS[kind][3]
    np.testing.assert_allclose(_transform(mine, x), _transform(theirs, x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_port_saved_model_loads_in_the_jax_package(kind, tmp_path):
    mine = _fit(mt.models, kind)
    path = mine.save(tmp_path / kind)
    theirs = jpersist.load_model(path)
    _same_model(mine, theirs)
    x = KINDS[kind][3]
    np.testing.assert_allclose(_transform(mine, x), _transform(theirs, x), rtol=0, atol=1e-6)
    # the same JSON fields as a file the JAX package writes
    with np.load(path) as data:
        meta = json.loads(str(data["__meta__"]))
        files = sorted(data.files)
    with np.load(jpersist.save_model(_fit(jmodels, kind), tmp_path / "jax")) as data:
        want = json.loads(str(data["__meta__"]))
        assert sorted(data.files) == files
    assert meta.keys() == want.keys() and meta["params"].keys() == want["params"].keys()
    assert meta["fitted"].keys() == want["fitted"].keys()


def test_precision_enum_round_trips_as_a_string(tmp_path):
    model = NM3FModel(2, 2, max_iter=10, n_inits=1, random_state=0,
                      precision=jax.lax.Precision.HIGHEST, **CPU).fit(STACK[:2, :16, :4])
    loaded = NM3FModel.load(model.save(tmp_path / "prec"), device="cpu")
    assert loaded.precision == "highest"
    x = NEW_STACK[:1, :16, :4]
    np.testing.assert_array_equal(model.transform(x), loaded.transform(x))


def test_cnmf_impl_is_stored_by_the_jax_packages_names(tmp_path):
    model = CNMFModel(2, 3, max_iter=20, n_inits=1, impl="torch", **CPU).fit(FRAME)
    loaded = jpersist.load_model(model.save(tmp_path / "impl"))
    assert loaded.impl == "xla"
    assert CNMFModel.load(tmp_path / "impl.npz", device="cpu").impl == "xla"


@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_synergy_runs_round_trip_and_cross_load(sweep, writer, tmp_path):
    ranks = (1, 3) if sweep else (2, None)
    kw = dict(max_iter=300, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = (mt.find_synergies(EMG, *ranks, **kw, **CPU) if writer == "port"
               else jmodels.find_synergies(EMG, *ranks, **kw))
    path = res.save(tmp_path / "run")
    loaders = (lambda p: SynergyRunResult.load(p, device="cpu"), jpersist.load_synergy_run)
    for load in loaders:
        out = load(path)
        pandas.testing.assert_frame_equal(out.vaf_values, res.vaf_values,
                                          check_index_type=False)
        if sweep:
            assert sorted(out.model) == [1, 2, 3]
            for k in (1, 2, 3):
                pandas.testing.assert_frame_equal(out.components[k], res.components[k])
                _same_model(res.model[k], out.model[k])
        else:
            pandas.testing.assert_frame_equal(out.components, res.components)
            _same_model(res.model, out.model)
            np.testing.assert_allclose(_transform(out.model, EMG),
                                       _transform(res.model, EMG), rtol=0, atol=1e-6)


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="not fitted"):
        persist.save_model(NMFModel(2, **CPU), tmp_path / "x")
    with pytest.raises(ValueError, match="not fitted"):
        CNMFModel(2, 3, **CPU).save(tmp_path / "x")
    with pytest.raises(TypeError, match="cannot persist"):
        persist.save_model(object(), tmp_path / "x")
    model = _fit(mt.models, "cd")
    path = model.save(tmp_path / "m")
    with pytest.raises(TypeError, match="NMFModel"):
        CNMFModel.load(path)
    foreign = tmp_path / "foreign.npz"
    np.savez(foreign, data=np.zeros(3))
    with pytest.raises(ValueError, match="not a muscle_synergies_tpu"):
        persist.load_model(foreign)
    with pytest.raises(ValueError, match="format"):
        persist.load_synergy_run(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = mt.find_synergies(EMG, 2, max_iter=100, **CPU)
    with pytest.raises(ValueError, match="format"):
        persist.load_model(run.save(tmp_path / "run"))
    # an object array would need pickle: refused at load
    pickled = tmp_path / "pickled.npz"
    np.savez(pickled, __meta__=np.array({"format": persist.MODEL_FORMAT}, dtype=object))
    with pytest.raises(ValueError, match="pickle"):
        persist.load_model(pickled)
    # the loaded model runs where it is asked: the card by default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            persist.load_model(path).transform(EMG)
