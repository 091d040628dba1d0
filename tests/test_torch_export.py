"""PyTorch port: serving a fitted transform through ``torch.export``.

Mirrors ``tests/test_export.py`` in float64 on the CPU: a fitted
estimator's transform, exported (``models/export.py``), replays from
bytes or a file equal bit for bit to its traceable core run eagerly
(``_transform_torch`` with the eager loop), and within 1e-10 of
``model.transform``; a symbolic batch serves any size, a fixed one
refuses another, a 3-D ``NMFModel`` signature transforms each trial as
the 2-D artifact does; a serving process that loads the artifact never
imports the port; and the exported coefficients equal the JAX package's
exported transform of the same model, carried across by persistence,
within 1e-6.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pandas
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import muscle_synergies_tpu.models as jmodels  # noqa: E402
from muscle_synergies_tpu_torch import load_model  # noqa: E402
from muscle_synergies_tpu_torch.models import (  # noqa: E402
    CNMFModel,
    NM3FModel,
    NMFModel,
    export,
    export_transform,
    load_transform,
)

RNG = np.random.default_rng(11)
EMG = pandas.DataFrame(RNG.uniform(0.1, 1.0, (40, 3)) @ RNG.uniform(0.1, 1.0, (3, 5)),
                       columns=[f"m{i}" for i in range(5)])
FRAME = RNG.uniform(0.1, 1.0, (30, 4))
STACK = RNG.uniform(0.1, 1.0, (3, 16, 4))
CPU = dict(device="cpu")
F64 = dict(dtype=torch.float64, platforms=("cpu",))


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _models():
    return {
        "cd": (_quiet(NMFModel(2, random_state=0, max_iter=300, **CPU).fit, EMG),
               EMG.to_numpy()),
        "mu_kl": (_quiet(NMFModel(2, solver="mu", beta_loss="kullback-leibler",
                                  random_state=1, max_iter=150, **CPU).fit, EMG),
                  EMG.to_numpy()),
        "cnmf": (CNMFModel(2, 3, max_iter=20, n_inits=2, **CPU).fit(FRAME), FRAME),
        "nm3f": (NM3FModel(2, 2, max_iter=20, n_inits=2, **CPU).fit(STACK), STACK),
    }


MODELS = _models()


def _eager_core(model, x):
    factors = [torch.as_tensor(f) for f in model._transform_factors()]
    return model._transform_torch(torch.as_tensor(x), *factors)[0].numpy()


@pytest.mark.parametrize("name", list(MODELS))
def test_the_artifact_is_the_core_run_eagerly(name):
    model, x = MODELS[name]
    fn = load_transform(export_transform(model, x.shape, **F64))
    got = fn(x)
    np.testing.assert_array_equal(got, _eager_core(model, x))
    np.testing.assert_allclose(got, _quiet(model.transform, x), rtol=1e-10, atol=1e-12)
    assert set(fn.exported) == {"cpu"} and fn.meta["class"] == type(model).__name__


@pytest.mark.parametrize("name, shape", [("nm3f", ("b", 16, 4)), ("cnmf", ("b", 30, 4)),
                                         ("cd", (None, 40, 5))])
def test_a_symbolic_batch_serves_any_size(name, shape):
    model, _ = MODELS[name]
    fn = load_transform(export_transform(model, shape, **F64))
    for b in (1, 2, 5):
        xb = RNG.uniform(0.1, 1.0, (b,) + shape[1:])
        out = fn(xb)
        assert out.shape[0] == b
        np.testing.assert_array_equal(out, _eager_core(model, xb))
        np.testing.assert_allclose(out, _quiet(model.transform, xb), rtol=1e-10,
                                   atol=1e-12)


def test_a_fixed_batch_refuses_another():
    model, _ = MODELS["nm3f"]
    fn = load_transform(export_transform(model, (2, 16, 4), **F64))
    assert fn(STACK[:2]).shape == (2, 2, 2)
    with pytest.raises(Exception):
        fn(STACK)


def test_a_three_d_nmf_signature_transforms_each_trial():
    model, x = MODELS["cd"]
    stack = np.stack([x, 1.5 * x])
    out = load_transform(export_transform(model, ("b", 40, 5), **F64))(stack)
    single = load_transform(export_transform(model, (40, 5), **F64))
    assert out.shape == (2, 40, 2)
    for b in range(2):
        np.testing.assert_allclose(out[b], single(stack[b]), rtol=1e-10, atol=1e-12)


def test_file_round_trip_and_float32(tmp_path):
    model, x = MODELS["cnmf"]
    path = tmp_path / "transform.pt2zip"
    blob = export_transform(model, ("b", 30, 4), platforms=("cpu",), path=path)
    assert path.read_bytes() == blob and not list(tmp_path.glob("*.tmp"))
    fn = load_transform(path)
    assert fn.meta["dtype"] == "float32" and fn.meta["shape"] == ["b", 30, 4]
    x32 = x[None].astype(np.float32)
    out = fn(x32)
    assert out.dtype == np.float32
    factors = [torch.as_tensor(f, dtype=torch.float32)
               for f in model._transform_factors()]
    want = model._transform_torch(torch.as_tensor(x32), *factors)[0].numpy()
    np.testing.assert_array_equal(out, want)


def test_refusals():
    with pytest.raises(ValueError, match="not fitted"):
        export_transform(NMFModel(2, **CPU), (40, 5), platforms=("cpu",))
    with pytest.raises(ValueError, match="not fitted"):
        export_transform(CNMFModel(2, 3, **CPU), (30, 4), platforms=("cpu",))
    with pytest.raises(TypeError, match="cannot export"):
        export_transform(object(), (4, 4))
    model, _ = MODELS["nm3f"]
    with pytest.raises(ValueError, match="platforms"):
        export_transform(model, (2, 16, 4), platforms=("tpu",))
    if not torch.cuda.is_available():  # a platform that cannot be traced raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_transform(model, (2, 16, 4), platforms=("cpu", "cuda"))
    with pytest.raises(ValueError, match="not 'meta'"):
        load_transform(export_transform(model, (2, 16, 4), **F64))(
            torch.as_tensor(STACK[:2], device="meta"))


def test_a_serving_process_needs_only_torch(tmp_path):
    model, x = MODELS["nm3f"]
    path = tmp_path / "nm3f.transform"
    export_transform(model, ("b", 16, 4), path=path, **F64)
    np.save(tmp_path / "x.npy", x)
    child = f"""
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("_serving_export", {export.__file__!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
out = mod.load_transform({str(path)!r})(np.load({str(tmp_path / 'x.npy')!r}))
np.save({str(tmp_path / 'y.npy')!r}, out)
print(sorted(m for m in sys.modules if m.startswith("muscle_synergies")))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), _eager_core(model, x))


@pytest.mark.parametrize("kind", ["cd", "cnmf", "nm3f"])
def test_the_exported_transform_matches_the_jax_packages(kind, tmp_path):
    """The JAX package fits and saves; the port loads the file and
    exports; both artifacts give the same coefficients to 1e-6."""
    if kind == "cd":
        theirs = _quiet(jmodels.NMFModel(2, random_state=0, max_iter=300).fit, EMG)
        x, shape = EMG.to_numpy(), (40, 5)
    elif kind == "cnmf":
        theirs = jmodels.CNMFModel(2, 3, max_iter=20, n_inits=2, impl="xla").fit(FRAME)
        x, shape = FRAME, (30, 4)
    else:
        theirs = jmodels.NM3FModel(2, 2, max_iter=20, n_inits=2).fit(STACK)
        x, shape = STACK, ("b", 16, 4)
    mine = load_model(jmodels.save_model(theirs, tmp_path / kind), **CPU)
    want = jmodels.load_transform(jmodels.export_transform(
        theirs, shape, dtype=jnp.float64, platforms=("cpu",)))(x)
    got = load_transform(export_transform(mine, shape, **F64))(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
