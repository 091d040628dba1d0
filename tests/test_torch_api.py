"""PyTorch port: the JAX package's public names and keywords.

The port keeps the JAX package's public names: each ``__all__`` below is
diffed against the JAX package's, read with ``ast`` from its source so
that nothing of it is imported into the port, and every JAX name the
port lacks must be on the written list of names not ported yet, each
tagged with the ``ROADMAP.md`` item that ports it, or be a Pallas
kernel whose CUDA counterpart the port has under another name, or one
of the two Mosaic tile rules of the convolutive Pallas kernel, which
have no counterpart.  When an item lands, its names leave the list.

Keywords: ``mu_update_batch`` is held to the JAX package's at
``inner_iter`` 1 and 2 (float64, 1e-12 relative); ``block_b=`` (a Mosaic
tile) is accepted and changes nothing; ``precision=`` takes ``None``,
JAX's names in any case and a ``jax.lax.Precision``, maps them onto full
float32 or TF32, and refuses anything else.
"""

import ast
import importlib
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from muscle_synergies_tpu.models import batch as jbatch  # noqa: E402
from muscle_synergies_tpu.models import cnmf as jcnmf  # noqa: E402
from muscle_synergies_tpu.models import mu as jmu  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import _common  # noqa: E402
from muscle_synergies_tpu_torch.models import batch as tbatch  # noqa: E402
from muscle_synergies_tpu_torch.models import cnmf as tcnmf  # noqa: E402
from muscle_synergies_tpu_torch.models import mu as tmu  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX names the port does not export yet, by the ROADMAP item that ports them
# (none: ROADMAP item 8b, the last, ported parallel)
NOT_PORTED = {}
MODULES = {"": "__init__.py", "models": "models/__init__.py",
           "models.batch": "models/batch.py", "io": "io/__init__.py",
           "segment": "segment/__init__.py", "ops": "ops/__init__.py",
           "models.cnmf": "models/cnmf.py", "models.nm3f": "models/nm3f.py",
           "models.decode": "models/decode.py", "models.stability": "models/stability.py",
           "dataset": "dataset.py", "utils": "utils/__init__.py",
           "models.resume": "models/resume.py", "models.persist": "models/persist.py",
           "models.export": "models/export.py", "utils.checkpoint": "utils/checkpoint.py",
           "utils.profiling": "utils/profiling.py", "io.batch": "io/batch.py",
           "parallel": "parallel/__init__.py", "parallel.mesh": "parallel/mesh.py",
           "parallel.collectives": "parallel/collectives.py",
           "parallel.nmf": "parallel/nmf.py", "parallel.filters": "parallel/filters.py",
           "parallel.cnmf": "parallel/cnmf.py", "parallel.nm3f": "parallel/nm3f.py"}
# the JAX package's Mosaic tile rules for its convolutive Pallas kernel:
# they pick a tile of trials per TPU block and have no CUDA counterpart
MOSAIC = {"models.cnmf": ["cnmf_block_b", "resolve_cnmf_impl"]}
# the JAX package's Pallas kernels, by module, and the port's counterpart
# of each (a CUDA kernel's wrapper), which the port exports elsewhere
PALLAS = {"ops": {"sosfiltfilt_pallas": "ops.filter_cuda.sosfiltfilt_cuda",
                  "cascade_pallas": "ops.filter_cuda.sosfilt_cuda"}}


def _jax_all(relpath):
    """The JAX package's ``__all__`` of one module, read from its source."""
    path = os.path.join(REPO, "muscle_synergies_tpu", relpath)
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return {ast.literal_eval(e) for e in node.value.elts}
    raise AssertionError(f"no __all__ in {path}")


@pytest.mark.parametrize("module", list(MODULES))
def test_public_names_match_the_jax_package(module):
    port = mt
    for part in filter(None, module.split(".")):
        port = getattr(port, part)
    missing = _jax_all(MODULES[module]) - set(port.__all__)
    listed = {n for by_module in NOT_PORTED.values() for n in by_module.get(module, [])}
    listed |= set(MOSAIC.get(module, []))
    kernels = PALLAS.get(module, {})
    assert missing - set(kernels) == listed, (sorted(missing - listed - set(kernels)),
                                              sorted(listed - missing))
    assert set(kernels) <= missing
    for name in port.__all__:
        getattr(port, name)
    for counterpart in kernels.values():
        path, name = counterpart.rsplit(".", 1)
        target = getattr(importlib.import_module(f"muscle_synergies_tpu_torch.{path}"),
                         name)
        assert callable(target), counterpart


def test_not_ported_names_cite_roadmap_items():
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    for item in NOT_PORTED:
        assert f"**Item {item}" in roadmap, item


@pytest.mark.parametrize("inner_iter", [1, 2])
def test_mu_update_batch_matches_jax(inner_iter):
    rng = np.random.default_rng(40)
    x, w, h = rng.random((3, 50, 6)), rng.random((3, 50, 2)), rng.random((3, 2, 6))
    w[0, :, 1] = 0.0  # a zero denominator takes EPSILON
    jw, jh = jbatch.mu_update_batch(x, w, h, inner_iter=inner_iter)
    tw, th = tbatch.mu_update_batch(*(torch.as_tensor(a) for a in (x, w, h)),
                                    inner_iter=inner_iter)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12, atol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-12, atol=0)


def _problem(seed=41):
    rng = np.random.default_rng(seed)
    arrays = rng.random((2, 40, 5)), rng.random((2, 40, 3)), rng.random((2, 3, 5))
    return tuple(torch.as_tensor(a) for a in arrays)


def test_batched_solvers_accept_and_ignore_block_b():
    x, w, h = _problem()
    runs = {
        "mu_iterations_batch": lambda **k: tbatch.mu_iterations_batch(x, w, h, 3, **k),
        "fit_mu_batch": lambda **k: tbatch.fit_mu_batch(x, w, h, max_iter=30, **k).w,
        "cd_iterations_batch": lambda **k: tbatch.cd_iterations_batch(x, w, h, 3, **k),
        "fit_cd_batch": lambda **k: tbatch.fit_cd_batch(x, w, h, max_iter=30, **k).w,
        "beta_mu_iterations_batch": lambda **k: tbatch.beta_mu_iterations_batch(
            x, w, h, 3, beta=1.0, **k),
        "fit_mu_beta_batch": lambda **k: tbatch.fit_mu_beta_batch(
            x, w, h, beta=1.0, max_iter=30, **k).w,
    }
    c0 = torch.as_tensor(np.random.default_rng(42).random((2, 40, 2)))
    s0 = torch.as_tensor(np.random.default_rng(43).random((2, 2, 4, 5)))
    runs["cnmf_iterations_batch"] = lambda **k: tcnmf.cnmf_iterations_batch(
        x, c0, s0, 3, **k)
    runs["fit_cnmf_batch"] = lambda **k: tcnmf.fit_cnmf_batch(
        x, c0, s0, max_iter=30, **k).c
    for name, run in runs.items():
        plain, tiled = run(), run(block_b=8)
        for a, b in zip(plain if isinstance(plain, tuple) else (plain,),
                        tiled if isinstance(tiled, tuple) else (tiled,)):
            assert torch.equal(a, b), name


FULL = [None, "default", "DEFAULT", "highest", "Highest", "float32",
        jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST]
TF32 = ["high", "HIGH", "tensorfloat32", "bfloat16", "BFloat16", jax.lax.Precision.HIGH]


def test_precision_maps_onto_tf32_or_full_float32():
    for p in FULL:
        assert _common.allows_tf32(p) is False, p
    for p in TF32:
        assert _common.allows_tf32(p) is True, p
    for bad in ("fastest", "", 3, ("high", "high")):
        with pytest.raises(ValueError, match="precision"):
            _common.allows_tf32(bad)
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    try:
        flag.allow_tf32 = False
        with _common.matmul_precision("high"):
            assert flag.allow_tf32 is True  # only inside the block
        assert flag.allow_tf32 is False
        flag.allow_tf32 = True
        with _common.matmul_precision(jax.lax.Precision.HIGHEST):
            assert flag.allow_tf32 is False
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = saved


def test_precision_keyword_is_taken_where_jax_takes_it():
    x, w, h = _problem(44)
    c0 = torch.as_tensor(np.random.default_rng(45).random((2, 40, 2)))
    s0 = torch.as_tensor(np.random.default_rng(46).random((2, 2, 4, 5)))
    highest = jax.lax.Precision.HIGHEST
    calls = {
        "frobenius_error": (lambda p: tmu.frobenius_error(x[0], w[0], h[0], precision=p),
                            lambda: jmu.frobenius_error(x[0].numpy(), w[0].numpy(),
                                                        h[0].numpy(), precision=highest)),
        "cnmf_reconstruct": (lambda p: tcnmf.cnmf_reconstruct(c0[0], s0[0], precision=p),
                             lambda: jcnmf.cnmf_reconstruct(c0[0].numpy(), s0[0].numpy(),
                                                            precision=highest)),
        "cnmf_update": (lambda p: tcnmf.cnmf_update(x[0], c0[0], s0[0], precision=p),
                        lambda: jcnmf.cnmf_update(x[0].numpy(), c0[0].numpy(),
                                                  s0[0].numpy(), precision=highest)),
        "cnmf_iterations_batch": (
            lambda p: tcnmf.cnmf_iterations_batch(x, c0, s0, 3, precision=p),
            lambda: jcnmf.cnmf_iterations_batch(x.numpy(), c0.numpy(), s0.numpy(), 3,
                                                precision=highest)),
        "fit_cnmf_batch": (
            lambda p: tcnmf.fit_cnmf_batch(x, c0, s0, max_iter=30, precision=p)[:2],
            lambda: jcnmf.fit_cnmf_batch(x.numpy(), c0.numpy(), s0.numpy(), max_iter=30,
                                         precision=highest)[:2]),
    }
    for name, (mine, ref) in calls.items():
        want = ref()
        for p in ("highest", "high", None, highest):
            got = mine(p)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                           atol=1e-12, err_msg=name)
        with pytest.raises(ValueError, match="precision"):
            mine("fastest")


def test_time_varying_analysis_takes_precision():
    rng = np.random.default_rng(47)
    trials = [np.abs(rng.standard_normal((400, 4))) for _ in range(2)]
    kw = dict(n_synergies=2, n_lags=4, n_inits=2, max_iter=30, device="cpu")
    base = mt.analyze_dataset_time_varying(trials, 1000.0, **kw)
    high = mt.analyze_dataset_time_varying(trials, 1000.0, precision="high", **kw)
    np.testing.assert_array_equal(base.vaf_overall, high.vaf_overall)  # CPU: no TF32
    with pytest.raises(ValueError, match="precision"):
        mt.analyze_dataset_time_varying(trials, 1000.0, precision="fastest", **kw)
