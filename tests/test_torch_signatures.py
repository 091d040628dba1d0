"""PyTorch port: the JAX package's positional parameters, in its order.

For every name that a port module exports in its ``__all__`` and the JAX
module at the same place exports too, the function or class constructor
must take the JAX package's positional parameters in the JAX order, so
that a positional call binds what it binds in the JAX package.  The
port's own keywords may follow them and nothing else:
``device``/``dtype`` (where the entry points run), ``generator`` (a
``torch.Generator`` in place of the JAX draws) and ``impl`` (the kernel
or the plain version, where the JAX function has no such choice).  The
JAX package's keyword-only parameters must be taken too.  Exception
classes, whose signatures Python does not expose, are skipped.  Last,
``beta_divergence`` takes ``precision`` where the JAX one does, and
gives the JAX package's value (1e-12 relative, float64).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from muscle_synergies_tpu.models import beta as jbeta  # noqa: E402
import muscle_synergies_tpu_torch as port  # noqa: E402
from muscle_synergies_tpu_torch.models import beta as tbeta  # noqa: E402

POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
PORT_ONLY = {"device", "dtype", "generator", "impl"}


def _port_modules():
    """Every module of the port with an ``__all__``, by its path in the
    package (``""`` for the top level)."""
    names = [""] + [m.name[len(port.__name__):] for m in
                    pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    return sorted(n for n in names
                  if hasattr(importlib.import_module(port.__name__ + n), "__all__"))


def _jax_module(rel):
    try:
        return importlib.import_module("muscle_synergies_tpu" + rel)
    except ModuleNotFoundError:
        return None


def _parameters(obj):
    """``(positional names, keyword-only names)``, or ``None`` where
    Python exposes no signature."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    params = [p for p in sig.parameters.values() if p.name != "self"]
    return ([p.name for p in params if p.kind in POSITIONAL],
            {p.name for p in params if p.kind == inspect.Parameter.KEYWORD_ONLY})


MODULES = [rel for rel in _port_modules() if _jax_module(rel) is not None]


def test_the_check_covers_the_ported_surface():
    for rel in ("", ".models", ".models.cnmf", ".models.nm3f", ".models.decode",
                ".models.beta", ".models.stability", ".dataset", ".models.resume",
                ".models.persist", ".models.export", ".utils.checkpoint",
                ".utils.profiling", ".io", ".io.batch", ".segment", ".parallel",
                ".parallel.mesh", ".parallel.collectives", ".parallel.nmf",
                ".parallel.filters", ".parallel.cnmf", ".parallel.nm3f"):
        assert rel in MODULES, rel


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r.lstrip(".") or "top")
def test_positional_parameters_follow_the_jax_package(rel):
    mine = importlib.import_module(port.__name__ + rel)
    theirs = _jax_module(rel)
    shared = sorted(set(mine.__all__) & set(getattr(theirs, "__all__", ())))
    for name in shared:
        ours, ref = getattr(mine, name), getattr(theirs, name)
        if inspect.ismodule(ours) or not callable(ours):
            continue
        got, want = _parameters(ours), _parameters(ref)
        if want is None or (inspect.isclass(ref) and issubclass(ref, BaseException)):
            continue
        assert got is not None, name
        (pos, kw_only), (jax_pos, jax_kw_only) = got, want
        assert pos[:len(jax_pos)] == jax_pos, (name, pos, jax_pos)
        assert set(pos[len(jax_pos):]) <= PORT_ONLY, (name, pos[len(jax_pos):])
        assert jax_kw_only <= kw_only | set(pos), (name, jax_kw_only - kw_only)


VIZ = ["plot_signal", "synergy_heatmap", "plot_fft", "plot_time_varying_synergies",
       "plot_synergy_clusters", "plot_space_by_time"]


@pytest.mark.parametrize("name", VIZ + ["ViconNexusData.plot_cols", "__main__.main"])
def test_plots_and_the_cli_follow_the_jax_package(name):
    """The JAX ``viz`` module has no ``__all__``; its plots, ``plot_cols``
    and the CLI's ``main`` are held here, the port's extra keywords
    (``columns``, ``index``, ``time``) keyword-only."""
    import muscle_synergies_tpu.__main__ as jmain
    import muscle_synergies_tpu.data as jdata
    import muscle_synergies_tpu.viz as jviz

    import muscle_synergies_tpu_torch.__main__ as tmain

    theirs = {"viz": jviz, "ViconNexusData": jdata.ViconNexusData, "__main__": jmain}
    mine = {"viz": port.viz, "ViconNexusData": port.ViconNexusData, "__main__": tmain}
    owner, attr = name.split(".") if "." in name else ("viz", name)
    (pos, kw_only), (jax_pos, jax_kw_only) = (
        _parameters(getattr(mine[owner], attr)), _parameters(getattr(theirs[owner], attr)))
    assert pos[:len(jax_pos)] == jax_pos, (name, pos, jax_pos)
    assert set(pos[len(jax_pos):]) <= PORT_ONLY, (name, pos[len(jax_pos):])
    assert jax_kw_only <= kw_only, (name, jax_kw_only - kw_only)


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 1.5])
def test_beta_divergence_takes_precision_where_jax_does(beta):
    rng = np.random.default_rng(110)
    x, w, h = rng.random((20, 5)) + 0.1, rng.random((20, 3)), rng.random((3, 5))
    highest = jax.lax.Precision.HIGHEST
    want = float(jbeta.beta_divergence(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                                       beta, True, highest))
    for precision in (highest, "highest", "high", None):
        got = float(tbeta.beta_divergence(*(torch.as_tensor(a) for a in (x, w, h)),
                                          beta, True, precision))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="precision"):
        tbeta.beta_divergence(*(torch.as_tensor(a) for a in (x, w, h)), beta,
                              precision="fastest")
