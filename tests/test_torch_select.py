"""PyTorch port: ``NMFModel``, ``find_synergies`` and the batched rank sweep.

Both packages fit the same float64 frame (a 3-synergy envelope, 200 x 8,
made with numpy from a seed) on the CPU.  Their solvers run the same
updates in the same order, so factors agree to 1e-8 and iteration
counts are equal.  One documented exception, as in
``tests/test_torch_dataset.py``: CD at rank 1 starts at its optimum
(NNDSVD's rank-1 start is the Perron pair), so its stopping ratio is
rounding noise and only its factors are held to the reference.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
pandas = pytest.importorskip("pandas")

from muscle_synergies_tpu.models import batch as j_batch  # noqa: E402
from muscle_synergies_tpu.models import rsvd as j_rsvd  # noqa: E402
from muscle_synergies_tpu.models import select as j_select  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import convert  # noqa: E402
from muscle_synergies_tpu_torch.models import batch, rsvd, select  # noqa: E402
from muscle_synergies_tpu_torch.models.kernels import beta_cuda, mu_cuda  # noqa: E402

CPU = dict(device="cpu")
FIT = dict(max_iter=400, tol=1e-4)


def _frame(n=200, l=8, seed=7):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n)[:, None]
    acts = np.abs(np.sin(2 * np.pi * (t * (1 + rng.random(3)) + rng.random(3))))
    x = acts @ rng.random((3, l)) + 0.02 * rng.random((n, l))
    return pandas.DataFrame(x, columns=[f"m{i}" for i in range(l)])


DF = _frame()
X = DF.to_numpy()
MODELS = {
    "cd": dict(n_components=3),
    "mu": dict(n_components=3, solver="mu"),
    "kl": dict(n_components=3, solver="mu", beta_loss="kullback-leibler"),
    "legacy-alpha": dict(n_components=3, alpha=0.05, l1_ratio=0.3),
    "randomized": dict(n_components=3, svd_method="randomized", random_state=4),
    "mu-inner": dict(n_components=2, solver="mu", inner_iter=3, alpha_W=0.01),
}


def _both(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = j_select.NMFModel(**kw, **FIT)
        tm = select.NMFModel(**kw, **FIT, **CPU)
        return jm, jm.fit_transform(X), tm, tm.fit_transform(X)


def _close(mine, ref, tol=1e-8):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(MODELS))
def test_nmf_model_matches_jax(name):
    jm, jw, tm, tw = _both(MODELS[name])
    assert isinstance(tw, np.ndarray) and isinstance(tm.components_, np.ndarray)
    _close(tw, jw)
    _close(tm.components_, jm.components_)
    assert tm.n_iter_ == jm.n_iter_ and tm.n_components_ == jm.n_components_
    assert abs(tm.reconstruction_err_ - jm.reconstruction_err_) < 1e-8
    new = X[::-1] * 1.1  # a frame the model did not see
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(tm.transform(new), jm.transform(new))
    _close(tm.inverse_transform(tw), jm.inverse_transform(jw))


def test_cd_rank_one_factors_match_jax():
    jm, jw, tm, tw = _both(dict(n_components=1))
    _close(tw, jw)
    _close(tm.components_, jm.components_)


def test_custom_init_and_refusals(tmp_path):
    rng = np.random.default_rng(1)
    w0, h0 = rng.random((200, 2)), rng.random((2, 8))
    jm = j_select.NMFModel(2, init="custom", solver="mu", **FIT)
    tm = select.NMFModel(2, init="custom", solver="mu", **FIT, **CPU)
    _close(tm.fit_transform(X, w=w0, h=h0), jm.fit_transform(X, w=w0, h=h0))
    with pytest.raises(ValueError, match="custom"):
        tm.fit_transform(X)
    with pytest.raises(ValueError, match="Negative"):
        select.NMFModel(2, **CPU).fit_transform(-X)
    with pytest.raises(ValueError, match="beta_loss"):
        select.NMFModel(2, beta_loss="kullback-leibler", **CPU).fit_transform(X)
    with pytest.raises(ValueError, match="not fitted"):
        select.NMFModel(2, **CPU).transform(X)
    with pytest.raises(ValueError, match="regularization"):
        select.NMFModel(2, alpha=0.1, regularization="rows", **CPU)
    with pytest.raises(ValueError, match="not fitted"):
        select.NMFModel(2, **CPU).save(tmp_path / "model.npz")
    with pytest.raises(FileNotFoundError):
        select.NMFModel.load(tmp_path / "model.npz")
    with pytest.warns(UserWarning, match="Maximum number of iterations"):
        select.NMFModel(2, max_iter=5, **CPU).fit_transform(X)


@pytest.mark.parametrize("kw", [dict(), dict(solver="mu", alpha_W=0.01, l1_ratio=0.5),
                                dict(solver="mu", beta_loss="itakura-saito")],
                         ids=["cd", "mu-penalized", "is"])
@pytest.mark.parametrize("sweep", ["loop", "batched"])
def test_find_synergies_matches_jax(sweep, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = j_select.find_synergies(DF, 1, 4, sweep=sweep, **FIT, **kw)
        tres = mt.find_synergies(DF, 1, 4, sweep=sweep, **FIT, **kw, **CPU)
    assert list(tres.vaf_values.columns) == list(jres.vaf_values.columns)
    assert list(tres.vaf_values.index) == list(jres.vaf_values.index) == [1, 2, 3, 4]
    _close(tres.vaf_values.to_numpy(), jres.vaf_values.to_numpy())
    first = 1 if kw.get("solver", "cd") == "cd" else 0  # module docstring
    for k in (1, 2, 3, 4):
        _close(tres.components[k].to_numpy(), jres.components[k].to_numpy(), 1e-7)
        if k > first:
            assert tres.model[k].n_iter_ == jres.model[k].n_iter_
    single = mt.analysis.find_synergies(DF, 2, **FIT, **kw, **CPU)
    assert single.vaf_values.shape == (1, 9) and single.components.shape == (2, 8)


def test_find_synergies_refusals_and_config():
    with pytest.raises(ValueError, match="number of components"):
        mt.find_synergies(DF, 0, **CPU)
    with pytest.raises(ValueError, match="number of components"):
        mt.find_synergies(DF, 2, 9, **CPU)
    with pytest.raises(ValueError, match="sweep"):
        mt.find_synergies(DF, 1, 2, sweep="vmap", **CPU)
    with pytest.raises(ValueError, match="does not support"):
        mt.find_synergies(DF, 1, 2, sweep="batched", colour="red", **CPU)
    with pytest.raises(ValueError, match="empty"):
        mt.find_synergies(DF.iloc[:0], 1, **CPU)
    cfg = mt.PipelineConfig(min_rank=2, max_rank=3, max_iter=200, tol=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = j_select.find_synergies(DF, 2, 3, max_iter=200, tol=1e-4)
        tres = cfg.find_synergies(DF, **CPU)
    _close(tres.vaf_values.to_numpy(), jres.vaf_values.to_numpy())


@pytest.mark.parametrize("solver", ["cd", "mu"])
def test_rank_sweep_batch_matches_jax(solver):
    jstates, jvafs = j_batch.rank_sweep_batch(X, [1, 2, 4], solver=solver, **FIT)
    states, vafs = batch.rank_sweep_batch(X, [1, 2, 4], solver=solver, **FIT, **CPU)
    _close(vafs, jvafs)
    _close(states.w, jstates.w)
    first = 1 if solver == "cd" else 0
    np.testing.assert_array_equal(states.n_iter.numpy()[first:],
                                  np.asarray(jstates.n_iter)[first:])
    assert (states.w[0, :, 1:] == 0).all()  # padded components stay zero
    with pytest.raises(ValueError, match="solver='mu'"):
        batch.rank_sweep_batch(X, [1, 2], solver="cd", beta_loss=1.0, **CPU)


def test_kernel_route_is_chosen_from_the_shape():
    # the kernels hold a whole fit in one block's shared memory: a
    # time-normalised frame fits, a 20,000-sample one does not (on the
    # card the wrapper then raises, naming impl='torch' and device='cpu')
    assert mu_cuda.smem_bytes(200, 8, 4) <= mu_cuda.SMEM_LIMIT
    assert beta_cuda.smem_bytes(200, 8, 8) <= mu_cuda.SMEM_LIMIT
    assert mu_cuda.smem_bytes(20_000, 8, 4) > mu_cuda.SMEM_LIMIT
    # impl picks the fit: "auto" on a CPU frame is the plain fit, and
    # the kernel route refuses a frame that is not on the card
    auto = select.NMFModel(2, **FIT, **CPU).fit_transform(X)
    _close(select.NMFModel(2, impl="torch", **FIT, **CPU).fit_transform(X), auto, 0)
    with pytest.raises(ValueError, match="CUDA"):
        select.NMFModel(2, impl="cuda", **CPU).fit_transform(X)
    with pytest.raises(ValueError, match="CUDA"):
        batch.rank_sweep_batch(X, [1, 2], impl="cuda", **CPU)
    with pytest.raises(ValueError, match="impl"):
        select.NMFModel(2, impl="pallas", **CPU)


def test_randomized_svd_equals_the_jax_copy():
    for transpose in ("auto", True):
        mine = rsvd.randomized_svd(X, 3, transpose=transpose, random_state=2)
        theirs = j_rsvd.randomized_svd(X, 3, transpose=transpose, random_state=2)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_convert_a_fitted_jax_model():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = j_select.NMFModel(3, solver="mu", alpha=0.02, **FIT)
        jm.fit_transform(X)
        tm = convert.nmf_model(jm, **CPU)
        assert tm.n_iter_ == jm.n_iter_ and tm._legacy_alpha == jm._legacy_alpha
        np.testing.assert_array_equal(tm.components_, jm.components_)
        new = X * 0.9
        _close(tm.transform(new), jm.transform(new))
    assert not hasattr(convert.nmf_model(j_select.NMFModel(2), **CPU), "components_")
