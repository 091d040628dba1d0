"""PyTorch port: single-trial decoding against the JAX package.

``models.decode`` is host code copied from the JAX package, with
scikit-learn imported inside :func:`decode_trials`.  Held here to the
JAX package's on the same features: fold accuracies, the confusion
matrix, the classes and the chance level equal, for ``"lda"`` and
``"logistic"``, on NumPy and tensor features (the coefficients of the
port's space-by-time fit among them), and the refusals raising what the
JAX package raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("sklearn")

from muscle_synergies_tpu.models import decode as jdecode  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch.models import decode as tdecode  # noqa: E402


def _features(seed=100, n=36, classes=3):
    """``(n, 3, 2)`` coefficient-like features whose mean depends on the label."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.array(["walk", "run", "hop"][:classes]), n // classes)
    means = rng.random((classes, 3, 2))
    idx = np.searchsorted(np.unique(labels), labels)
    return means[idx] + 0.3 * rng.random((n, 3, 2)), labels


def _same(got, want):
    assert got.accuracy == want.accuracy and got.chance == want.chance
    np.testing.assert_array_equal(got.fold_accuracies, want.fold_accuracies)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_array_equal(got.classes, want.classes)


@pytest.mark.parametrize("classifier", ["lda", "logistic"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_decoding_matches_jax(classifier, shuffle):
    x, y = _features()
    kw = dict(n_folds=4, classifier=classifier, seed=3, shuffle=shuffle)
    got = tdecode.decode_trials(x, y, **kw)
    _same(got, jdecode.decode_trials(x, y, **kw))
    assert isinstance(got, tdecode.DecodeResult) and got.confusion.sum() == len(y)
    _same(tdecode.decode_trials(torch.as_tensor(x), y, **kw), got)


def test_decoding_the_space_by_time_coefficients_matches_jax():
    rng = np.random.default_rng(101)
    trials = np.abs(rng.standard_normal((12, 20, 4))) + np.repeat(
        np.linspace(0, 1, 3), 4)[:, None, None]
    labels = np.repeat([0, 1, 2], 4)
    res = mt.find_space_by_time_synergies(trials, 2, 2, max_iter=100, n_inits=2,
                                          device="cpu")
    for classifier in ("lda", "logistic"):
        kw = dict(n_folds=3, classifier=classifier)
        _same(mt.models.decode_trials(res.coefficients, labels, **kw),
              jdecode.decode_trials(res.coefficients, labels, **kw))


def _bad():
    x, y = _features()
    pair = [0, 1, 12, 13, 24, 25]  # two trials of each class
    return {
        "1-D features": (x[:, 0, 0], y, {}),
        "label count": (x, y[:-1], {}),
        "one class": (x, np.zeros(len(y)), {}),
        "singleton class": (x, np.append(y[:-1], "skip"), {}),
        "lda folds": (x[pair], y[pair], dict(n_folds=2)),
        "classifier": (x, y, dict(classifier="svm")),
    }


@pytest.mark.parametrize("case", list(_bad()))
def test_refusals_match_jax(case):
    x, y, kw = _bad()[case]
    with pytest.raises(ValueError) as jerr:
        jdecode.decode_trials(x, y, **kw)
    with pytest.raises(ValueError) as terr:
        tdecode.decode_trials(x, y, **kw)
    assert str(terr.value) == str(jerr.value)
