"""Single-trial decoding from synergy representations.

Port of :mod:`muscle_synergies_tpu.models.decode`, host code copied as
is.  The space-by-time model's headline use case (Delis, Panzeri, Pozzo
& Berret 2014): each trial is summarized by one small coefficient
matrix against the shared modules, and task conditions are decoded
from those coefficients with a cross-validated linear classifier; the
decoding accuracy measures how task-relevant a synergy representation
is.  The same recipe applies to any per-trial feature the package
produces (spatial-NMF loadings, convolutive activation statistics,
flattened coefficient matrices).

Classification is a small host-side problem (hundreds of trials x tens
of features), so it goes to scikit-learn's LDA and logistic solvers,
imported inside :func:`decode_trials`: the rest of the package needs no
scikit-learn.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["DecodeResult", "decode_trials"]


class DecodeResult(NamedTuple):
    """Cross-validated decoding outcome.

    Attributes:
        accuracy: mean accuracy across folds.
        fold_accuracies: ``(n_folds,)`` per-fold accuracies.
        confusion: ``(n_classes, n_classes)`` confusion matrix summed
            over the held-out folds (rows = true class).
        classes: the class labels, in confusion-matrix order.
        chance: the empirical chance level (largest class share) —
            the baseline to beat.
    """

    accuracy: float
    fold_accuracies: np.ndarray
    confusion: np.ndarray
    classes: np.ndarray
    chance: float


def decode_trials(
    features,
    labels,
    n_folds: int = 5,
    classifier: str = "lda",
    seed: int = 0,
    shuffle: bool = True,
) -> DecodeResult:
    """Decode task labels from per-trial synergy features.

    Args:
        features: ``(B, ...)`` per-trial features — e.g. the
            ``(B, P, Q)`` coefficients of
            :func:`~muscle_synergies_tpu_torch.models.nm3f.find_space_by_time_synergies`
            / ``NM3FModel.transform``, an ``(B, K)`` loading table, or
            any array whose leading axis is trials.  Trailing axes are
            flattened per trial.
        labels: ``(B,)`` class labels (any hashable values).
        n_folds: stratified cross-validation folds (capped at the
            smallest class count, min 2).
        classifier: ``"lda"`` (Fisher discriminant, the Delis et al.
            choice) or ``"logistic"``.
        seed: fold-shuffling seed.
        shuffle: shuffle trials before folding (keep True unless the
            trial order itself must be preserved).

    Returns:
        :class:`DecodeResult`; compare ``accuracy`` against
        ``chance``.
    """
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import confusion_matrix
    from sklearn.model_selection import StratifiedKFold

    x = np.asarray(features, dtype=float)
    if x.ndim < 2:
        raise ValueError(
            f"features must be (n_trials, ...), got shape {x.shape}"
        )
    x = x.reshape(x.shape[0], -1)
    y = np.asarray(labels)
    if y.shape != (x.shape[0],):
        raise ValueError(
            f"got {y.shape[0] if y.ndim else 0} labels for "
            f"{x.shape[0]} trials"
        )
    classes, counts = np.unique(y, return_counts=True)
    if classes.size < 2:
        raise ValueError("decoding needs at least two classes")
    n_folds = max(2, min(n_folds, int(counts.min())))
    if counts.min() < 2:
        raise ValueError(
            "every class needs at least two trials for stratified CV"
        )

    if classifier == "lda":
        # LDA's covariance fit needs more training trials than classes
        # in EVERY fold; fail with guidance instead of sklearn's
        # mid-CV error
        min_train = (y.size // n_folds) * (n_folds - 1)
        if min_train <= classes.size:
            raise ValueError(
                f"{y.size} trials over {n_folds} folds leaves "
                f"{min_train} training trials per fold — LDA needs "
                f"more than the {classes.size} classes; add trials "
                "or use classifier='logistic'"
            )
        make = lambda: LinearDiscriminantAnalysis()  # noqa: E731
    elif classifier == "logistic":
        make = lambda: LogisticRegression(max_iter=2000)  # noqa: E731
    else:
        raise ValueError(
            f"classifier must be 'lda' or 'logistic', got {classifier!r}"
        )

    folds = StratifiedKFold(
        n_splits=n_folds,
        shuffle=shuffle,
        random_state=seed if shuffle else None,
    )
    accs = []
    conf = np.zeros((classes.size, classes.size), dtype=int)
    for train, test in folds.split(x, y):
        model = make().fit(x[train], y[train])
        pred = model.predict(x[test])
        accs.append(float(np.mean(pred == y[test])))
        conf += confusion_matrix(y[test], pred, labels=classes)

    return DecodeResult(
        accuracy=float(np.mean(accs)),
        fold_accuracies=np.asarray(accs),
        confusion=conf,
        classes=classes,
        chance=float(counts.max() / counts.sum()),
    )
