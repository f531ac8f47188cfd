"""Static-shape cross-validation: splits as weight masks.

The reference worker runs, per subtask, one ``train_test_split`` fit + eval
and a 5-fold ``cross_val_score`` on the full data — i.e. K+1 fits per trial
(``aws-prod/worker/worker.py:302-349``). On TPU, data-dependent subset shapes
would defeat XLA, so every split is expressed as a pair of {0,1} weight
vectors over the *full* (static-shape) dataset:

  row k of ``train_w`` selects the fit subset of split k,
  row k of ``eval_w``  selects the scoring subset of split k,

and kernels use weighted losses/metrics. Because sklearn's regularized
objectives are sums (not means) over samples, 0/1-weighting reproduces
fitting on the subset exactly.

Fold assignment itself is computed host-side with the port's numpy copies
of sklearn's splitters (utils/sklearn_compat.py), so fold boundaries (and
therefore CV scores and ``best_params_``) match sklearn bit-for-bit:
StratifiedKFold for classifiers, KFold for regressors — the same defaults
``cross_val_score(cv=5)`` uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.sklearn_compat import (
    kfold_test_folds,
    stratified_kfold_test_folds,
    train_test_split_indices,
)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """K+1 splits over n samples. Split 0 is the train/test holdout split
    (eval = test set); splits 1..K are the CV folds (eval = held-out fold)."""

    train_w: np.ndarray  # [K+1, n] float32 {0,1}
    eval_w: np.ndarray   # [K+1, n] float32 {0,1}
    n_folds: int
    #: content identity: (task, n, n_folds, test_size, random_state).
    #: Plans are deterministic in these, so equal signatures mean equal
    #: masks (the JAX package keys its device-staging cache on this).
    signature: tuple | None = None

    @property
    def n_splits(self) -> int:
        return self.train_w.shape[0]


def build_split_plan(
    y: np.ndarray,
    *,
    task: str,
    n_folds: int = 5,
    test_size: float = 0.2,
    random_state: int | None = 42,
) -> SplitPlan:
    """Build the K+1 split masks for one dataset.

    task: "classification" uses stratified folds + stratify-free holdout,
    "regression" uses plain KFold — matching sklearn's cross_val_score
    defaults and the reference worker's train_test_split usage (with its
    positional-arg bug fixed, see SURVEY.md §2.4).
    """
    n = len(y)
    train_idx, test_idx = train_test_split_indices(n, test_size, random_state)

    rows_train = [_mask(n, train_idx)]
    rows_eval = [_mask(n, test_idx)]

    if n_folds and n_folds >= 2:
        if task == "classification":
            test_folds = stratified_kfold_test_folds(y, n_folds)
        else:
            test_folds = kfold_test_folds(n, n_folds)
        for k in range(n_folds):
            rows_train.append((test_folds != k).astype(np.float32))
            rows_eval.append((test_folds == k).astype(np.float32))

    return SplitPlan(
        train_w=np.stack(rows_train).astype(np.float32),
        eval_w=np.stack(rows_eval).astype(np.float32),
        n_folds=n_folds or 0,
        signature=(task, n, n_folds or 0, float(test_size), random_state),
    )


def _mask(n: int, idx: np.ndarray) -> np.ndarray:
    m = np.zeros(n, dtype=np.float32)
    m[idx] = 1.0
    return m
