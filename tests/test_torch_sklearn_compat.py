"""The PyTorch port's numpy copies of scikit-learn routines
(utils/sklearn_compat.py) against scikit-learn itself: the same seeds must
give the same arrays, folds and drawn parameters, exactly."""

import numpy as np
import pytest
from scipy.stats import loguniform, uniform
from sklearn.datasets import make_classification
from sklearn.model_selection import (
    KFold,
    ParameterGrid,
    ParameterSampler,
    StratifiedKFold,
    train_test_split,
)
from sklearn.utils.random import sample_without_replacement

from cs230_distributed_machine_learning_tpu_torch.utils import sklearn_compat as sc


# (n_population, n_samples): permutation, tracking selection, reservoir
@pytest.mark.parametrize("n_pop,n_draw", [(100, 30), (2 ** 30, 14), (10, 10), (1000, 5), (50, 48)])
def test_sample_without_replacement(n_pop, n_draw):
    want = sample_without_replacement(n_pop, n_draw, random_state=3)
    got = sc.sample_without_replacement(n_pop, n_draw, random_state=3)
    np.testing.assert_array_equal(got, want)


# covertype's generator, the synthetic_<n>x<d>x<c> generator, a wide one
# (784 features: the hypercube past 30 dimensions) and binary with repeats
_GEN = [
    dict(n_samples=2000, n_features=54, n_informative=30, n_redundant=10, n_classes=7,
         n_clusters_per_class=2, random_state=0),
    dict(n_samples=700, n_features=10, n_informative=5, n_classes=3, random_state=0),
    dict(n_samples=300, n_features=784, n_informative=392, n_classes=10, random_state=0),
    dict(n_samples=257, n_features=12, n_informative=4, n_redundant=2, n_repeated=3,
         flip_y=0.2, shift=None, scale=None, random_state=7),
]


@pytest.mark.parametrize("kw", _GEN, ids=["covertype", "synthetic", "wide", "repeated"])
def test_make_classification(kw):
    Xw, yw = make_classification(**kw)
    Xg, yg = sc.make_classification(**kw)
    assert Xg.dtype == Xw.dtype and yg.dtype == yw.dtype
    assert Xg.tobytes() == Xw.tobytes()
    np.testing.assert_array_equal(yg, yw)


_GRIDS = [
    {"C": [0.01, 0.1, 1.0], "tol": [1e-4, 1e-3]},
    [{"C": [1.0, 2.0]}, {"penalty": ["l2"], "C": [3.0], "fit_intercept": [True, False]}],
    {"C": np.geomspace(1e-3, 1e2, 5)},
]


@pytest.mark.parametrize("grid", _GRIDS, ids=["dict", "list", "array"])
def test_parameter_grid(grid):
    assert sc.parameter_grid(grid) == list(ParameterGrid(grid))


_DISTS = [
    ({"C": loguniform(1e-3, 1e2), "tol": [1e-4, 1e-3]}, 40),   # bench.py's space
    ({"C": [0.1, 1.0, 10.0], "tol": [1e-4, 1e-3]}, 4),          # lists: permutation
    ({"C": [0.1, 1.0], "tol": [1e-4, 1e-3]}, 9),                # lists: capped, reservoir
    ({"C": list(np.arange(300)), "tol": [1.0]}, 2),             # lists: tracking
    ([{"C": uniform(0, 4)}, {"C": [5.0, 6.0], "tol": loguniform(1e-5, 1e-2)}], 12),
]


@pytest.mark.parametrize("dists,n_iter", _DISTS, ids=["bench", "perm", "reservoir", "tracking",
                                                      "two_dicts"])
def test_parameter_sampler(dists, n_iter):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # n_iter above the grid size
        want = list(ParameterSampler(dists, n_iter=n_iter, random_state=0))
    assert sc.parameter_sampler(dists, n_iter, 0) == want


def _labels():
    rng = np.random.RandomState(0)
    return {
        "balanced": rng.randint(0, 3, 500),
        "skewed": np.where(rng.rand(613) < 0.05, 2, np.where(rng.rand(613) < 0.3, 0, 1)),
        "strings": np.array(["b", "a", "c"])[rng.randint(0, 3, 101)],
    }


@pytest.mark.parametrize("kind", ["balanced", "skewed", "strings"])
@pytest.mark.parametrize("n_splits", [3, 5])
def test_stratified_kfold(kind, n_splits):
    y = _labels()[kind]
    got = sc.stratified_kfold_test_folds(y, n_splits)
    for k, (_, test) in enumerate(StratifiedKFold(n_splits).split(np.zeros(len(y)), y)):
        np.testing.assert_array_equal(np.flatnonzero(got == k), test)


@pytest.mark.parametrize("n,n_splits", [(500, 5), (103, 4)])
def test_kfold(n, n_splits):
    got = sc.kfold_test_folds(n, n_splits)
    for k, (_, test) in enumerate(KFold(n_splits).split(np.zeros(n))):
        np.testing.assert_array_equal(np.flatnonzero(got == k), test)


@pytest.mark.parametrize("n,test_size,seed", [(500, 0.2, 42), (117, 0.33, 0), (90, 10, None)])
def test_train_test_split(n, test_size, seed):
    if seed is None:
        np.random.seed(5)
    want = train_test_split(np.arange(n), test_size=test_size, random_state=seed)
    if seed is None:
        np.random.seed(5)
    got = sc.train_test_split_indices(n, test_size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
