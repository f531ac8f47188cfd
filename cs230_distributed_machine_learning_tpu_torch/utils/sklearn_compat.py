"""The scikit-learn routines the search path needs, in numpy, draw for draw.

The JAX package calls scikit-learn for the synthetic builtin datasets
(``make_classification``), the holdout and CV splits (``train_test_split``,
``StratifiedKFold``, ``KFold``), the search-space expansion
(``ParameterGrid``, ``ParameterSampler``) and the preprocessing's label
encoding (``LabelEncoder``). The port keeps its own copies so
that it runs where scikit-learn is not installed. Each makes the same calls
on the same ``numpy.random.RandomState`` in the same order as scikit-learn,
so the arrays, folds and drawn parameters are identical
(tests/test_torch_sklearn_compat.py and, for the label encoding,
tests/test_torch_preprocess.py hold each against scikit-learn).
"""

from __future__ import annotations

import itertools
import math
import numbers
from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import numpy as np


def check_random_state(seed) -> np.random.RandomState:
    """None -> numpy's global RandomState, int -> a new one, a RandomState
    -> itself."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def sample_without_replacement(n_population: int, n_samples: int,
                               random_state=None) -> np.ndarray:
    """``n_samples`` distinct integers of ``[0, n_population)``, by the
    method scikit-learn's ``"auto"`` picks from their ratio: a permutation,
    tracking selection, or reservoir sampling."""
    if n_population < 0 or n_samples > n_population:
        raise ValueError(f"cannot draw {n_samples} of {n_population} without replacement")
    rng = check_random_state(random_state)
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, dtype=np.intp)
    if ratio < 0.2:
        selected = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
    else:
        out[:] = np.arange(n_samples)
        for i in range(n_samples, n_population):
            j = rng.randint(0, i + 1)
            if j < n_samples:
                out[j] = i
    return out


# ---------------------------------------------------------------------------
# search-space expansion
# ---------------------------------------------------------------------------


def _as_list_of_dicts(grid) -> List[Dict[str, Any]]:
    return [grid] if isinstance(grid, Mapping) else list(grid)


def parameter_grid(grid) -> List[Dict[str, Any]]:
    """``list(ParameterGrid(grid))``: per dict, keys sorted, the last key
    cycling fastest."""
    out: List[Dict[str, Any]] = []
    for p in _as_list_of_dicts(grid):
        items = sorted(p.items())
        if not items:
            out.append({})
            continue
        keys, values = zip(*items)
        out.extend(dict(zip(keys, v)) for v in itertools.product(*values))
    return out


def parameter_sampler(distributions, n_iter: int, random_state=None) -> List[Dict[str, Any]]:
    """``list(ParameterSampler(distributions, n_iter, random_state))``: grid
    points without replacement when every value is a list, else per draw a
    dict, then per sorted key one ``rvs`` or one list pick."""
    dists = _as_list_of_dicts(distributions)
    rng = check_random_state(random_state)
    if all(not hasattr(v, "rvs") for d in dists for v in d.values()):
        grid = parameter_grid(dists)
        picks = sample_without_replacement(len(grid), min(n_iter, len(grid)), random_state=rng)
        return [grid[i] for i in picks]
    out = []
    for _ in range(n_iter):
        dist = rng.choice(dists)
        params = {}
        for k, v in sorted(dist.items()):
            params[k] = v.rvs(random_state=rng) if hasattr(v, "rvs") else v[rng.randint(len(v))]
        out.append(params)
    return out


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def label_encode(values) -> np.ndarray:
    """``LabelEncoder().fit_transform(values)``: each value's index among the
    sorted distinct values (int64). In an object array (pandas 3's
    ``astype(str)`` keeps nulls as NaN) the missing values sort last, None
    before NaN, as scikit-learn's ``_unique_python`` orders them."""
    values = np.asarray(values).reshape(-1)
    if values.dtype != object:
        return np.unique(values, return_inverse=True)[1].astype(np.int64).reshape(-1)

    def is_nan(v):
        return isinstance(v, numbers.Real) and not isinstance(v, numbers.Integral) and v != v

    present = sorted({v for v in values if v is not None and not is_nan(v)})
    index = {v: i for i, v in enumerate(present)}
    none_code = len(present)
    nan_code = none_code + any(v is None for v in values)
    return np.array([none_code if v is None else nan_code if is_nan(v) else index[v]
                     for v in values], dtype=np.int64)


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------


def train_test_split_indices(n: int, test_size, random_state=None) -> Tuple[np.ndarray, np.ndarray]:
    """``train_test_split(np.arange(n), test_size=..., random_state=...)``
    without stratification: one permutation, the test rows first."""
    if isinstance(test_size, numbers.Integral):
        n_test = int(test_size)
    else:
        n_test = math.ceil(float(test_size) * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} leaves no train or no test rows of {n}")
    perm = check_random_state(random_state).permutation(n)
    return perm[n_test:], perm[:n_test]


def stratified_kfold_test_folds(y: np.ndarray, n_splits: int) -> np.ndarray:
    """``StratifiedKFold(n_splits)`` without shuffling: the test fold of
    every row. Classes are taken in order of first appearance and dealt
    round-robin over the folds, in blocks that keep the rows' order."""
    y = np.asarray(y).ravel()
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         "members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)
    ])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    return test_folds


def kfold_test_folds(n: int, n_splits: int) -> np.ndarray:
    """``KFold(n_splits)`` without shuffling: contiguous folds, the first
    ``n % n_splits`` one row longer."""
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    return np.repeat(np.arange(n_splits), sizes).astype("i")


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


def _generate_hypercube(samples: int, dimensions: int, rng) -> np.ndarray:
    """Distinct binary vectors of length ``dimensions``."""
    if dimensions > 30:
        return np.hstack([
            rng.randint(2, size=(samples, dimensions - 30)),
            _generate_hypercube(samples, 30, rng),
        ])
    out = sample_without_replacement(2 ** dimensions, samples, random_state=rng)
    out = out.astype(dtype=">u4", copy=False)
    return np.unpackbits(out.view(">u1")).reshape((-1, 32))[:, -dimensions:]


def make_classification(n_samples=100, n_features=20, *, n_informative=2, n_redundant=2,
                        n_repeated=0, n_classes=2, n_clusters_per_class=2, flip_y=0.01,
                        class_sep=1.0, shift=0.0, scale=1.0, random_state=None):
    """``sklearn.datasets.make_classification`` with balanced classes, a
    hypercube of cluster centroids and shuffling (its defaults): Gaussian
    clusters about the vertices of a hypercube, redundant and repeated
    features, noise features, a fraction ``flip_y`` of labels redrawn.
    Returns ``(X float64 [n_samples, n_features], y int [n_samples])``."""
    generator = check_random_state(random_state)
    if n_informative + n_redundant + n_repeated > n_features:
        raise ValueError("Number of informative, redundant and repeated features must "
                         "sum to less than the number of total features")
    if n_informative < np.log2(n_classes * n_clusters_per_class):
        raise ValueError("n_classes * n_clusters_per_class must be smaller or equal "
                         "2**n_informative")
    weights = [1.0 / n_classes] * n_classes
    n_random = n_features - n_informative - n_redundant - n_repeated
    n_clusters = n_classes * n_clusters_per_class

    n_samples_per_cluster = [
        int(n_samples * weights[k % n_classes] / n_clusters_per_class)
        for k in range(n_clusters)
    ]
    for i in range(n_samples - sum(n_samples_per_cluster)):
        n_samples_per_cluster[i % n_clusters] += 1

    X = np.zeros((n_samples, n_features))
    y = np.zeros(n_samples, dtype=int)

    centroids = _generate_hypercube(n_clusters, n_informative, generator).astype(float, copy=False)
    centroids *= 2 * class_sep
    centroids -= class_sep

    X[:, :n_informative] = generator.standard_normal(size=(n_samples, n_informative))
    stop = 0
    for k, centroid in enumerate(centroids):
        start, stop = stop, stop + n_samples_per_cluster[k]
        y[start:stop] = k % n_classes
        X_k = X[start:stop, :n_informative]
        A = 2 * generator.uniform(size=(n_informative, n_informative)) - 1
        X_k[...] = np.dot(X_k, A)
        X_k += centroid

    if n_redundant > 0:
        B = 2 * generator.uniform(size=(n_informative, n_redundant)) - 1
        X[:, n_informative:n_informative + n_redundant] = np.dot(X[:, :n_informative], B)
    n = n_informative + n_redundant
    if n_repeated > 0:
        indices = ((n - 1) * generator.uniform(size=n_repeated) + 0.5).astype(np.intp)
        X[:, n:n + n_repeated] = X[:, indices]
    if n_random > 0:
        X[:, -n_random:] = generator.standard_normal(size=(n_samples, n_random))

    if flip_y >= 0.0:
        flip_mask = generator.uniform(size=n_samples) < flip_y
        y[flip_mask] = generator.randint(n_classes, size=flip_mask.sum())

    if shift is None:
        shift = (2 * generator.uniform(size=n_features) - 1) * class_sep
    X += shift
    if scale is None:
        scale = 1 + 100 * generator.uniform(size=n_features)
    X *= scale

    rows = np.arange(n_samples)
    generator.shuffle(rows)
    X, y = X[rows], y[rows]
    indices = np.arange(n_features)
    generator.shuffle(indices)
    X[:, :] = X[:, indices]
    return X, y
