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


# ---------------------------------------------------------------------------
# GradientBoostingRegressor (the runtime predictor's model)
# ---------------------------------------------------------------------------

#: scikit-learn's tree constants: two feature values closer than this are
#: one candidate position, and a node whose impurity is at most the double
#: epsilon is a leaf
_FEATURE_THRESHOLD = 1e-7
_EPSILON = float(np.finfo(np.float64).eps)


_RAND_R_MAX = 2147483647


def _our_rand_r(state: List[int]) -> int:
    """scikit-learn's ``our_rand_r`` (sklearn/utils/_random.pxd): a 32-bit
    xorshift on ``state[0]``, reduced modulo 2^31."""
    seed = state[0] or 1
    seed ^= (seed << 13) & 0xFFFFFFFF
    seed ^= seed >> 17
    seed ^= (seed << 5) & 0xFFFFFFFF
    state[0] = seed
    return seed % (_RAND_R_MAX + 1)


def _simultaneous_sort(values: List[float], indices: List[int]) -> None:
    """scikit-learn's ``simultaneous_sort(..., use_three_way_partition=True)``
    (sklearn/utils/_sorting.pyx), in place on two lists: an introsort with
    Bentley-McIlroy's median of three, a 3-way partition, insertion sort
    below 16 elements and heapsort past the depth limit. Equal values land
    in its order, which the tree's sums follow."""

    def swap(i, j):
        values[i], values[j] = values[j], values[i]
        indices[i], indices[j] = indices[j], indices[i]

    def insertion(lo, n):
        for i in range(lo + 1, lo + n):
            tv, ti = values[i], indices[i]
            j = i
            while j > lo and values[j - 1] > tv:
                values[j], indices[j] = values[j - 1], indices[j - 1]
                j -= 1
            values[j], indices[j] = tv, ti

    def sift_down(lo, start, end):
        root = start
        while True:
            child = root * 2 + 1
            m = root
            if child < end and values[lo + m] < values[lo + child]:
                m = child
            if child + 1 < end and values[lo + m] < values[lo + child + 1]:
                m = child + 1
            if m == root:
                return
            swap(lo + root, lo + m)
            root = m

    def heapsort(lo, n):
        start = (n - 2) // 2
        while True:
            sift_down(lo, start, n)
            if start == 0:
                break
            start -= 1
        end = n - 1
        while end > 0:
            swap(lo, lo + end)
            sift_down(lo, 0, end)
            end -= 1

    def median3(lo, n):
        a, b, c = values[lo], values[lo + n // 2], values[lo + n - 1]
        if a < b:
            return b if b < c else (c if a < c else a)
        if b < c:
            return a if a < c else c
        return b

    def introsort(lo, n, maxd):
        while n > 15:
            if maxd <= 0:
                heapsort(lo, n)
                return
            maxd -= 1
            pivot = median3(lo, n)
            i, left, r = lo, lo, lo + n
            while i < r:
                v = values[i]
                if v < pivot:
                    values[i], values[left] = values[left], v
                    indices[i], indices[left] = indices[left], indices[i]
                    i += 1
                    left += 1
                elif v > pivot:
                    r -= 1
                    values[i], values[r] = values[r], v
                    indices[i], indices[r] = indices[r], indices[i]
                else:
                    i += 1
            left, r = left - lo, r - lo
            introsort(lo, left, maxd)
            lo += r
            n -= r
        insertion(lo, n)

    if values:
        introsort(0, len(values), 2 * int(math.log2(len(values))))


class _RegressionTree:
    """scikit-learn's ``DecisionTreeRegressor(splitter="best")`` fit on a
    float32 design and float64 targets with unit sample weights, depth
    first, exact splits, step for step: the node's rows in the splitter's
    order (each feature's sort reorders them, the chosen split partitions
    them in place), the features drawn in the splitter's Fisher-Yates order
    (its ``rand_r`` stream seeded with one ``randint(0, 2^31 - 1)`` of the
    caller's RandomState, with its constant-feature bookkeeping), the
    candidate positions between values more than 1e-7 apart, the criterion's
    sums added in its order (forward from the left, or back from the right
    when that is shorter), the squared-error proxy ``S_l^2 / n_l + S_r^2 /
    n_r`` with strictly greater winning, and the threshold at the midpoint
    ``a / 2 + b / 2`` of two adjacent float32 values, in float64. Where two
    features cut a node's rows into the same two sets, the proxies differ
    only by the order of their additions, and scikit-learn's choice rests on
    that rounding; copying every step keeps the same choice."""

    def __init__(self, max_depth: int = 3, min_samples_split: int = 2,
                 min_samples_leaf: int = 1):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf

    def fit(self, X32: np.ndarray, y: np.ndarray, random_state=None) -> "_RegressionTree":
        X = np.asarray(X32, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        rs = check_random_state(random_state)
        self._rand = [int(rs.randint(0, _RAND_R_MAX))]
        n_total = len(y)
        n_features = X.shape[1]
        self._features = list(range(n_features))
        self._constant = [0] * n_features
        feature, threshold, left, right, value = [], [], [], [], []

        def add_node():
            for arr, v in ((feature, -2), (threshold, -2.0), (left, -1), (right, -1),
                           (value, 0.0)):
                arr.append(v)
            return len(value) - 1

        # (node id, its rows in the splitter's order, depth, impurity or
        # None at the root, known constant features)
        stack = [(add_node(), np.arange(n_total), 0, None, 0)]
        while stack:
            node, rows, depth, impurity, n_const = stack.pop()
            n = len(rows)
            yn = y[rows]
            # the criterion's node sums, added in the rows' order
            total = float(np.cumsum(yn)[-1])
            sq_total = float(np.cumsum(yn * yn)[-1])
            value[node] = total / n
            if impurity is None:
                impurity = sq_total / n - (total / n) ** 2
            is_leaf = (depth >= self.max_depth or n < self.min_samples_split
                       or n < 2 * self.min_samples_leaf or impurity <= _EPSILON)
            if is_leaf:
                continue
            split, n_const = self._best_split(X, y, rows, total, sq_total, n_total,
                                              impurity, n_const)
            if split is None:
                continue
            f, thr, li, ri, imp_l, imp_r = split
            feature[node], threshold[node] = f, thr
            lnode = add_node()
            rnode = add_node()
            left[node], right[node] = lnode, rnode
            # the right child is pushed first, so the left pops first (the
            # order of the splitter's draws)
            stack.append((rnode, ri, depth + 1, imp_r, n_const))
            stack.append((lnode, li, depth + 1, imp_l, n_const))
        self.feature_ = np.asarray(feature, dtype=np.int64)
        self.threshold_ = np.asarray(threshold, dtype=np.float64)
        self.left_ = np.asarray(left, dtype=np.int64)
        self.right_ = np.asarray(right, dtype=np.int64)
        self.value_ = np.asarray(value, dtype=np.float64)
        del self._rand, self._features, self._constant
        return self

    @staticmethod
    def _left_sums(ys: np.ndarray, pos: np.ndarray, total: float) -> np.ndarray:
        """The criterion's ``sum_left`` at each candidate position, added as
        its ``update`` adds them: forward from the last position, or, when
        the rows left to the end are fewer, down from ``total`` by
        subtracting from the end. ``np.cumsum`` adds in sequence, so each
        run of forward steps is one cumsum from the run's start."""
        n, m = len(ys), len(pos)
        pl = pos.tolist()
        out = np.empty(m)
        acc, at, k = 0.0, 0, 0
        while k < m:
            p = pl[k]
            if p - at > n - p:  # reverse_reset, then subtract from the end
                acc = float(np.cumsum(np.concatenate([[total], -ys[p:][::-1]]))[-1])
                out[k], at, k = acc, p, k + 1
                continue
            j, last = k, at
            while j < m and pl[j] - last <= n - pl[j]:
                last = pl[j]
                j += 1
            run = np.cumsum(np.concatenate([[acc], ys[at:last]]))
            out[k:j] = run[pos[k:j] - at]
            acc, at, k = float(run[-1]), last, j
        return out

    def _best_split(self, X, y, rows, total, sq_total, n_total, impurity, n_known):
        """scikit-learn's ``node_split_best`` with ``max_features`` = all:
        returns (the split or None, the constant features known below)."""
        n = len(rows)
        msl = self.min_samples_leaf
        features, constant = self._features, self._constant
        best = None
        best_proxy = -np.inf
        f_i = len(features)
        n_visited = n_found = n_drawn = 0
        n_total_const = n_known
        while f_i > n_total_const and (n_visited < len(features)
                                       or n_visited <= n_found + n_drawn):
            n_visited += 1
            lo, hi = n_drawn, f_i - n_found
            f_j = lo + _our_rand_r(self._rand) % (hi - lo)
            if f_j < n_known:
                features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            f = features[f_j]
            # the splitter sorts its rows in place by the drawn feature;
            # distinct values have one sorted order, repeated ones take the
            # introsort's
            xf = X[rows, f]
            n_distinct = len(np.unique(xf))
            if n_distinct == len(xf):
                rows = rows[np.argsort(xf)]
            elif n_distinct > 1:  # all equal: the introsort moves nothing
                vals, idx = xf.tolist(), rows.tolist()
                _simultaneous_sort(vals, idx)
                rows = np.asarray(idx)
            xs = X[rows, f].astype(np.float64)
            if xs[-1] <= xs[0] + _FEATURE_THRESHOLD:
                features[f_j], features[n_total_const] = features[n_total_const], features[f_j]
                n_found += 1
                n_total_const += 1
                continue
            f_i -= 1
            features[f_i], features[f_j] = features[f_j], features[f_i]
            # position p splits [0, p) | [p, n) where the values at p-1 and
            # p differ by more than the feature threshold
            pos = np.nonzero(xs[1:] > xs[:-1] + _FEATURE_THRESHOLD)[0] + 1
            pos = pos[(pos >= msl) & (n - pos >= msl)]
            if len(pos) == 0:
                continue
            sl = self._left_sums(y[rows], pos, total)
            sr = total - sl
            nl = pos.astype(np.float64)
            proxy = sl * sl / nl + sr * sr / (n - nl)
            j = int(np.argmax(proxy))
            if proxy[j] > best_proxy:
                best_proxy = float(proxy[j])
                p = int(pos[j])
                thr = xs[p - 1] / 2.0 + xs[p] / 2.0
                if thr == xs[p] or np.isinf(thr):
                    thr = xs[p - 1]
                best = (f, float(thr), p)
        # the splitter's invariant: the known constants keep their order for
        # the siblings and children, the new ones follow them
        features[:n_known] = constant[:n_known]
        constant[n_known:n_total_const] = features[n_known:n_total_const]
        if best is None:
            return None, n_total_const
        f, thr, p = best
        # partition_samples_final: in place, from both ends
        order = rows.tolist()
        go_left = (X[rows, f].astype(np.float64) <= thr).tolist()
        side = dict(zip(order, go_left))
        a, b = 0, n
        while a < b:
            if side[order[a]]:
                a += 1
            else:
                b -= 1
                order[a], order[b] = order[b], order[a]
        rows = np.asarray(order)
        li, ri = rows[:p], rows[p:]
        # the children's impurities, from the criterion's sums after update(p)
        ys = y[rows]
        sl = float(self._left_sums(ys, np.asarray([p]), total)[0])
        sq_l = float(np.cumsum(ys[:p] * ys[:p])[-1])
        nl, nr = float(p), float(n - p)
        imp_l = sq_l / nl - (sl / nl) ** 2
        imp_r = (sq_total - sq_l) / nr - ((total - sl) / nr) ** 2
        improvement = (n / n_total) * (impurity - nr / n * imp_r - nl / n * imp_l)
        if improvement + _EPSILON < 0.0:
            return None, n_total_const
        return (f, thr, li, ri, imp_l, imp_r), n_total_const

    def apply(self, X32: np.ndarray) -> np.ndarray:
        X = np.asarray(X32, dtype=np.float32)
        node = np.zeros(len(X), dtype=np.int64)
        rows = np.arange(len(X))
        for _ in range(self.max_depth + 1):
            inner = self.left_[node] >= 0
            if not inner.any():
                break
            r, nd = rows[inner], node[inner]
            go_left = X[r, self.feature_[nd]].astype(np.float64) <= self.threshold_[nd]
            node[r] = np.where(go_left, self.left_[nd], self.right_[nd])
        return node

    def predict(self, X32: np.ndarray) -> np.ndarray:
        return self.value_[self.apply(X32)]


class GradientBoostingRegressor:
    """scikit-learn's ``GradientBoostingRegressor(random_state=0)`` with its
    defaults, for the runtime predictor: squared error, the mean as the
    initial prediction, 100 stages of a depth-3 regression tree on the
    residuals (exact splits on the float32 design), learning rate 0.1, no
    subsampling, the feature draws of ``random_state``. scikit-learn 1.9 fits the stage trees with the squared-error
    criterion; ``friedman_mse``'s proxy is an affine map of it, so the two
    choose the same splits up to rounding. ``state()`` / ``from_state()``
    carry the fitted stages as plain arrays (the predictor's ``.npz``)."""

    def __init__(self, n_estimators: int = 100, learning_rate: float = 0.1,
                 max_depth: int = 3, random_state=0):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.random_state = random_state

    def fit(self, X, y) -> "GradientBoostingRegressor":
        X32 = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        # one RandomState across the stages; each stage's tree draws its
        # splitter's seed from it, as scikit-learn's do
        rng = check_random_state(self.random_state)
        self.init_ = float(np.average(y, weights=np.ones_like(y)))
        raw = np.full(len(y), self.init_, dtype=np.float64)
        self.estimators_ = []
        for _ in range(self.n_estimators):
            tree = _RegressionTree(max_depth=self.max_depth).fit(X32, -(raw - y), rng)
            raw += self.learning_rate * tree.predict(X32)
            self.estimators_.append(tree)
        return self

    def predict(self, X) -> np.ndarray:
        """All stages at once (the runtime predictor prices one task a
        call): the trees walk their levels side by side, then the stage
        values are added in stage order onto the initial prediction, as
        scikit-learn's ``predict_stages`` adds them."""
        X32 = np.asarray(X, dtype=np.float32)
        feat, thr, left, right, val = self._stacked()
        T, n = feat.shape[0], len(X32)
        trees = np.arange(T)[:, None]
        rows = np.arange(n)[None, :]
        node = np.zeros((T, n), dtype=np.int64)
        for _ in range(self.max_depth + 1):
            lft = left[trees, node]
            go = X32[rows, np.maximum(feat[trees, node], 0)].astype(np.float64) <= thr[trees, node]
            node = np.where(lft >= 0, np.where(go, lft, right[trees, node]), node)
        terms = np.concatenate([np.full((1, n), self.init_),
                                self.learning_rate * val[trees, node]])
        return np.cumsum(terms, axis=0)[-1]

    def _stacked(self):
        """The stages' node arrays padded to one width: [stages, nodes]."""
        cached = getattr(self, "_stack", None)
        if cached is not None:
            return cached
        width = max(len(t.value_) for t in self.estimators_)
        out = []
        for field, fill in (("feature_", -2), ("threshold_", -2.0), ("left_", -1),
                            ("right_", -1), ("value_", 0.0)):
            arr = np.full((len(self.estimators_), width), fill,
                          dtype=getattr(self.estimators_[0], field).dtype)
            for i, t in enumerate(self.estimators_):
                arr[i, :len(t.value_)] = getattr(t, field)
            out.append(arr)
        self._stack = tuple(out)
        return self._stack

    _TREE_FIELDS = ("feature_", "threshold_", "left_", "right_", "value_")

    def state(self) -> Dict[str, np.ndarray]:
        """The fitted model as named arrays: each tree field concatenated
        over the stages, with the stages' node offsets."""
        sizes = [len(t.value_) for t in self.estimators_]
        out = {"init": np.asarray([self.init_]),
               "params": np.asarray([self.n_estimators, self.learning_rate, self.max_depth],
                                    dtype=np.float64),
               "offsets": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)}
        for field in self._TREE_FIELDS:
            out[field.rstrip("_")] = np.concatenate([getattr(t, field) for t in self.estimators_])
        return out

    @classmethod
    def from_state(cls, state) -> "GradientBoostingRegressor":
        n_est, lr, depth = (float(v) for v in state["params"])
        model = cls(n_estimators=int(n_est), learning_rate=lr, max_depth=int(depth))
        model.init_ = float(state["init"][0])
        off = state["offsets"]
        model.estimators_ = []
        for i in range(len(off) - 1):
            tree = _RegressionTree(max_depth=model.max_depth)
            for field in cls._TREE_FIELDS:
                setattr(tree, field, np.asarray(state[field.rstrip("_")][off[i]:off[i + 1]]))
            model.estimators_.append(tree)
        return model
