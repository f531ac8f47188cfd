"""Export fitted kernel artifacts to real sklearn estimators.

A copy of the JAX package's ``runtime/sklearn_export.py`` (it imports only
numpy and scikit-learn, so it is framework-free, and the port imports
nothing of the JAX package): the artifact layout is the same in both
packages, so the same translation serves both. runtime/artifacts.py's
``to_sklearn`` calls it once scikit-learn is known to be installed.

Parity target: the reference serves a pickle any sklearn user can
``.predict()`` with (``aws-prod/worker/worker.py:352-356``,
``aws-prod/master/master.py:270-291``). Our artifacts are plain dicts of
numpy arrays (runtime/artifacts.py); this module CONSTRUCTS the matching
sklearn estimator and injects the fitted state — so a user migrating off
the reference can drop the winner into an existing sklearn pipeline, for
every model family, not just linear ones.

Injection contracts (held per family in tests/test_torch_artifacts.py):
the exported estimator's ``predict`` matches the kernel's predictions on
held-out data. Trees translate binned splits (feature, bin) into float
thresholds via the stored quantile edges; boosting folds the prior into
stage 0 so ``init='zero'`` reproduces the raw scores exactly; SVC repacks
the OvO duals into libsvm's class-grouped layout.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List

import numpy as np


def to_sklearn(artifact: Dict[str, Any]):
    """Build a fitted sklearn estimator equivalent to the artifact.

    Raises NotImplementedError for the one unrepresentable case
    (multiclass Nyström SVC — sklearn has no OvO-voting linear-feature
    form; use ``predict_with_artifact`` for those).
    """
    mt = artifact["model_type"]
    fn = _EXPORTERS.get(mt)
    if fn is None:
        raise NotImplementedError(
            f"no sklearn export for model_type {mt!r} "
            f"(supported: {sorted(_EXPORTERS)}); predict_with_artifact "
            "always works"
        )
    return fn(artifact)


def _ctor(cls, params: Dict[str, Any]):
    """Construct ``cls`` with the subset of ``params`` its __init__ takes,
    so get_params round-trips and repr shows the real hyperparameters."""
    sig = inspect.signature(cls.__init__)
    kept = {}
    for k, v in (params or {}).items():
        if k in sig.parameters and k != "self":
            kept[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kept)


def _np64(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.float64)


# ---------------------------------------------------------------------------
# linear family
# ---------------------------------------------------------------------------


def _export_logistic(a):
    from sklearn.linear_model import LogisticRegression

    W = np.asarray(a["fitted_params"])  # [d(+1), c]
    st = a["static"]
    fit_intercept = bool(st.get("fit_intercept", True))
    c = W.shape[1]
    if fit_intercept:
        coef, inter = W[:-1].T, W[-1]
    else:
        coef, inter = W.T, np.zeros(c, np.float32)
    if c == 2:
        # sklearn stores the single class-1 logit for binary problems; the
        # 2-column softmax's logit difference is that logit (models/logistic.py)
        coef = (coef[1] - coef[0])[None, :]
        inter = np.asarray([inter[1] - inter[0]])
    est = _ctor(LogisticRegression, a["parameters"])
    est.coef_ = _np64(coef)
    est.intercept_ = _np64(inter)
    est.classes_ = np.arange(c)
    est.n_features_in_ = int(est.coef_.shape[1])
    est.n_iter_ = np.asarray([int(a["parameters"].get("max_iter", 100))])
    return est


def _export_linear(cls_name):
    def export(a):
        import sklearn.linear_model as lm

        cls = getattr(lm, cls_name)
        W = np.asarray(a["fitted_params"])  # [d(+1)]
        fit_intercept = bool(a["static"].get("fit_intercept", True))
        est = _ctor(cls, a["parameters"])
        if fit_intercept:
            est.coef_ = _np64(W[:-1])
            est.intercept_ = float(W[-1])
        else:
            est.coef_ = _np64(W)
            est.intercept_ = 0.0
        est.n_features_in_ = int(est.coef_.shape[0])
        return est

    return export


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _export_mlp(classifier: bool):
    def export(a):
        from sklearn.neural_network import MLPClassifier, MLPRegressor
        from sklearn.preprocessing import LabelBinarizer

        layers: List[Dict[str, np.ndarray]] = a["fitted_params"]
        coefs = [_np64(layer["W"]) for layer in layers]
        inters = [_np64(layer["b"]) for layer in layers]
        cls = MLPClassifier if classifier else MLPRegressor
        est = _ctor(cls, a["parameters"])
        c = int(a["static"].get("_n_classes", 2))
        if classifier and c == 2:
            # our binary head is a 2-unit softmax; sklearn's is a single
            # logistic unit — convert via the logit difference
            coefs[-1] = (coefs[-1][:, 1] - coefs[-1][:, 0])[:, None]
            inters[-1] = np.asarray([inters[-1][1] - inters[-1][0]])
        est.coefs_ = coefs
        est.intercepts_ = inters
        est.n_layers_ = len(coefs) + 1
        est.n_features_in_ = int(coefs[0].shape[0])
        est.activation = a["static"].get("activation", "relu")
        if classifier:
            est.n_outputs_ = int(coefs[-1].shape[1])
            est.out_activation_ = "logistic" if c == 2 else "softmax"
            est.classes_ = np.arange(c)
            est._label_binarizer = LabelBinarizer().fit(est.classes_)
        else:
            est.n_outputs_ = 1
            est.out_activation_ = "identity"
        return est

    return export


# ---------------------------------------------------------------------------
# KNN: the fitted state IS the training data — refit sklearn on it
# ---------------------------------------------------------------------------


def _export_knn(classifier: bool):
    def export(a):
        from sklearn.neighbors import KNeighborsClassifier, KNeighborsRegressor

        fp = a["fitted_params"]
        X, y, w = np.asarray(fp["X"]), np.asarray(fp["y"]), np.asarray(fp["w"])
        keep = w > 0
        cls = KNeighborsClassifier if classifier else KNeighborsRegressor
        est = _ctor(cls, a["parameters"])
        return est.fit(X[keep], y[keep].astype(int) if classifier else y[keep])

    return export


# ---------------------------------------------------------------------------
# trees: binned splits -> float thresholds via the stored quantile edges
# ---------------------------------------------------------------------------


def _threshold(edges_f: np.ndarray, b: int) -> float:
    """Our routing: go left iff bin_code <= b iff x < edges_f[b]
    (bin_data uses searchsorted side='right'). sklearn routes left iff
    x <= threshold, so the threshold is the largest double below the edge.
    b >= len(edges) encodes a pass-through node (everything left)."""
    if b >= len(edges_f):
        return np.inf
    return float(np.nextafter(np.float64(np.float32(edges_f[b])), -np.inf))


def _sk_tree(n_features: int, n_classes: int, nodes: List[dict], max_depth: int):
    """Assemble an sklearn.tree._tree.Tree from a node list with
    left/right/feature/threshold/value entries (leaves: left == -1)."""
    from sklearn.tree._tree import NODE_DTYPE, Tree

    k = max(n_classes, 1)
    tree = Tree(n_features, np.asarray([k], dtype=np.intp), 1)
    arr = np.zeros(len(nodes), dtype=NODE_DTYPE)
    values = np.zeros((len(nodes), 1, k), dtype=np.float64)
    for i, nd in enumerate(nodes):
        leaf = nd["left"] == -1
        arr[i] = (
            nd["left"],
            nd["right"],
            -2 if leaf else nd["feature"],
            -2.0 if leaf else nd["threshold"],
            0.0,
            max(int(nd.get("n_samples", 1)), 1),
            max(float(nd.get("weight", 1.0)), 1e-12),
            0,
        )
        values[i, 0, :] = nd.get("value", np.zeros(k))
    tree.__setstate__(
        {"max_depth": max_depth, "node_count": len(nodes), "nodes": arr, "values": values}
    )
    return tree


def _complete_tree_nodes(tree: Dict[str, np.ndarray], edges: np.ndarray, depth: int):
    """Heap-layout complete tree {split_feat, split_bin, leaf_val} ->
    sklearn node list (preorder)."""
    split_feat = np.asarray(tree["split_feat"])
    split_bin = np.asarray(tree["split_bin"])
    leaf_val = np.asarray(tree["leaf_val"])  # [2^depth, k]
    leaf_weight = np.asarray(tree.get("leaf_weight", np.ones(leaf_val.shape[0])))
    nodes: List[dict] = []

    def emit(heap: int, level: int) -> int:
        idx = len(nodes)
        if level == depth:  # leaf
            j = heap - (2**depth - 1)
            nodes.append(
                {"left": -1, "right": -1, "feature": -2, "threshold": -2.0,
                 "value": leaf_val[j], "weight": float(leaf_weight[j]),
                 "n_samples": max(int(round(float(leaf_weight[j]))), 1)}
            )
            return idx
        f, b = int(split_feat[heap]), int(split_bin[heap])
        nodes.append({})  # placeholder, fill after children exist
        left = emit(2 * heap + 1, level + 1)
        right = emit(2 * heap + 2, level + 1)
        nodes[idx] = {
            "left": left, "right": right, "feature": f,
            "threshold": _threshold(edges[f], b),
            "value": np.zeros(leaf_val.shape[1]),
        }
        return idx

    emit(0, 0)
    return nodes, depth


def _arena_tree_nodes(tree: Dict[str, np.ndarray], edges: np.ndarray, levels: int):
    """Deep arena tree {feat, bin, child, leaf_val} -> sklearn node list.
    ``child[i]`` is the left-child arena slot (0 = leaf; right = left+1)."""
    feat = np.asarray(tree["feat"])
    bin_ = np.asarray(tree["bin"])
    child = np.asarray(tree["child"])
    leaf_val = np.asarray(tree["leaf_val"])
    leaf_weight = np.asarray(tree.get("leaf_weight", np.ones(leaf_val.shape[0])))
    nodes: List[dict] = []
    max_d = [0]

    def emit(slot: int, d: int) -> int:
        idx = len(nodes)
        max_d[0] = max(max_d[0], d)
        c = int(child[slot])
        if c == 0 or d >= levels:  # leaf
            nodes.append(
                {"left": -1, "right": -1, "feature": -2, "threshold": -2.0,
                 "value": leaf_val[slot], "weight": float(leaf_weight[slot]),
                 "n_samples": max(int(round(float(leaf_weight[slot]))), 1)}
            )
            return idx
        f, b = int(feat[slot]), int(bin_[slot])
        nodes.append({})
        left = emit(c, d + 1)
        right = emit(c + 1, d + 1)
        nodes[idx] = {
            "left": left, "right": right, "feature": f,
            "threshold": _threshold(edges[f], b),
            "value": np.zeros(leaf_val.shape[1]),
        }
        return idx

    # the arena root is always slot 0 (build_tree_deep routes from node 0;
    # child[0] == 0 just means the root never split — a single-leaf tree)
    emit(0, 0)
    return nodes, max_d[0]


def _tree_from_artifact(tree_dict, edges, static, n_classes):
    if "split_feat" in tree_dict:
        nodes, d = _complete_tree_nodes(tree_dict, edges, int(static["_depth"]))
    else:
        nodes, d = _arena_tree_nodes(
            tree_dict, edges, int(static.get("_levels", static["_depth"]))
        )
    n_features = edges.shape[0]
    return _sk_tree(n_features, n_classes, nodes, d)


def _stacked(trees: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v)[i] for k, v in trees.items()}


def _export_decision_tree(classifier: bool):
    def export(a):
        from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

        fp, st = a["fitted_params"], a["static"]
        c = int(st.get("_n_classes", 0)) if classifier else 0
        k = max(c, 2) if classifier else 1
        skt = _tree_from_artifact(fp["tree"], np.asarray(fp["edges"]), st, k)
        cls = DecisionTreeClassifier if classifier else DecisionTreeRegressor
        est = _ctor(cls, a["parameters"])
        est.tree_ = skt
        est.n_features_in_ = int(np.asarray(fp["edges"]).shape[0])
        est.n_outputs_ = 1
        if classifier:
            est.classes_ = np.arange(k)
            est.n_classes_ = k
        est.max_features_ = est.n_features_in_
        return est

    return export


def _export_forest(classifier: bool):
    def export(a):
        from sklearn.ensemble import RandomForestClassifier, RandomForestRegressor
        from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

        fp, st = a["fitted_params"], a["static"]
        edges = np.asarray(fp["edges"])
        c = int(st.get("_n_classes", 0)) if classifier else 0
        k = max(c, 2) if classifier else 1
        n_trees = int(np.asarray(fp["trees"]["leaf_val"]).shape[0])
        sub_cls = DecisionTreeClassifier if classifier else DecisionTreeRegressor
        subs = []
        for i in range(n_trees):
            skt = _tree_from_artifact(_stacked(fp["trees"], i), edges, st, k)
            sub = sub_cls()
            sub.tree_ = skt
            sub.n_features_in_ = int(edges.shape[0])
            sub.n_outputs_ = 1
            if classifier:
                sub.classes_ = np.arange(k)
                sub.n_classes_ = k
            subs.append(sub)
        cls = RandomForestClassifier if classifier else RandomForestRegressor
        est = _ctor(cls, a["parameters"])
        est.estimators_ = subs
        est.n_features_in_ = int(edges.shape[0])
        est.n_outputs_ = 1
        if classifier:
            est.classes_ = np.arange(k)
            est.n_classes_ = k
        return est

    return export


def _export_gradient_boosting(classifier: bool):
    def export(a):
        from sklearn.ensemble import (
            GradientBoostingClassifier,
            GradientBoostingRegressor,
        )
        from sklearn.tree import DecisionTreeRegressor

        fp, st = a["fitted_params"], a["static"]
        edges = np.asarray(fp["edges"])
        lr = float(np.asarray(fp["lr"]))
        prior = np.asarray(fp["prior"])
        trees = fp["trees"]
        leaf_val = np.asarray(trees["leaf_val"])
        c = int(st.get("_n_classes", 0)) if classifier else 0
        if classifier:
            n_stages, kdim = leaf_val.shape[0], leaf_val.shape[1]
            # our raw scores: F = F0 + lr * leaf_scale * sum(stage deltas)
            # (binary: F[:, 1] only). sklearn with init='zero': raw =
            # lr * sum(tree values) — fold leaf_scale into the values and
            # F0 into stage 0.
            leaf_scale = (c - 1) / c if c > 2 else 1.0
            if c > 2:
                raw0 = prior  # [c]
            else:
                raw0 = np.asarray([prior[1] - prior[0]])  # single logit
        else:
            n_stages, kdim = leaf_val.shape[0], 1
            leaf_scale = 1.0
            raw0 = np.asarray([float(prior)])

        ests = np.empty((n_stages, kdim), dtype=object)
        for s in range(n_stages):
            for j in range(kdim):
                if classifier:  # stage trees carry a kdim axis (1 for binary)
                    td = {kk: np.asarray(v)[s, j] for kk, v in trees.items()}
                else:
                    td = {kk: np.asarray(v)[s] for kk, v in trees.items()}
                lv = np.asarray(td["leaf_val"], np.float64) * leaf_scale
                if s == 0:
                    lv = lv + raw0[j] / lr
                td["leaf_val"] = lv
                skt = _tree_from_artifact(td, edges, st, 1)
                sub = DecisionTreeRegressor()
                sub.tree_ = skt
                sub.n_features_in_ = int(edges.shape[0])
                sub.n_outputs_ = 1
                ests[s, j] = sub

        cls = GradientBoostingClassifier if classifier else GradientBoostingRegressor
        est = _ctor(cls, a["parameters"])
        est.estimators_ = ests
        est.init_ = "zero"
        est.init = "zero"
        est.learning_rate = lr
        est.n_features_in_ = int(edges.shape[0])
        est.n_estimators_ = n_stages
        est.n_trees_per_iteration_ = kdim
        if classifier:
            est.classes_ = np.arange(max(c, 2))
            est.n_classes_ = max(c, 2)
        return est

    return export


# ---------------------------------------------------------------------------
# SVM: repack OvO duals into libsvm's class-grouped layout
# ---------------------------------------------------------------------------


def _svc_kernel_params(a):
    st = a["static"]
    return {
        "kernel": st.get("kernel", "rbf"),
        "degree": int(st.get("degree", 3)),
        "coef0": float(st.get("coef0", 0.0)),
    }


def _export_svc(a):
    from sklearn.svm import SVC

    fp = a["fitted_params"]
    if "W" in fp:
        return _export_svc_nystrom(a)
    X = np.asarray(fp["X"])
    dual = np.asarray(fp["dual"])  # [n_pairs, n] signed alpha (t * alpha)
    intercept = np.asarray(fp["intercept"])  # [n_pairs]
    pa = np.asarray(fp["pairs_a"])
    pb = np.asarray(fp["pairs_b"])
    c = int(np.max(pb)) + 1 if len(pb) else 2
    n = X.shape[0]

    # infer each row's class from the signs is unreliable for non-SVs; the
    # artifact doesn't store y, but every row's class is recoverable from
    # which pair-columns are nonzero only for SVs. Instead keep EVERY row as
    # a "support vector" with zero coefficients where inactive — libsvm
    # predict is a plain weighted kernel sum, so zero rows are harmless.
    # Rows must be grouped by class; recover class labels from the stored
    # training targets when present, else from sign structure.
    y = np.asarray(fp["y"]) if "y" in fp else _infer_classes(dual, pa, pb, c, n)

    order = np.argsort(y, kind="stable")
    Xs = X[order]
    ys = y[order]
    n_support = np.asarray([int(np.sum(ys == i)) for i in range(c)], np.int32)

    # _dual_coef_ rows: for an SV of class i, row r holds its coefficient in
    # the machine (i vs other) where other = r if r < i else r + 1
    pair_index = {(int(pa[p]), int(pb[p])): p for p in range(len(pa))}
    dc = np.zeros((c - 1, n), np.float64)
    ds = dual[:, order]
    for v in range(n):
        i = int(ys[v])
        for r in range(c - 1):
            other = r if r < i else r + 1
            p = pair_index[(min(i, other), max(i, other))]
            dc[r, v] = ds[p, v]
    est = _ctor(SVC, a["parameters"])
    est._sparse = False
    est.support_ = order.astype(np.int32)
    est.support_vectors_ = _np64(Xs)
    est._n_support = n_support
    est._dual_coef_ = dc
    est._intercept_ = _np64(intercept)
    # sklearn's public attrs negate the libsvm internals for BINARY models
    # only (BaseLibSVM.fit flips both iff len(classes_) == 2)
    if c == 2:
        est.dual_coef_ = -dc
        est.intercept_ = -est._intercept_
    else:
        est.dual_coef_ = dc
        est.intercept_ = est._intercept_
    est._probA = np.empty(0)
    est._probB = np.empty(0)
    est.classes_ = np.arange(c)
    est._gamma = float(np.asarray(fp["gamma"]))
    est.gamma = est._gamma
    est.fit_status_ = 0
    est.shape_fit_ = X.shape
    est.n_features_in_ = X.shape[1]
    est.class_weight_ = np.ones(c)
    return est


def _infer_classes(dual, pa, pb, c, n):
    """Recover row classes from the OvO sign structure: in pair (a, b) a
    positive coefficient marks class a, negative class b. Rows inactive in
    every pair default to class 0 (zero coefficients — harmless)."""
    y = np.zeros(n, np.int32)
    for p in range(dual.shape[0]):
        pos = dual[p] > 0
        neg = dual[p] < 0
        y[pos] = pa[p]
        y[neg] = pb[p]
    return y


def _export_svc_nystrom(a):
    from sklearn.kernel_approximation import Nystroem
    from sklearn.pipeline import Pipeline
    from sklearn.svm import LinearSVC

    fp = a["fitted_params"]
    pa = np.asarray(fp["pairs_a"])
    if len(pa) > 1:
        raise NotImplementedError(
            "multiclass Nystrom SVC has no sklearn form (OvO voting over "
            "approximate-feature machines); use predict_with_artifact"
        )
    st = a["static"]
    landmarks = np.asarray(fp["landmarks"])
    W = np.asarray(fp["W"])[0]  # [m+1] (last = bias)
    nys = Nystroem(
        kernel=st.get("kernel", "rbf"),
        gamma=float(np.asarray(fp["gamma"])),
        degree=int(st.get("degree", 3)),
        coef0=float(st.get("coef0", 0.0)),
        n_components=landmarks.shape[0],
    )
    nys.components_ = _np64(landmarks)
    nys.component_indices_ = np.arange(landmarks.shape[0])
    # our Z = K(X, L) @ inv_sqrt (inv_sqrt = V diag(1/sqrt(lam)), NOT the
    # symmetric sqrt); sklearn transforms with normalization_.T, so inject
    # the transpose to reproduce the exact feature map
    nys.normalization_ = _np64(np.asarray(fp["inv_sqrt"])).T
    nys.n_features_in_ = landmarks.shape[1]
    lin = LinearSVC()
    # our pair decision is positive for class pairs_a (= class 0); LinearSVC
    # decision is positive for class 1, hence the sign flip
    lin.coef_ = -_np64(W[:-1])[None, :]
    lin.intercept_ = np.asarray([-float(W[-1])])
    lin.classes_ = np.arange(2)
    lin.n_features_in_ = landmarks.shape[0]
    return Pipeline([("nystroem", nys), ("svc", lin)])


def _export_svr(a):
    from sklearn.svm import SVR

    fp = a["fitted_params"]
    if "W" in fp:
        return _export_svr_nystrom(a)
    X = np.asarray(fp["X"])
    dual = np.asarray(fp["dual"])  # [n] signed coefficients
    est = _ctor(SVR, a["parameters"])
    est._sparse = False
    est.support_ = np.arange(X.shape[0], dtype=np.int32)
    est.support_vectors_ = _np64(X)
    # libsvm regression models carry two (identical) per-"class" SV counts
    est._n_support = np.asarray([X.shape[0], X.shape[0]], np.int32)
    est._dual_coef_ = _np64(dual)[None, :]
    est.dual_coef_ = est._dual_coef_
    est._intercept_ = np.asarray([float(np.asarray(fp["intercept"]))])
    est.intercept_ = est._intercept_
    est._probA = np.empty(0)
    est._probB = np.empty(0)
    est._gamma = float(np.asarray(fp["gamma"]))
    est.gamma = est._gamma
    est.fit_status_ = 0
    est.shape_fit_ = X.shape
    est.n_features_in_ = X.shape[1]
    return est


def _export_svr_nystrom(a):
    from sklearn.kernel_approximation import Nystroem
    from sklearn.pipeline import Pipeline
    from sklearn.svm import LinearSVR

    fp = a["fitted_params"]
    st = a["static"]
    landmarks = np.asarray(fp["landmarks"])
    W = np.asarray(fp["W"]).reshape(-1)  # [m+1]
    nys = Nystroem(
        kernel=st.get("kernel", "rbf"),
        gamma=float(np.asarray(fp["gamma"])),
        degree=int(st.get("degree", 3)),
        coef0=float(st.get("coef0", 0.0)),
        n_components=landmarks.shape[0],
    )
    nys.components_ = _np64(landmarks)
    nys.component_indices_ = np.arange(landmarks.shape[0])
    # our Z = K(X, L) @ inv_sqrt (inv_sqrt = V diag(1/sqrt(lam)), NOT the
    # symmetric sqrt); sklearn transforms with normalization_.T, so inject
    # the transpose to reproduce the exact feature map
    nys.normalization_ = _np64(np.asarray(fp["inv_sqrt"])).T
    nys.n_features_in_ = landmarks.shape[1]
    lin = LinearSVR()
    lin.coef_ = _np64(W[:-1])
    lin.intercept_ = np.asarray([float(W[-1])])
    lin.n_features_in_ = landmarks.shape[0]
    return Pipeline([("nystroem", nys), ("svr", lin)])


# ---------------------------------------------------------------------------
# GaussianNB
# ---------------------------------------------------------------------------


def _export_gaussian_nb(a):
    from sklearn.naive_bayes import GaussianNB

    fp = a["fitted_params"]
    est = _ctor(GaussianNB, a["parameters"])
    est.theta_ = _np64(fp["mean"])
    est.var_ = _np64(fp["var"])
    est.class_prior_ = np.exp(_np64(fp["log_prior"]))
    est.class_count_ = est.class_prior_ * 100.0  # relative weights suffice
    c = est.theta_.shape[0]
    est.classes_ = np.arange(c)
    est.n_features_in_ = est.theta_.shape[1]
    est.epsilon_ = 0.0
    return est


_EXPORTERS = {
    "LogisticRegression": _export_logistic,
    "LinearRegression": _export_linear("LinearRegression"),
    "Ridge": _export_linear("Ridge"),
    "MLPClassifier": _export_mlp(True),
    "MLPRegressor": _export_mlp(False),
    "KNeighborsClassifier": _export_knn(True),
    "KNeighborsRegressor": _export_knn(False),
    "DecisionTreeClassifier": _export_decision_tree(True),
    "DecisionTreeRegressor": _export_decision_tree(False),
    "RandomForestClassifier": _export_forest(True),
    "RandomForestRegressor": _export_forest(False),
    "GradientBoostingClassifier": _export_gradient_boosting(True),
    "GradientBoostingRegressor": _export_gradient_boosting(False),
    "SVC": _export_svc,
    "SVR": _export_svr,
    "GaussianNB": _export_gaussian_nb,
}
