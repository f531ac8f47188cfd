"""The port's scorers against the JAX package's, on the CPU.

- Every scorer name of the JAX package, fed the same numpy inputs: the
  JAX function one lane at a time, the port's over a batch of lanes at
  once, within 1e-6. The inputs carry ties (margins and probabilities on a
  coarse grid), saturated probability rows (exact 0 and 1, where the
  log-loss clip acts) and masked rows.
- The set of names each package accepts, and the refusals: an unknown
  name, a binary-only scorer on a multiclass target, a scorer the kernel
  has no output for, a callable scorer (not yet ported), any scorer on a
  transform.
- A scored search of every family with a scorer of each kind it supports
  (label, margin, probability), through both MLTaskManagers, within
  PERF.md section 2's limits; and the route a scored job takes (never the
  packed or fused paths, as in the reference).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingClassifier, RandomForestClassifier
from sklearn.linear_model import LinearRegression, LogisticRegression, Ridge
from sklearn.model_selection import GridSearchCV
from sklearn.naive_bayes import GaussianNB
from sklearn.neighbors import KNeighborsClassifier, KNeighborsRegressor
from sklearn.neural_network import MLPClassifier
from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu.ops import metrics as jm
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.ops import metrics as tm
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

METRIC_TOL = 1e-6
#: PERF.md section 2: the families' search limits against the JAX package
SEARCH_TOL = {"LogisticRegression": 2e-3, "RandomForestClassifier": 1e-6,
              "DecisionTreeClassifier": 1e-6, "DecisionTreeRegressor": 1e-2,
              "GaussianNB": 1e-5, "GradientBoostingClassifier": 2e-3, "MLPClassifier": 2e-3,
              "KNeighborsClassifier": 2e-3, "KNeighborsRegressor": 1e-4,
              "LinearRegression": 1e-4, "Ridge": 1e-4}

LABEL = sorted(jm._CLS_LABEL_SCORERS)
MARGIN = sorted(jm._CLS_MARGIN_SCORERS)
PROBA = sorted(jm._CLS_PROBA_SCORERS)
REGRESSION = sorted(jm._REG_SCORERS)


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _inputs(k, lanes=3, n=96, seed=0):
    """Labels, predictions, margins and probabilities with ties, saturated
    rows and {0,1} masks (about a third of the rows masked in each lane)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n).astype(np.int32)
    y[:k] = np.arange(k)  # every class present
    pred = np.where(rng.rand(lanes, n) < 0.6, y, rng.randint(0, k, (lanes, n))).astype(np.int32)
    w = (rng.rand(lanes, n) > 0.33).astype(np.float32)
    w[:, :k] = 1.0
    margin = np.round(rng.randn(lanes, n) + (y == 1), 1).astype(np.float32)  # ties
    logits = np.round(rng.randn(lanes, n, k) * 2, 0)
    proba = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    proba[:, 3:8] = np.eye(k)[rng.randint(0, k, 5)]  # saturated rows: exact 0 and 1
    return y, pred, w, margin, proba.astype(np.float32)


def _jax_lanes(fn, *arrays):
    """The JAX function one lane at a time (the reference vmaps a lane)."""
    lanes = arrays[1].shape[0]
    return np.array([float(fn(jnp.asarray(arrays[0]), *(jnp.asarray(a[i]) for a in arrays[1:])))
                     for i in range(lanes)])


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=METRIC_TOL)


#: binary-only scorers are refused on a multiclass target (tested below)
LABEL_CASES = [(name, k) for name in LABEL for k in (2, 3)
               if k == 2 or name not in jm._BINARY_ONLY_SCORERS]


@pytest.mark.parametrize("name,k", LABEL_CASES)
def test_label_scorer_matches_jax(name, k):
    y, pred, w, _, _ = _inputs(k)
    ref = _jax_lanes(lambda a, b, c: jm.classification_score(name, a, b, c, k), y, pred, w)
    got = tm.classification_score(name, torch.as_tensor(y).long(), torch.as_tensor(pred),
                                  torch.as_tensor(w), k)
    assert got.shape == (3,)
    _close(got, ref)


@pytest.mark.parametrize("name", MARGIN)
def test_margin_scorer_matches_jax(name):
    y, _, w, margin, _ = _inputs(2)
    ref = _jax_lanes(lambda a, b, c: jm.margin_score(name, a, b, c), y, margin, w)
    got = tm.margin_score(name, torch.as_tensor(y), torch.as_tensor(margin), torch.as_tensor(w))
    _close(got, ref)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", PROBA)
def test_proba_scorer_matches_jax(name, k):
    y, _, w, _, proba = _inputs(k)
    ref = _jax_lanes(lambda a, b, c: jm.proba_score(name, a, b, c, k), y, proba, w)
    got = tm.proba_score(name, torch.as_tensor(y).long(), torch.as_tensor(proba),
                         torch.as_tensor(w), k)
    _close(got, ref)


@pytest.mark.parametrize("name", REGRESSION)
def test_regression_scorer_matches_jax(name):
    rng = np.random.RandomState(1)
    y = rng.randn(80).astype(np.float32)
    pred = (y + 0.5 * rng.randn(3, 80)).astype(np.float32)
    w = (rng.rand(3, 80) > 0.3).astype(np.float32)
    ref = _jax_lanes(lambda a, b, c: jm.regression_score(name, a, b, c), y, pred, w)
    got = tm.regression_score(name, torch.as_tensor(y), torch.as_tensor(pred), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=METRIC_TOL, atol=METRIC_TOL)


def test_log_loss_saturated_rows_clip_without_renormalising():
    """sklearn >= 1.5's order (clip to f32 eps, no renormalisation), as the
    JAX package pins it: an exact 0 on the true class costs -log(eps)."""
    y = torch.tensor([0, 1])
    proba = torch.tensor([[[0.0, 1.0], [0.0, 1.0]]])
    w = torch.ones(1, 2)
    eps = float(np.finfo(np.float32).eps)
    want = -0.5 * (np.log(np.float32(eps)) + np.log(np.float32(1.0) - np.float32(eps)))
    assert float(tm.weighted_log_loss(y, proba, w, 2)[0]) == pytest.approx(want, rel=1e-6)


def test_lane_dims_are_kept():
    """[T, S, n] predictions against [S, n] masks give [T, S] scores, each
    the one-lane score."""
    y, pred, w, margin, proba = _inputs(2, lanes=6)
    yt = torch.as_tensor(y).long()
    batched = tm.margin_score("roc_auc", yt, torch.as_tensor(margin).reshape(2, 3, -1),
                              torch.as_tensor(w).reshape(2, 3, -1)[:1])
    for t in range(2):
        for s in range(3):
            one = tm.margin_score("roc_auc", yt, torch.as_tensor(margin[t * 3 + s]),
                                  torch.as_tensor(w[s]))
            assert float(batched[t, s]) == pytest.approx(float(one), abs=METRIC_TOL)


def test_scorer_names_equal_jax():
    jax_cls = set(jm._CLS_LABEL_SCORERS) | set(jm._CLS_MARGIN_SCORERS) | set(jm._CLS_PROBA_SCORERS)
    assert tm.scorer_names("classification") == jax_cls
    assert tm.scorer_names("regression") == set(jm._REG_SCORERS)
    assert len(jax_cls) + len(jm._REG_SCORERS) == 25
    for name in jax_cls | set(jm._REG_SCORERS):
        task = "classification" if name in jax_cls else "regression"
        tm.validate_scoring(name, task, 2)  # accepted by name


@pytest.mark.parametrize("scoring,task,n_classes,model,match", [
    ("nope", "classification", 3, None, "unsupported scoring"),
    ("neg_log_loss", "regression", 0, None, "unsupported scoring"),
    ("f1", "classification", 3, None, "binary-only"),
    ("roc_auc", "classification", 7, None, "binary-only"),
    ("neg_log_loss", "classification", 3, "KNeighborsClassifier", "class probabilities"),
    ("roc_auc", "classification", 2, "KNeighborsClassifier", "decision margin"),
    ("roc_auc_ovr", "classification", 3, "SVC", "class probabilities"),
    ("r2", "transform", 0, "PCA", "not applicable"),
])
def test_refusals(scoring, task, n_classes, model, match):
    kernel = get_kernel(model) if model else None
    with pytest.raises(ValueError, match=match):
        tm.validate_scoring(scoring, task, n_classes, kernel)
    # the JAX package refuses the same
    from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel

    with pytest.raises(ValueError):
        jm.validate_scoring(scoring, task, n_classes, jax_kernel(model) if model else None)


def test_callable_scoring_is_refused_by_name():
    with pytest.raises(ValueError, match="callable scoring is not yet ported"):
        tm.validate_scoring(lambda est, X, y: 0.0, "classification", 2)


def test_refused_scorer_fails_the_subtasks():
    """Through the manager: the executor fails the batch with the reason."""
    ts = TorchManager(device="cpu").train(
        GridSearchCV(KNeighborsClassifier(), {"n_neighbors": [3, 5]}, cv=3,
                     scoring="neg_log_loss"), "iris")
    res = ts["job_result"]
    assert res["results"] == [] and len(res["failed"]) == 2
    assert "class probabilities" in res["failed"][0]["error"]


@pytest.fixture
def regression_csv(tmp_path):
    """A 500-row regression table with a noisy nonlinear target."""
    import pandas as pd

    rng = np.random.RandomState(0)
    X = rng.randn(500, 6).astype(np.float32)
    y = 2 * X[:, 0] - X[:, 1] ** 2 + np.sin(3 * X[:, 2]) + 0.3 * rng.randn(500)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(6)])
    df["target"] = y.astype(np.float32)
    path = tmp_path / "reg.csv"
    df.to_csv(path, index=False)
    return str(path)


def _both(search, dataset, tol, local_csv=None):
    """The search through both managers: equal trials, every mean_cv_score
    within ``tol``, the holdout reported under the scorer's name, and
    best_params_ equal unless the JAX package's top two are within tol."""
    managers = (JaxManager(), TorchManager(device="cpu"))
    for m in managers if local_csv else ():
        assert m.download_data(local_csv, dataset, "local")["status"] == "success"
    js = managers[0].train(search, dataset, {"random_state": 42}, show_progress=False)
    ts = managers[1].train(search, dataset, {"random_state": 42})
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    assert not js["job_result"]["failed"], js["job_result"]["failed"][:1]
    by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r  # noqa: E731
                    for r in s["job_result"]["results"]}
    jr, tr = by(js), by(ts)
    assert jr.keys() == tr.keys() and jr
    # the task's default scorer is the default metric, under its own key
    holdout = {"accuracy": "accuracy", "r2": "r2_score"}.get(search.scoring, search.scoring)
    for key in jr:
        assert tr[key].get("scoring") == jr[key].get("scoring")
        assert tr[key][holdout] == pytest.approx(jr[key][holdout], abs=tol), key
        assert tr[key]["mean_cv_score"] == pytest.approx(jr[key]["mean_cv_score"], abs=tol), key
    top = sorted((r["mean_cv_score"] for r in jr.values()), reverse=True)[:2]
    if len(top) < 2 or top[0] - top[1] > tol:
        assert (ts["job_result"]["best_result"]["search_params"]
                == js["job_result"]["best_result"]["search_params"])
    return tr


@pytest.mark.parametrize("scoring,dataset", [
    ("f1_macro", "iris"), ("roc_auc", "synthetic_600x8x2"), ("neg_log_loss", "iris")])
def test_logistic_regression_scored_search_matches_jax(scoring, dataset):
    _both(GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.1, 1.0]}, cv=3,
                       scoring=scoring), dataset, SEARCH_TOL["LogisticRegression"])


@pytest.mark.parametrize("scoring,dataset", [
    ("balanced_accuracy", "iris"), ("average_precision", "synthetic_600x8x2"),
    ("roc_auc_ovr", "iris")])
def test_random_forest_scored_search_matches_jax(scoring, dataset):
    _both(GridSearchCV(RandomForestClassifier(n_estimators=5, max_depth=4, random_state=0),
                       {"min_samples_leaf": [1, 3]}, cv=3, scoring=scoring),
          dataset, SEARCH_TOL["RandomForestClassifier"])


@pytest.mark.parametrize("scoring,dataset", [
    ("recall_weighted", "iris"), ("roc_auc", "synthetic_600x8x2"), ("roc_auc_ovo", "iris")])
def test_decision_tree_scored_search_matches_jax(scoring, dataset, monkeypatch):
    for mod in (jmt, tmt):
        monkeypatch.setattr(mod, "_DEEP_LEVELS", 6)
    _both(GridSearchCV(DecisionTreeClassifier(random_state=0), {"max_depth": [None, 3]}, cv=3,
                       scoring=scoring), dataset, SEARCH_TOL["DecisionTreeClassifier"])


@pytest.mark.parametrize("scoring,dataset", [
    ("precision_micro", "iris"), ("roc_auc", "synthetic_600x8x2"), ("neg_log_loss", "iris")])
def test_gaussian_nb_scored_search_matches_jax(scoring, dataset):
    _both(GridSearchCV(GaussianNB(), {"var_smoothing": [1e-9, 1e-2]}, cv=3, scoring=scoring),
          dataset, SEARCH_TOL["GaussianNB"])


@pytest.mark.parametrize("scoring,dataset", [
    ("f1", "synthetic_600x8x2"), ("average_precision", "synthetic_600x8x2"),
    ("roc_auc_ovo", "iris")])
def test_gradient_boosting_scored_search_matches_jax(scoring, dataset):
    _both(GridSearchCV(GradientBoostingClassifier(n_estimators=5, random_state=0),
                       {"learning_rate": [0.1, 0.5]}, cv=3, scoring=scoring),
          dataset, SEARCH_TOL["GradientBoostingClassifier"])


@pytest.mark.parametrize("scoring,c", [(None, 3), ("f1_macro", 3), ("neg_log_loss", 3),
                                       ("roc_auc_ovr", 3), ("roc_auc", 2)])
def test_gradient_boosting_scores_its_raw_scores(scoring, c):
    """GB's chunk_eval scores F, the raw scores on the rows it was fitted
    on: labels by F's argmax, probabilities by softmax(F), the binary
    margin F[:, 1] - F[:, 0]."""
    rng = np.random.RandomState(c)
    F = torch.as_tensor(rng.randn(2, 40, c).astype(np.float32))
    y = torch.as_tensor(rng.randint(0, c, 40))
    w = torch.as_tensor((rng.rand(2, 40) > 0.3).astype(np.float32))
    kernel = get_kernel("GradientBoostingClassifier")
    got = kernel.chunk_eval(None, y, w, {}, {"_scoring": scoring, "_n_classes": c}, F)["score"]
    if tm.scoring_needs_margin(scoring):
        want = tm.margin_score(scoring, y, F[..., 1] - F[..., 0], w)
    elif tm.scoring_needs_proba(scoring):
        want = tm.proba_score(scoring, y, torch.softmax(F, dim=-1), w, c)
    else:
        want = tm.classification_score(scoring, y, torch.argmax(F, dim=-1), w, c)
    assert got.shape == (2,) and torch.equal(got, want)


@pytest.mark.parametrize("scoring,dataset", [
    ("accuracy", "iris"), ("roc_auc", "synthetic_600x8x2"), ("neg_log_loss", "iris")])
def test_mlp_scored_search_matches_jax(scoring, dataset):
    _both(GridSearchCV(MLPClassifier(hidden_layer_sizes=(16,), max_iter=20, random_state=0),
                       {"alpha": [1e-4, 1e-2]}, cv=3, scoring=scoring),
          dataset, SEARCH_TOL["MLPClassifier"])


def test_knn_scored_search_matches_jax():
    _both(GridSearchCV(KNeighborsClassifier(), {"n_neighbors": [3, 7]}, cv=3,
                       scoring="f1_weighted"), "synthetic_600x8x3",
          SEARCH_TOL["KNeighborsClassifier"])


@pytest.mark.parametrize("model,scoring", [
    (KNeighborsRegressor(), "neg_mean_absolute_error"),
    (DecisionTreeRegressor(random_state=0, max_depth=4), "explained_variance"),
    (LinearRegression(), "neg_root_mean_squared_error"),
    (Ridge(), "max_error")])
def test_regressor_scored_search_matches_jax(model, scoring, regression_csv):
    grid = {"alpha": [0.1, 10.0]} if isinstance(model, Ridge) else (
        {"n_neighbors": [3, 7]} if isinstance(model, KNeighborsRegressor) else
        {"fit_intercept": [True, False]} if isinstance(model, LinearRegression) else
        {"min_samples_leaf": [1, 5]})
    _both(GridSearchCV(model, grid, cv=3, scoring=scoring), "reg",
          SEARCH_TOL[type(model).__name__], regression_csv)


def test_scored_logreg_search_leaves_the_packed_path(monkeypatch):
    """A scored job never takes the packed path (the reference keeps scored
    jobs on the generic drivers), even where the packed path is forced."""
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    kernel = get_kernel("LogisticRegression")

    def refuse(*a, **k):
        raise AssertionError("the packed path was built for a scored job")

    monkeypatch.setattr(kernel, "build_batched_fn", refuse)
    ts = TorchManager(device="cpu").train(
        GridSearchCV(LogisticRegression(max_iter=30), {"C": [0.5, 1.0]}, cv=3,
                     scoring="neg_log_loss"), "iris")
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    assert all(r["scoring"] == "neg_log_loss" and r["mean_cv_score"] < 0
               for r in ts["job_result"]["results"])
