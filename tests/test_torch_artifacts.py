"""The winner artifact of the port (runtime/artifacts.py, fit_single)
against the JAX package's, on the CPU, fed the same numpy inputs.

Every case builds one numpy table (iris, a 400-row synthetic, a 400-row
regression table with a standardised target), one TrialData and one
``n_folds=0`` plan per package (their masks asserted equal), and refits one
configuration in each package with ``fit_single``. Then:

a. per family (22 names): the artifact params have the same keys, shapes
   and dtypes; values within the family's limit (PERF.md §2), named by
   ``VALUE_TOL``; predictions on the holdout's eval rows within
   ``PRED_TOL``. Two families need more than a tolerance:

   - LogisticRegression's softmax leaves the intercept row free up to a
     constant across classes (only a 1e-5 ridge pins it, and Newton's 25
     steps do not get there), so W is compared centred across classes,
     which is what the predictions read;
   - float-stat trees (the regressors' ``y * w``, boosting's gradients and
     hessians) add bin prefix sums in other orders in the two packages, so
     a close call may go either way (ops/tree_checks.py): trees are held
     split by split but at close calls, boosting stage after stage from the
     JAX package's F up to the first stage with a close call (every later
     stage grows from its own F); their predictions are held by score.
     A deep-arena forest's stacked arrays are held to the element.

b. cross-loading: a JAX artifact through the port's predict_with_artifact
   predicts what the JAX one does; a port artifact through the JAX
   ``to_sklearn`` and the port's copy predicts what the port does (the JAX
   package's own export tolerance); no saved artifact holds a tensor.
c. GradientBoosting on new rows: the JAX artifact's trees replayed by the
   port's ``predict``, ``predict_margin`` and ``predict_proba`` against the
   JAX package's (its ``_raw_scores``), within 1e-5.
d. the manager's round trip on the CPU: download, cache, holdout score,
   load as a dict, the named error without scikit-learn, and the refit's
   masked lane kernel under CS230_FORCE_PACKED=1.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris, make_classification, make_regression
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu.models.base import TrialData as JaxTrialData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops.folds import build_split_plan as jax_plan
from cs230_distributed_machine_learning_tpu.parallel.trial_map import fit_single as jax_fit
from cs230_distributed_machine_learning_tpu.runtime import artifacts as jart
from cs230_distributed_machine_learning_tpu.runtime.sklearn_export import (
    to_sklearn as jax_to_sklearn,
)
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.models.trees import _bootstrap_counts
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.ops.tree_checks import check_tree
from cs230_distributed_machine_learning_tpu_torch.ops.trees import predict_tree
from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import fit_single
from cs230_distributed_machine_learning_tpu_torch.runtime import artifacts as tart
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils import prng

torch.set_num_threads(1)
CPU = torch.device("cpu")

# family -> (table, params)
CASES = {
    "LogisticRegression": ("iris", {"C": 1.0}),
    "LinearRegression": ("reg", {}),
    "Ridge": ("reg", {"alpha": 1.0}),
    "MLPClassifier": ("cls3", {"hidden_layer_sizes": [8], "max_iter": 10}),
    "MLPRegressor": ("reg", {"hidden_layer_sizes": [8], "max_iter": 10}),
    "KNeighborsClassifier": ("cls3", {"n_neighbors": 5}),
    "KNeighborsRegressor": ("reg", {"n_neighbors": 4, "weights": "distance"}),
    "GaussianNB": ("cls3", {}),
    "DecisionTreeClassifier": ("cls3", {"max_depth": 4}),
    "DecisionTreeRegressor": ("reg", {"max_depth": 4}),
    "RandomForestClassifier": ("cls3", {"n_estimators": 5, "max_depth": 4}),
    "RandomForestRegressor": ("reg", {"n_estimators": 4, "max_depth": 3}),
    "GradientBoostingClassifier": ("cls3", {"n_estimators": 5}),
    "GradientBoostingRegressor": ("reg", {"n_estimators": 5}),
    "SVC": ("cls3", {"C": 1.0}),
    "SVR": ("reg", {"C": 1.0}),
    "StandardScaler": ("reg", {}),
    "MinMaxScaler": ("reg", {}),
    "PCA": ("reg", {"n_components": 3}),
    "OneHotEncoder": ("codes", {}),
    "SimpleImputer": ("nan", {"strategy": "median"}),
    "Imputer": ("nan", {}),
}

#: artifact values, port against JAX (absolute, of the largest |value|
#: where the family's values are unbounded). Integer-stat trees, KNN's
#: table, GaussianNB's moments here and the min/max/one-hot transformers
#: are exact; the other transformers are f32 sums (1e-5); the linear models f32
#: normal equations (1e-4); the MLP's generic fits round the same products
#: to bf16 and sum in other orders (1e-3); SVC/SVR duals 5e-3 (the f32 Gram
#: built in other orders before the bf16 rounding); LogReg's centred W 5e-3.
VALUE_TOL = {
    "LogisticRegression": 5e-3, "LinearRegression": 1e-4, "Ridge": 1e-4,
    "MLPClassifier": 1e-3, "MLPRegressor": 1e-3,
    "SVC": 5e-3, "SVR": 5e-3, "StandardScaler": 1e-5, "PCA": 1e-5, "SimpleImputer": 1e-5,
    "Imputer": 1e-5,
}
#: holdout predictions, port against JAX: labels agree on at least this
#: share of the eval rows (classifiers), or |difference| within this share
#: of the target's spread (regressors and transformers). Boosting may flip
#: a close call (module docstring): one of the 30 iris / 80 synthetic eval
#: rows of a 5-stage fit, and the regressor within 1e-2 of the spread.
PRED_TOL = {
    "classification": 1.0, "regression": 1e-4, "transform": 1e-5,
    "MLPRegressor": 1e-3, "SVR": 1e-2, "GradientBoostingClassifier": 0.975,
    "GradientBoostingRegressor": 1e-2, "DecisionTreeRegressor": 1e-2,
    "RandomForestRegressor": 1e-2, "SVC": 0.99,
}
#: the families runtime/sklearn_export.py exports
EXPORTED = sorted(set(CASES) - {"StandardScaler", "MinMaxScaler", "PCA", "OneHotEncoder",
                                "SimpleImputer", "Imputer"})


def _table(kind):
    """(X f32, y, n_classes) of a test table."""
    if kind == "iris":
        d = load_iris()
        return d.data.astype(np.float32), d.target.astype(np.int32), 3
    if kind in ("cls2", "cls3"):
        c = int(kind[-1])
        X, y = make_classification(400, 6, n_informative=4, n_classes=c, random_state=0)
        return X.astype(np.float32), y.astype(np.int32), c
    X, y = make_regression(400, 6, noise=5.0, random_state=0)
    X, y = X.astype(np.float32), ((y - y.mean()) / y.std()).astype(np.float32)
    if kind == "codes":  # small non-negative integer codes
        X = np.clip(np.abs(np.round(1.5 * X)), 0, 6).astype(np.float32)
    elif kind == "nan":
        X = X.copy()
        X[np.random.RandomState(1).rand(*X.shape) < 0.1] = np.nan
    return X, y, 0


class Fit:
    """One configuration refitted in both packages on the same table."""

    def __init__(self, name, kind, params):
        self.name, self.params = name, params
        self.X, self.y, self.c = _table(kind)
        self.jk, self.tk = jax_kernel(name), get_kernel(name)
        self.jplan = jax_plan(self.y, task=self.jk.task, n_folds=0, test_size=0.2,
                              random_state=42)
        self.plan = build_split_plan(self.y, task=self.tk.task, n_folds=0, test_size=0.2,
                                     random_state=42)
        np.testing.assert_array_equal(self.plan.train_w, self.jplan.train_w)
        np.testing.assert_array_equal(self.plan.eval_w, self.jplan.eval_w)
        jf, js = jax_fit(self.jk, JaxTrialData(self.X, self.y, self.c), self.jplan, params)
        self.jax = {"model_type": name, "parameters": params, "static": dict(js),
                    "fitted_params": _numpy(jf)}
        tf, ts = fit_single(self.tk, TrialData(self.X, self.y, self.c), self.plan, params,
                            device=CPU)
        self.port = {"model_type": name, "parameters": params, "static": dict(ts),
                     "fitted_params": tf}
        self.ev = self.plan.eval_w[0] > 0


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


_FITS = {}


def _fit(name) -> Fit:
    if name not in _FITS:
        _FITS[name] = Fit(name, *CASES[name])
    return _FITS[name]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _jax_predict(artifact, X):
    return np.asarray(jart.predict_with_artifact(artifact, X))


def _port_predict(artifact, X):
    return tart.predict_with_artifact(artifact, X, device="cpu").numpy()


def _assert_predictions(f, got, want):
    key = f.name if f.name in PRED_TOL else f.tk.task
    if f.name == "PCA":  # each component up to its sign (eigh's)
        got = got * np.sign(np.sum(got * want, axis=0))
    if f.tk.task == "classification":
        agree = float(np.mean(got == want))
        assert agree >= PRED_TOL[key], (f.name, agree)
    else:
        spread = float(np.nanstd(want)) + 1e-12
        err = float(np.nanmax(np.abs(got - want))) / spread
        assert err <= PRED_TOL[key], (f.name, err)


# ---- a. the artifact of every family against the JAX package's ----------


@pytest.mark.parametrize("name", sorted(CASES))
def test_artifact_matches_jax(name):
    f = _fit(name)
    jl, tl = dict(_leaves(f.jax["fitted_params"])), dict(_leaves(f.port["fitted_params"]))
    assert jl.keys() == tl.keys()
    for path, a in jl.items():
        b = tl[path]
        assert isinstance(b, np.ndarray), (path, type(b))
        assert (b.shape, b.dtype) == (a.shape, a.dtype), (path, b.shape, b.dtype, a.shape,
                                                          a.dtype)
    _check_values(f, jl, tl)
    _assert_predictions(f, _port_predict(f.port, f.X)[f.ev], _jax_predict(f.jax, f.X)[f.ev])


def _check_values(f, jl, tl):
    name = f.name
    if name == "LogisticRegression":
        centred = [W - W.mean(axis=1, keepdims=True) for W in (jl[""], tl[""])]
        np.testing.assert_allclose(centred[1], centred[0],
                                   atol=VALUE_TOL[name] * np.abs(centred[0]).max())
    elif name in ("DecisionTreeRegressor", "RandomForestRegressor"):
        _check_float_trees(f)
    elif name.startswith("GradientBoosting"):
        _check_stages(f)
    elif name == "PCA":  # eigh's signs are arbitrary: each component up to its sign
        for path in jl:
            a, b = jl[path], tl[path]
            if path == "/components":
                b = b * np.sign(np.sum(a * b, axis=1, keepdims=True))
            np.testing.assert_allclose(b, a, atol=VALUE_TOL[name])
    elif name == "SVR":  # the duals; the intercept through the predictions
        np.testing.assert_allclose(tl["/dual"], jl["/dual"], atol=VALUE_TOL[name])
        np.testing.assert_allclose(tl["/gamma"], jl["/gamma"], rtol=1e-5)
    else:
        tol = VALUE_TOL.get(name, 0.0)
        for path, a in jl.items():
            scale = max(float(np.max(np.abs(a[np.isfinite(a)]), initial=0.0)), 1.0) \
                if name in ("LinearRegression", "Ridge", "MLPClassifier", "MLPRegressor") else 1.0
            if tol and a.dtype.kind == "f":
                np.testing.assert_allclose(tl[path], a, atol=tol * scale, err_msg=path)
            else:
                np.testing.assert_array_equal(tl[path], a, err_msg=path)


def _check_float_trees(f):
    """Each tree split by split but at close calls, from the stats its
    lane was grown on (a forest's trees on their bootstrap counts)."""
    st = f.port["static"]
    xb = f.tk.prepare_data(f.X, st)["xb"]
    w = f.plan.train_w[0]
    S, C = (f.y * w)[:, None], w
    jt, tt = f.jax["fitted_params"], f.port["fitted_params"]
    if "trees" not in jt:
        check_tree(xb, S, C, jt["tree"], tt["tree"], depth=st["_depth"], n_bins=st["_n_bins"],
                   msl=st["_msl"], key=prng.PRNGKey(st["_seed"]))
        return
    base = prng.PRNGKey(st["_seed"])
    for t in range(len(jt["trees"]["leaf_val"])):
        boot_key, key = prng.split(prng.fold_in(base, t)).unbind(-2)
        counts = _bootstrap_counts(boot_key, torch.as_tensor(w)[None], len(w))[0].numpy()
        one = (lambda trees: {k: v[t] for k, v in trees.items()})
        check_tree(xb, S * counts[:, None], C * counts, one(jt["trees"]), one(tt["trees"]),
                   depth=st["_depth"], n_bins=st["_n_bins"], msl=st["_msl"], key=key)


def _check_stages(f):
    """Stage after stage from the JAX artifact's F (replayed by the port's
    own functions), each stage's trees split by split but at close calls,
    up to the first stage that has one."""
    tk, st = f.tk, f.port["static"]
    xb = torch.as_tensor(tk.prepare_data(f.X, st)["xb"])
    jp = tk.params_from_artifact(f.jax["fitted_params"], CPU)
    jt, tt = f.jax["fitted_params"]["trees"], f.port["fitted_params"]["trees"]
    y, w = torch.as_tensor(f.y), torch.as_tensor(f.plan.train_w[:1])
    sub = torch.tensor([float(f.params.get("subsample", 1.0))])
    F = tk._f0(len(f.y), jp["prior"], st)
    base = prng.PRNGKey(st["_seed"])
    np.testing.assert_allclose(f.port["fitted_params"]["prior"],
                               f.jax["fitted_params"]["prior"], rtol=1e-6)
    for t in range(len(jp["trees"])):
        sub_key, feat_key = prng.split(prng.fold_in(base, t)).unbind(-2)
        S, C, keys = tk._stage_stats(y, tk._subsample(sub_key, w, sub), F, st, feat_key)
        close = 0
        for lane in range(S.shape[0]):
            one = (lambda trees: {k: v[t][lane] if tk.task == "classification" else v[t]
                                  for k, v in trees.items()})
            close += check_tree(xb.numpy(), S[lane].numpy(), C[lane].numpy(), one(jt), one(tt),
                                depth=st["_depth"], n_bins=st["_n_bins"], msl=st["_msl"],
                                key=keys[lane] if keys.dim() == 2 else keys)
        if close:
            return
        delta = predict_tree(xb, jp["trees"][t], st["_depth"])[..., 0]
        F = tk._update(F, delta, jp["lr"], st)


def test_deep_forest_artifact_stacks_like_jax(monkeypatch):
    """A deep-arena forest (grown to purity, 6 levels in both packages):
    every tree's arena and per-level tables stacked on the tree axis, equal
    to the JAX artifact's to the element."""
    monkeypatch.setenv("CS230_TREE_DEEP_N", "128")
    for mod in (jmt, tmt):
        monkeypatch.setattr(mod, "_DEEP_LEVELS", 6)
    f = Fit("RandomForestClassifier", "cls3", {"n_estimators": 3})
    assert f.port["static"]["_deep"] and f.jax["static"]["_deep"]
    jt, tt = f.jax["fitted_params"]["trees"], f.port["fitted_params"]["trees"]
    assert {"level_ids", "level_feat", "level_bin", "level_left", "child"} <= set(jt)
    assert jt.keys() == tt.keys()
    for k in jt:
        assert (tt[k].shape, tt[k].dtype) == (jt[k].shape, jt[k].dtype), k
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    np.testing.assert_array_equal(_port_predict(f.port, f.X), _jax_predict(f.jax, f.X))


# ---- b. cross-loading ------------------------------------------------------

_XQ = np.random.RandomState(9).randn(120, 6).astype(np.float32)


def _queries(f):
    """New rows of the table's kind: codes for the encoder, NaNs for the
    imputers, standard normal rows otherwise (iris has 4 features)."""
    X = _XQ[:, :f.X.shape[1]]
    if f.name == "OneHotEncoder":
        return np.clip(np.abs(np.round(1.5 * X)), 0, 6)
    if f.name in ("SimpleImputer", "Imputer"):
        X = X.copy()
        X[::7, 2] = np.nan
    return X


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_artifact_predicts_alike_in_port(name):
    """The JAX artifact, loaded by the port's ``params_from_artifact``,
    predicts new rows as the JAX package does (one set of params: labels
    equal, values within 1e-5 of their spread)."""
    f = _fit(name)
    X = _queries(f)
    got, want = _port_predict(f.jax, X), _jax_predict(f.jax, X)
    if f.tk.task == "classification":
        np.testing.assert_array_equal(got, want)
    else:
        spread = float(np.nanstd(want)) + 1e-12
        assert float(np.nanmax(np.abs(got - want))) / spread <= 1e-5


@pytest.mark.parametrize("name", EXPORTED)
def test_port_artifact_exports_to_sklearn(name):
    """A port artifact through the JAX package's ``to_sklearn`` and through
    the port's copy: the estimator predicts what the port predicts (the JAX
    package's own export contract: labels equal, values within 1e-4 of
    their spread)."""
    f = _fit(name)
    ours = _port_predict(f.port, _XQ[:, :f.X.shape[1]])
    for export in (jax_to_sklearn, tart.to_sklearn):
        est = export(f.port)
        theirs = np.asarray(est.predict(_XQ[:, :f.X.shape[1]].astype(np.float64)))
        if f.tk.task == "classification":
            np.testing.assert_array_equal(theirs, ours)
        else:
            assert float(np.max(np.abs(ours - theirs)) / (np.std(ours) + 1e-9)) < 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_saved_artifact_holds_no_tensor(name, tmp_path):
    """Saved and loaded back, a port artifact is numpy arrays and Python
    scalars only, and predicts as before."""
    f = _fit(name)
    path = tart.save_artifact("st", f.port, str(tmp_path))
    assert os.path.basename(path) == "st_model.pkl"
    loaded = tart.load_artifact(path)
    assert not [p for p, v in _leaves(loaded) if isinstance(v, torch.Tensor)]
    assert all(isinstance(v, np.ndarray) for _, v in _leaves(loaded["fitted_params"]))
    np.testing.assert_array_equal(_port_predict(loaded, f.X), _port_predict(f.port, f.X))


# ---- c. GradientBoosting on new rows against the JAX _raw_scores ----------


@pytest.mark.parametrize("kind,method", [
    ("cls2", "predict"), ("cls2", "predict_margin"), ("cls2", "predict_proba"),
    ("cls3", "predict"), ("cls3", "predict_margin"), ("cls3", "predict_proba"),
    ("reg", "predict")])
def test_gradient_boosting_predicts_new_rows_like_jax(kind, method):
    """The JAX artifact's stages replayed by the port on new rows (raw
    features, binned by the artifact's edges) against the JAX kernel's
    method on the same params: within 1e-5 (labels equal)."""
    name = "GradientBoostingRegressor" if kind == "reg" else "GradientBoostingClassifier"
    if ("gb", kind) not in _FITS:
        _FITS[("gb", kind)] = Fit(name, kind, {"n_estimators": 6, "learning_rate": 0.3,
                                               "max_depth": 2})
    f = _FITS[("gb", kind)]
    import jax.numpy as jnp

    jparams = {k: (v if k != "trees" else {kk: jnp.asarray(vv) for kk, vv in v.items()})
               for k, v in f.jax["fitted_params"].items()}
    want = np.asarray(getattr(f.jk, method)(jparams, jnp.asarray(_XQ), f.jax["static"]))
    tparams = f.tk.params_from_artifact(f.jax["fitted_params"], CPU)
    got = getattr(f.tk, method)(tparams, torch.as_tensor(_XQ), f.jax["static"])[0].numpy()
    if method == "predict" and kind != "reg":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- d. the manager's round trip -------------------------------------------


@pytest.fixture
def torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield cfg
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _iris_job(m):
    search = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
              "base_estimator_params": {"max_iter": 50}, "param_grid": {"C": [0.1, 1.0]},
              "cv_params": {"cv": 3}}
    status = m.train(search, "iris", {"random_state": 42}, show_progress=False)
    assert status["job_status"] == "completed", status
    return status["job_result"]["best_result"]


def test_download_best_model_writes_once_and_caches(torch_storage, tmp_path, monkeypatch):
    m = TorchManager(device="cpu")
    best = _iris_job(m)
    calls = []
    fit_artifact = m._coordinator.executor.fit_artifact
    monkeypatch.setattr(m._coordinator.executor, "fit_artifact",
                        lambda st: calls.append(st["subtask_id"]) or fit_artifact(st))
    path = m.download_best_model()
    assert path == os.path.join(torch_storage.storage.models_dir,
                                f"{best['subtask_id']}_model.pkl")
    assert os.path.exists(path)
    out = str(tmp_path / "winner.pkl")
    assert m.download_best_model(output_path=out) == out
    with open(out, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    assert m.download_best_model(m.job_id) == path
    assert calls == [best["subtask_id"]]  # one refit, then the cached path


def test_artifact_holdout_score_is_the_best_result(torch_storage):
    """The refit trains on split 0's rows, so on its eval rows it scores
    the winner's reported holdout accuracy (the same Newton fit)."""
    m = TorchManager(device="cpu")
    best = _iris_job(m)
    artifact = m.load_best_model(as_sklearn=False)
    assert isinstance(artifact, dict) and artifact["model_type"] == "LogisticRegression"
    assert artifact["parameters"] == best["parameters"]
    data = m._coordinator.cache.get("iris", "classification")
    plan = build_split_plan(np.asarray(data.y), task="classification", n_folds=0,
                            test_size=0.2, random_state=42)
    ev = plan.eval_w[0] > 0
    pred = _port_predict(artifact, data.X)
    assert abs(float(np.mean(pred[ev] == np.asarray(data.y)[ev])) - best["accuracy"]) <= 1e-6


def test_load_best_model_without_scikit_learn_names_the_way_out(torch_storage, monkeypatch):
    m = TorchManager(device="cpu")
    _iris_job(m)
    est = m.load_best_model()
    assert type(est).__name__ == "LogisticRegression"
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(tart.ScikitLearnMissing, match="as_sklearn=False"):
        m.load_best_model()
    assert isinstance(m.load_best_model(as_sklearn=False), dict)


def test_forced_packed_refit_takes_the_masked_lane_kernel(torch_storage, monkeypatch):
    """Under CS230_FORCE_PACKED=1 a nesterov LogReg refit runs the masked
    lane kernel's wrapper (its plain version on the CPU), one lane a step,
    and the artifact predicts within the search's own limit of the default
    refit (2e-3 of the eval rows)."""
    X, y = make_classification(600, 30, n_informative=8, n_classes=4, random_state=0)
    data = TrialData(X.astype(np.float32), y.astype(np.int32), 4)
    plan = build_split_plan(data.y, task="classification", n_folds=0, random_state=42)
    kernel = get_kernel("LogisticRegression")
    monkeypatch.setattr("cs230_distributed_machine_learning_tpu_torch.models.logistic."
                        "_NEWTON_MAX_DIM", 0)
    params = {"C": 1.0, "max_iter": 60}
    base, _ = fit_single(kernel, data, plan, params, device=CPU)
    lanes = []
    plain = cuda_logreg.masked_softmax_grad_reference
    monkeypatch.setattr(cuda_logreg, "masked_softmax_grad_reference",
                        lambda Ab, W, *a, **k: lanes.append(W.shape[0]) or plain(Ab, W, *a, **k))
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    forced, static = fit_single(kernel, data, plan, params, device=CPU)
    assert static["_method"] == "nesterov"
    assert lanes == [1] * 60
    art = {"model_type": "LogisticRegression", "parameters": params, "static": static}
    ev = plan.eval_w[0] > 0
    a = _port_predict({**art, "fitted_params": base}, data.X)[ev]
    b = _port_predict({**art, "fitted_params": forced}, data.X)[ev]
    assert float(np.mean(a != b)) <= 1.0 / ev.sum(), np.mean(a != b)  # at most one row


def test_stochastic_rounding_draws_of_a_step_are_one_pass():
    """The MLP refit's generic path draws a step's stochastic-rounding bits
    for every leaf in one threefry pass (``random_bits_each``), from keys
    computed for all steps at once: the same bits as one ``split(fold_in(
    key, step))`` and one ``bits`` call per leaf."""
    sr = prng.fold_in(prng.PRNGKey(3), 0x5A)
    every = prng.split(prng.fold_in(sr, torch.arange(1, 40)), 4)
    shapes = [(30, 8), (8,), (8, 3), (3,)]
    for step in (1, 17, 39):
        keys = prng.split(prng.fold_in(sr, step), 4)
        assert torch.equal(every[step - 1], keys)
        for got, key, shape in zip(prng.random_bits_each(keys, shapes), keys, shapes):
            assert torch.equal(got, prng.bits(key, shape))


def test_grid_search_wrapper_refits_through_the_manager(torch_storage):
    """A scikit-learn GridSearchCV object (introspected into model_details)
    refits its winner like the dict form."""
    m = TorchManager(device="cpu")
    status = m.train(GridSearchCV(LogisticRegression(max_iter=50), {"C": [0.5, 2.0]}, cv=3),
                     "iris", show_progress=False)
    best = status["job_result"]["best_result"]
    artifact = pickle.load(open(m.download_best_model(), "rb"))
    assert artifact["parameters"]["C"] == best["parameters"]["C"]
    assert _port_predict(artifact, load_iris().data).shape == (150,)
