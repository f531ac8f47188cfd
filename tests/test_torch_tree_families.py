"""The port's other tree families and GaussianNB against the JAX package,
on the CPU, through both MLTaskManagers: RandomForestRegressor (complete
builder and deep arena), DecisionTreeClassifier and DecisionTreeRegressor
(deep arena and max_depth=4) and GaussianNB, each as a small GridSearchCV;
then RandomForestClassifier past the 32-tree window of the reference's
forest mean.

Both packages get the same data: builtin tables, or one regression CSV
staged into both through ``download_data(..., "local")``. ``best_params_``
must be equal. Classification scores must be equal within 1e-6, per fold
(integer-stat histograms are exact; GaussianNB's f32 moments are summed in
other orders, and no eval row sits that near a tie here).

The regressors' histograms carry float stats, whose bin prefix sums the
two packages add in other orders, so their close calls (candidates that
cut a node's rows into the same two sets tie exactly) go either way
(ops/tree_checks.py). Their trees are held split by split, but at close
calls, on one fit of each builder; their searches by mean score: a forest
averages a flipped split over its trees (within 2e-3, as boosting), a
single tree does not (within 1e-2: one flip at depth 3 moved a fold's r2
by 0.017 and its search's mean by 3.9e-3 here; the JAX package's own
vmapped and unvmapped fits of that fold differ by the same flip). The arena
is cut to 6 levels in both packages so the JAX side compiles in seconds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier, RandomForestRegressor
from sklearn.model_selection import GridSearchCV, ParameterGrid
from sklearn.naive_bayes import GaussianNB
from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models import naive_bayes as jnb
from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models import naive_bayes as tnb
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.models.trees import _bootstrap_counts
from cs230_distributed_machine_learning_tpu_torch.ops.tree_checks import check_tree
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils import prng

torch.set_num_threads(1)

CLS_TOL = 1e-6
FOREST_TOL = 2e-3
TREE_TOL = 1e-2


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    """The port's storage root in a per-test tmpdir (conftest does the
    same for the JAX package)."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


@pytest.fixture
def short_arena(monkeypatch):
    for mod in (jmt, tmt):
        monkeypatch.setattr(mod, "_DEEP_LEVELS", 6)


@pytest.fixture
def regression_csv(tmp_path):
    """A 1,500-row regression table with a noisy nonlinear target."""
    rng = np.random.RandomState(0)
    X = rng.randn(1500, 6).astype(np.float32)
    y = 2 * X[:, 0] - X[:, 1] ** 2 + np.sin(3 * X[:, 2]) + 0.3 * rng.randn(1500)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(6)])
    df["target"] = y.astype(np.float32)
    path = tmp_path / "reg.csv"
    df.to_csv(path, index=False)
    return str(path)


def _both(search, dataset, tol, local_csv=None, per_fold=True):
    managers = (JaxManager(), TorchManager(device="cpu"))
    if local_csv:
        for m in managers:
            assert m.download_data(local_csv, dataset, "local")["status"] == "success"
            assert m.check_data(dataset)["exists"]
    js = managers[0].train(search, dataset, {"random_state": 42}, show_progress=False)
    ts = managers[1].train(search, dataset, {"random_state": 42})
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r  # noqa: E731
                    for r in s["job_result"]["results"]}
    jr, tr = by(js), by(ts)
    assert jr.keys() == tr.keys() and len(jr) == len(ParameterGrid(search.param_grid))
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=tol), k
        if per_fold:
            np.testing.assert_allclose(tr[k]["cv_scores"], jr[k]["cv_scores"], atol=tol,
                                       err_msg=k)
    assert (ts["job_result"]["best_result"]["search_params"]
            == js["job_result"]["best_result"]["search_params"])
    return tr


def test_random_forest_regressor_complete_matches_jax(regression_csv, monkeypatch):
    """Below the deep-arena threshold: the complete builder, float stats."""
    monkeypatch.setenv("CS230_TREE_DEEP_N", "100000")
    tr = _both(GridSearchCV(RandomForestRegressor(random_state=0), {"n_estimators": [3, 5]},
                            cv=3),
               "reg", FOREST_TOL, regression_csv, per_fold=False)
    assert all("mse" in r and np.isfinite(r["mse"]) for r in tr.values())


def test_random_forest_regressor_deep_matches_jax(regression_csv, short_arena):
    """Above the threshold: the deep arena, grown to purity."""
    _both(GridSearchCV(RandomForestRegressor(random_state=1), {"n_estimators": [3]}, cv=3),
          "reg", FOREST_TOL, regression_csv, per_fold=False)


def test_decision_tree_classifier_matches_jax(short_arena):
    """The deep arena (max_depth None on 3,000 rows) and the complete
    builder (max_depth 4), integer stats: equal scores."""
    _both(GridSearchCV(DecisionTreeClassifier(random_state=0), {"max_depth": [None, 4]}, cv=3),
          "synthetic_3000x10x3", CLS_TOL)


def test_decision_tree_regressor_matches_jax(regression_csv, short_arena):
    """The deep arena and the complete builder on float stats."""
    _both(GridSearchCV(DecisionTreeRegressor(random_state=0), {"max_depth": [None, 4]}, cv=3),
          "reg", TREE_TOL, regression_csv, per_fold=False)


@pytest.mark.parametrize("dataset", ["iris", "synthetic_2000x10x3"])
def test_gaussian_nb_matches_jax(dataset):
    _both(GridSearchCV(GaussianNB(), {"var_smoothing": [1e-9, 1e-3, 1e-1]}, cv=5),
          dataset, CLS_TOL)


def test_random_forest_classifier_past_32_trees_matches_jax():
    """The reference's non-chunked forest mean sums trees in windows of 32
    on XLA's CPU backend, the port tree by tree: at 33 and 64 trees the
    per-fold scores must still be equal."""
    _both(GridSearchCV(RandomForestClassifier(random_state=0, max_depth=4),
                       {"n_estimators": [33, 64]}, cv=5), "iris", 0.0)


def _regression_lanes(n=1500, lanes=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1] ** 2 + np.sin(3 * X[:, 2]) + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y, (rng.rand(lanes, n) > 0.33).astype(np.float32)


def _resolved(kernel, params, n, d):
    static = kernel.resolve_static(kernel.static_from_key(kernel.canonicalize(params)[0]), n, d, 0)
    static["_n_classes"] = 0
    return static


@pytest.mark.parametrize("family,params", [
    ("DecisionTreeRegressor", {"max_depth": 5}),
    ("RandomForestRegressor", {"max_depth": 5, "random_state": 2}),
    ("RandomForestRegressor", {"max_depth": 5, "max_features": 3, "random_state": 4}),
])
def test_regression_trees_match_jax_split_by_split(family, params):
    """One complete-builder fit a lane (a forest's first tree, bootstrap and
    feature subsets from its key): every split equal but at close calls,
    every compared leaf value within 1e-5."""
    X, y, w = _regression_lanes()
    n, d = X.shape
    jk = getattr(jnb if family.startswith("Decision") else jmt, family + "Kernel")()
    tk = getattr(tnb if family.startswith("Decision") else tmt, family + "Kernel")()
    js, ts = _resolved(jk, params, n, d), _resolved(tk, params, n, d)
    assert not ts.get("_deep") and ts["_depth"] == 5
    prepared = jk.prepare_data(X, js)
    xb = np.array(prepared["xb"])
    jX = {k: jnp.asarray(v) for k, v in prepared.items()}
    tX = {k: torch.as_tensor(v) for k, v in tk.prepare_data(X, ts).items()}
    S, C = (y[None] * w)[..., None], w
    mf = ts["_mf"] if ts["_mf"] < d else None
    if family.startswith("Decision"):
        jtrees = jax.vmap(lambda wl: jk.fit(jX, jnp.asarray(y), wl, {}, js)["tree"])(
            jnp.asarray(w))
        ttree = tk.fit(tX, torch.as_tensor(y), torch.as_tensor(w), {}, ts)["tree"]
        key = prng.PRNGKey(ts["_seed"])
    else:
        jkey = jax.random.fold_in(jax.random.PRNGKey(js["_seed"]), 0)
        jtrees = jax.vmap(lambda s_, c_: jk._one_tree(jX, s_, c_, js, jkey))(
            jnp.asarray(S), jnp.asarray(C))
        tkey = prng.fold_in(prng.PRNGKey(ts["_seed"]), 0)
        ttree = tk._one_tree(tX, torch.as_tensor(S), torch.as_tensor(C), ts, tkey)
        boot_key, key = prng.split(tkey).unbind(-2)
        counts = _bootstrap_counts(boot_key, torch.as_tensor(C), n).numpy()
        S, C = S * counts[..., None], C * counts
    n_close = 0
    for lane in range(w.shape[0]):
        n_close += check_tree(
            xb, S[lane], C[lane], {k: np.asarray(v[lane]) for k, v in jtrees.items()},
            {k: v[lane].numpy() for k, v in ttree.items()},
            depth=5, n_bins=ts["_n_bins"], msl=ts["_msl"], mf=mf, key=key)
    assert n_close < 31, n_close  # most of the 2 x 31 splits are held


def test_tree_families_are_registered():
    for name, task in (("GradientBoostingClassifier", "classification"),
                       ("GradientBoostingRegressor", "regression"),
                       ("RandomForestRegressor", "regression"),
                       ("DecisionTreeClassifier", "classification"),
                       ("DecisionTreeRegressor", "regression"),
                       ("GaussianNB", "classification")):
        kernel = get_kernel(name)
        assert kernel.name == name and kernel.task == task
