"""The port's linear models and transformers against the JAX package's, on
the CPU, and the registry's names.

- LinearRegression and Ridge: one fit per lane on the same masks as the
  JAX package's vmapped fit, predictions within 1e-4 relative, and
  searches through both managers with r2 within 1e-4 (both solve the f32
  normal equations, summed in other orders).
- StandardScaler, MinMaxScaler, PCA, OneHotEncoder and SimpleImputer (and
  its ``Imputer`` alias): statistics and transforms lane by lane within
  1e-5 (OneHotEncoder exact); PCA's components and transform up to each
  component's sign (eigh's signs are arbitrary in both packages), its
  explained variance and score within 1e-5; the median of an even count
  of observed values is the mean of the two middle ones, as
  ``jnp.nanmedian`` (``torch.nanmedian`` would take the lower).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.decomposition import PCA
from sklearn.impute import SimpleImputer
from sklearn.linear_model import LinearRegression, Ridge
from sklearn.model_selection import GridSearchCV
from sklearn.preprocessing import MinMaxScaler, StandardScaler

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.models.registry import (
    supported_models as jax_models,
)
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models.registry import (
    get_kernel,
    supported_models,
)
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

LINEAR_RTOL = 1e-4
TRANSFORM_TOL = 1e-5
#: the keys a trial's result reports its scores under
METRIC_KEYS = {"accuracy", "r2_score", "mse", "score", "scoring", "cv_scores", "mean_cv_score"}


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def test_registry_names_equal_jax():
    assert supported_models() == jax_models()
    assert len(supported_models()) == 22
    assert get_kernel("Imputer").task == "transform"


def _static(kernel, params, X, c=0):
    static_key, hyper = kernel.canonicalize(params)
    static = kernel.resolve_static(kernel.static_from_key(static_key), *X.shape, c) \
        if hasattr(kernel, "resolve_static") else kernel.static_from_key(static_key)
    static["_n_classes"] = c
    return static, hyper


def _lanes(name, params, X, y, W):
    """The JAX fit vmapped over the masks ``W [L, n]`` and the port's lane
    fit: (JAX params, port params, JAX predict, port predict, statics)."""
    jk, tk = jax_kernel(name), get_kernel(name)
    js, hyper = _static(jk, params, X)
    ts, _ = _static(tk, params, X)
    L = W.shape[0]
    jh = {k: jnp.full((L,), v, jnp.float32) for k, v in hyper.items()}
    th = {k: torch.full((L,), v) for k, v in hyper.items()}
    jfit = jax.vmap(lambda w, h: jk.fit(jnp.asarray(X), jnp.asarray(y), w, h, js))(
        jnp.asarray(W), jh)
    jpred = jax.vmap(lambda p: jk.predict(p, jnp.asarray(X), js))(jfit)
    Xt = torch.as_tensor(X)
    tfit = tk.fit(Xt, torch.as_tensor(y), torch.as_tensor(W), th, ts)
    tpred = tk.predict(tfit, Xt, ts)
    return jfit, tfit, np.asarray(jpred), tpred.numpy(), js, ts


def _data(n=120, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * [1, 10, 0.1, 3, 1][:d] + [0, 5, 0, -2, 1][:d]).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    W = (rng.rand(3, n) > 0.3).astype(np.float32)
    return X, y, W


@pytest.mark.parametrize("name,params", [
    ("LinearRegression", {}), ("LinearRegression", {"fit_intercept": False}),
    ("Ridge", {"alpha": 0.5}), ("Ridge", {"alpha": 30.0})])
def test_linear_fit_matches_jax(name, params):
    X, y, W = _data()
    jfit, tfit, jp, tp, _, _ = _lanes(name, params, X, y, W)
    np.testing.assert_allclose(tfit.numpy(), np.asarray(jfit), rtol=LINEAR_RTOL, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=LINEAR_RTOL, atol=1e-4)


@pytest.mark.parametrize("model,grid", [
    (LinearRegression(), {"fit_intercept": [True, False]}),
    (Ridge(), {"alpha": [0.1, 1.0, 100.0]})])
def test_linear_search_matches_jax(model, grid, tmp_path):
    X, y, _ = _data(n=400)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(X.shape[1])])
    df["target"] = y
    path = str(tmp_path / "lin.csv")
    df.to_csv(path, index=False)
    _both(GridSearchCV(model, grid, cv=5), "lin", LINEAR_RTOL, path)


def _both(search, dataset, tol, local_csv=None):
    managers = (JaxManager(), TorchManager(device="cpu"))
    for m in managers if local_csv else ():
        assert m.download_data(local_csv, dataset, "local")["status"] == "success"
    js = managers[0].train(search, dataset, {"random_state": 42}, show_progress=False)
    ts = managers[1].train(search, dataset, {"random_state": 42})
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r  # noqa: E731
                    for r in s["job_result"]["results"]}
    jr, tr = by(js), by(ts)
    assert jr.keys() == tr.keys() and jr
    for key in jr:
        assert tr[key]["mean_cv_score"] == pytest.approx(jr[key]["mean_cv_score"], abs=tol), key
        assert set(tr[key]) & METRIC_KEYS == set(jr[key]) & METRIC_KEYS
    return tr


@pytest.mark.parametrize("name,params", [
    ("StandardScaler", {}), ("StandardScaler", {"with_mean": False}),
    ("MinMaxScaler", {}), ("MinMaxScaler", {"feature_range": (-2, 3), "clip": True}),
])
def test_scalers_match_jax(name, params):
    X, y, W = _data()
    jfit, tfit, jp, tp, _, _ = _lanes(name, params, X, y, W)
    for k in jfit:
        np.testing.assert_allclose(tfit[k].numpy(), np.asarray(jfit[k]), rtol=TRANSFORM_TOL,
                                   atol=TRANSFORM_TOL)
    np.testing.assert_allclose(tp, jp, rtol=TRANSFORM_TOL, atol=TRANSFORM_TOL)


@pytest.mark.parametrize("params", [{"n_components": 3}, {"n_components": 2, "whiten": True}])
def test_pca_matches_jax_up_to_sign(params):
    X, y, W = _data()
    jfit, tfit, jp, tp, js, ts = _lanes("PCA", params, X, y, W)
    jc, tc = np.asarray(jfit["components"]), tfit["components"].numpy()  # [L, k, d]
    sign = np.sign(np.sum(jc * tc, axis=-1, keepdims=True))
    assert np.all(sign != 0)
    np.testing.assert_allclose(tc * sign, jc, atol=1e-4)
    np.testing.assert_allclose(tp * np.swapaxes(sign, 1, 2), jp, rtol=1e-4, atol=1e-4)
    for k in ("mean", "explained_variance", "explained_variance_ratio"):
        np.testing.assert_allclose(tfit[k].numpy(), np.asarray(jfit[k]), rtol=TRANSFORM_TOL,
                                   atol=TRANSFORM_TOL)
    jk, tk = jax_kernel("PCA"), get_kernel("PCA")
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    jscore = [float(jk.evaluate(jax.tree_util.tree_map(lambda a: a[i], jfit), Xj, None,
                                jnp.asarray(W[i]), js)["score"]) for i in range(3)]
    tscore = tk.evaluate(tfit, Xt, None, torch.as_tensor(W), ts)["score"].numpy()
    np.testing.assert_allclose(tscore, jscore, rtol=TRANSFORM_TOL)


def test_one_hot_encoder_matches_jax():
    rng = np.random.RandomState(2)
    X = rng.randint(0, 6, (80, 3)).astype(np.float32)
    X[0, 1] = 40  # past max_categories: an all-zero block
    W = (rng.rand(3, 80) > 0.4).astype(np.float32)
    jfit, tfit, jp, tp, _, _ = _lanes("OneHotEncoder", {"max_categories": 8}, X,
                                       np.zeros(80, np.float32), W)
    assert np.array_equal(tfit["n_cats"].numpy(), np.asarray(jfit["n_cats"]))
    assert tp.shape == (3, 80, 24) and np.array_equal(tp, jp)


@pytest.mark.parametrize("name", ["SimpleImputer", "Imputer"])
@pytest.mark.parametrize("strategy", ["mean", "median", "constant"])
def test_imputer_matches_jax(name, strategy):
    X, y, W = _data()
    X[::7, 1] = np.nan
    X[3, :] = np.inf
    jfit, tfit, jp, tp, js, ts = _lanes(name, {"strategy": strategy, "fill_value": -1.5}, X, y, W)
    np.testing.assert_allclose(tfit["fill"].numpy(), np.asarray(jfit["fill"]), rtol=TRANSFORM_TOL,
                               atol=TRANSFORM_TOL)
    np.testing.assert_allclose(tp, jp, rtol=TRANSFORM_TOL, atol=TRANSFORM_TOL)
    assert np.isfinite(tp).all()


def test_imputer_median_of_an_even_count():
    """Four observed values in a lane: the median is the mean of the two
    middle ones (2.5), as jnp.nanmedian gives; torch.nanmedian gives 2."""
    X = np.array([[1.0], [2.0], [np.nan], [3.0], [4.0], [100.0]], np.float32)
    W = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], np.float32)
    jfit, tfit, _, _, _, _ = _lanes("SimpleImputer", {"strategy": "median"}, X,
                                    np.zeros(6, np.float32), W)
    assert tfit["fill"][:, 0].tolist() == [2.5, 3.0] == np.asarray(jfit["fill"])[:, 0].tolist()
    assert float(torch.nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.0


@pytest.mark.parametrize("model,grid", [
    (PCA(), {"n_components": [1, 3]}), (StandardScaler(), {"with_mean": [True, False]}),
    (MinMaxScaler(), {"clip": [True, False]}), (SimpleImputer(), {"strategy": ["mean", "median"]})])
def test_transform_search_matches_jax(model, grid):
    tr = _both(GridSearchCV(model, grid, cv=3), "iris", TRANSFORM_TOL)
    assert all("score" in r and "scoring" not in r for r in tr.values())


def test_transform_refuses_a_scorer():
    ts = TorchManager(device="cpu").train(
        GridSearchCV(PCA(), {"n_components": [1, 2]}, cv=3, scoring="r2"), "iris")
    res = ts["job_result"]
    assert res["results"] == [] and "not applicable" in res["failed"][0]["error"]
