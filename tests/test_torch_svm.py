"""The port's SVC and SVR against the JAX package's, on the CPU.

Mirrors ``tests/test_svm.py``: the same numpy inputs through both packages'
``fit`` and ``predict`` (the port's with lane dims ``[T, S]``), then the
reference's own bars against scikit-learn. Tolerances:

- labels: equal to the JAX package's on at least 99 % of the rows;
- SVC decision values within 5e-3 absolute, SVR predictions within 1e-2
  on targets scaled to [-1, 1]: both packages round the RBF Gram to bf16
  for the ascent, but each computes the Gram in its own f32 sum order,
  so a few entries round to neighbouring bf16 values and the FISTA
  iterates drift by that much;
- the Nyström path (``_MAX_N`` cut to 500 in both packages, 256
  landmarks) within 1e-3: its features and solve are f32 throughout;
- searches through both managers: every mean_cv_score within 2e-3.
"""

import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.datasets import load_iris, make_classification, make_regression
from sklearn.metrics import r2_score
from sklearn.model_selection import GridSearchCV, train_test_split
from sklearn.svm import SVC, SVR

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models import svm as jsvm
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models import svm as tsvm
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

LABEL_AGREE = 0.99
DECISION_TOL = 5e-3
SVR_TOL = 1e-2
NYSTROM_TOL = 1e-3
SEARCH_TOL = 2e-3


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


@pytest.fixture
def small_gate(monkeypatch):
    """The Nyström path from 500 rows on, with 256 landmarks, in both."""
    for mod in (jsvm, tsvm):
        monkeypatch.setattr(mod, "_MAX_N", 500)
    monkeypatch.setenv("CS230_SVM_NYSTROM_M", "256")


def _static(kernel, params, X, c):
    static_key, hyper = kernel.canonicalize(params)
    static = kernel.resolve_static(kernel.static_from_key(static_key), X.shape[0], X.shape[1], c)
    static["_n_classes"] = c
    return static, hyper


def _fits(name, X, y, params, c, w=None, Xq=None):
    """(JAX output, port output) of predict (SVR) or the OvO decision values
    (SVC) at ``Xq`` after a fit on the rows of ``w``; plus the port's static."""
    w = np.ones(X.shape[0], np.float32) if w is None else w
    Xq = X if Xq is None else Xq
    jk = jax_kernel(name)
    static, hyper = _static(jk, params, X, c)
    jf = jk.fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                {k: jnp.asarray(v, jnp.float32) for k, v in hyper.items()}, static)
    tk = get_kernel(name)
    tstatic, _ = _static(tk, params, X, c)
    Xt = torch.as_tensor(X)
    tf = tk.fit(Xt, torch.as_tensor(y), torch.as_tensor(w)[None],
                {k: torch.tensor([v], dtype=torch.float32) for k, v in hyper.items()}, tstatic)
    Xqt = Xt if Xq is X else torch.as_tensor(Xq)
    if name == "SVC":
        out = (np.asarray(jk._pair_decisions(jf, jnp.asarray(Xq), static)),
               tk._pair_decisions(tf, Xqt, tstatic)[0, 0].numpy(),
               np.asarray(jk.predict(jf, jnp.asarray(Xq), static)),
               tk.predict(tf, Xqt, tstatic)[0, 0].numpy())
    else:
        out = (np.asarray(jk.predict(jf, jnp.asarray(Xq), static)),
               tk.predict(tf, Xqt, tstatic)[0, 0].numpy())
    return out, tstatic, tf


def _iris():
    X, y = load_iris(return_X_y=True)
    return X.astype(np.float32), y.astype(np.int32)


def test_svc_rbf_multiclass_iris():
    X, y = _iris()
    w = np.ones(len(y), np.float32)
    w[::4] = 0.0  # a fold's mask: the fit sees 3 rows in 4
    (dj, dt, pj, pt), _, fitted = _fits("SVC", X, y, {"C": 1.0}, 3, w)
    np.testing.assert_allclose(dt, dj, atol=DECISION_TOL)
    assert (pj == pt).mean() >= LABEL_AGREE
    assert int(fitted["dual_steps"].max()) < 600  # the KKT stop ended the ascent
    sk = SVC(C=1.0).fit(X, y).score(X, y)
    (_, _, _, pt_all), _, _ = _fits("SVC", X, y, {"C": 1.0}, 3)
    assert abs((pt_all == y).mean() - sk) < 0.03


def test_svc_linear_binary():
    X, y = _iris()
    m = y < 2
    X, y = X[m], y[m]
    (dj, dt, pj, pt), _, _ = _fits("SVC", X, y, {"C": 1.0, "kernel": "linear"}, 2)
    np.testing.assert_allclose(dt, dj, atol=DECISION_TOL)
    assert (pj == pt).all()
    assert (pt == y).mean() >= SVC(C=1.0, kernel="linear").fit(X, y).score(X, y) - 0.02


def test_svr_rbf():
    X, y = make_regression(n_samples=200, n_features=5, noise=3.0, random_state=3)
    X = X.astype(np.float32)
    y = (y / np.abs(y).max()).astype(np.float32)
    (pj, pt), _, _ = _fits("SVR", X, y, {"C": 1.0, "epsilon": 0.01}, 0)
    np.testing.assert_allclose(pt, pj, atol=SVR_TOL)
    theirs = SVR(C=1.0, epsilon=0.01).fit(X, y).predict(X)
    assert r2_score(y, pt) > r2_score(y, theirs) - 0.1


def test_svc_gamma_numeric_bucket():
    X, y = _iris()
    (dj, dt, pj, pt), static, _ = _fits("SVC", X, y, {"C": 1.0, "gamma": 0.5}, 3)
    assert static["_gamma_mode"] == "numeric" and static["_gamma_value"] == 0.5
    np.testing.assert_allclose(dt, dj, atol=DECISION_TOL)
    assert (pt == y).mean() > 0.9


def test_svc_nystrom_beyond_gate(small_gate):
    X, y = make_classification(n_samples=2000, n_features=10, n_informative=6, n_classes=3,
                               n_clusters_per_class=2, random_state=0)
    X = X.astype(np.float32)
    Xtr, Xte, ytr, yte = train_test_split(X, y, test_size=0.25, random_state=0)
    (dj, dt, pj, pt), static, fitted = _fits("SVC", Xtr, ytr.astype(np.int32), {"C": 1.0}, 3,
                                             Xq=Xte)
    assert static.get("_nystrom") and "W" in fitted and fitted["Z"].shape[-1] == 257
    np.testing.assert_allclose(dt, dj, atol=NYSTROM_TOL)
    assert (pt == pj).mean() >= LABEL_AGREE
    sk = SVC(C=1.0).fit(Xtr, ytr).score(Xte, yte)
    assert (pt == yte).mean() > sk - 0.08


def test_svr_nystrom_beyond_gate(small_gate):
    X, y = make_regression(n_samples=2000, n_features=8, noise=3.0, random_state=1)
    X = X.astype(np.float32)
    y = (y / np.abs(y).max()).astype(np.float32)
    Xtr, Xte, ytr, yte = train_test_split(X, y, test_size=0.25, random_state=0)
    (pj, pt), static, fitted = _fits("SVR", Xtr, ytr, {"C": 1.0, "epsilon": 0.01}, 0, Xq=Xte)
    assert static.get("_nystrom") and "W" in fitted
    np.testing.assert_allclose(pt, pj, atol=NYSTROM_TOL)
    sk = SVR(C=1.0, epsilon=0.01).fit(Xtr, ytr)
    assert r2_score(yte, pt) > r2_score(yte, sk.predict(Xte)) - 0.1


def test_lanes_freeze_at_their_own_stop(monkeypatch):
    """T trials x S splits in one ascent: each lane stops at its own KKT
    step and gives its one-lane fit's decisions; the host's live-lane check
    interval changes nothing."""
    X, y = _iris()
    kernel = get_kernel("SVC")
    static, _ = _static(kernel, {}, X, 3)
    rng = np.random.RandomState(0)
    w = torch.as_tensor((rng.rand(3, len(y)) > 0.3).astype(np.float32))
    C = torch.tensor([0.1, 1.0, 10.0])
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    batched = kernel.fit(Xt, yt, w, {"C": C}, static)
    steps = batched["dual_steps"]
    assert steps.shape == (3, 3) and len(set(steps.flatten().tolist())) > 1
    dec = kernel._pair_decisions(batched, Xt, static)
    for t in range(3):
        for s in range(3):
            one = kernel.fit(Xt, yt, w[s:s + 1], {"C": C[t:t + 1]}, static)
            assert int(one["dual_steps"][0, 0]) == int(steps[t, s])
            np.testing.assert_allclose(kernel._pair_decisions(one, Xt, static)[0, 0].numpy(),
                                       dec[t, s].numpy(), atol=1e-5)
    monkeypatch.setattr(tsvm, "_LIVE_CHECK", 1)
    again = kernel.fit(Xt, yt, w, {"C": C}, static)
    assert torch.equal(again["dual"], batched["dual"])
    assert torch.equal(again["dual_steps"], steps)


def test_dual_stop_counter_is_bounded():
    """The module keeps two numbers whatever the fits: the ascents since the
    reset and the slowest lane's stop step among them."""
    X, y = _iris()
    kernel = get_kernel("SVC")
    static, _ = _static(kernel, {}, X, 3)
    w = torch.ones((2, len(y)))
    tsvm.reset_dual_stops()
    steps = [kernel.fit(torch.as_tensor(X), torch.as_tensor(y), w, {"C": torch.tensor([C])},
                        static)["dual_steps"] for C in (0.1, 10.0)]
    assert tsvm.DUAL_STOPS == {"ascents": 2,
                               "slowest_stop": max(int(s.max()) for s in steps)}
    tsvm.reset_dual_stops()
    assert tsvm.DUAL_STOPS == {"ascents": 0, "slowest_stop": 0}


def test_svr_is_no_margin_kernel():
    from cs230_distributed_machine_learning_tpu_torch.ops.metrics import validate_scoring

    validate_scoring("roc_auc", "classification", 2, get_kernel("SVC"))
    with pytest.raises(ValueError, match="class probabilities"):
        validate_scoring("neg_log_loss", "classification", 3, get_kernel("SVC"))


def _both(search, dataset, local_csv=None):
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
        assert tr[key]["mean_cv_score"] == pytest.approx(jr[key]["mean_cv_score"],
                                                         abs=SEARCH_TOL), key
    assert (ts["job_result"]["best_result"]["search_params"]
            == js["job_result"]["best_result"]["search_params"])


@pytest.mark.parametrize("scoring,dataset", [
    (None, "iris"), ("roc_auc", "synthetic_600x8x2"), ("f1_macro", "synthetic_600x8x3")])
def test_svc_search_matches_jax(scoring, dataset):
    _both(GridSearchCV(SVC(), {"C": [0.5, 4.0]}, cv=3, scoring=scoring), dataset)


def test_svr_search_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(400, 5).astype(np.float32)
    y = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.randn(400)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(5)])
    df["target"] = y.astype(np.float32)
    path = tmp_path / "svr.csv"
    df.to_csv(path, index=False)
    _both(GridSearchCV(SVR(), {"C": [0.5, 4.0], "epsilon": [0.05, 0.2]}, cv=3,
                       scoring="neg_mean_squared_error"), "svr", str(path))
