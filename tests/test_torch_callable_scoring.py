"""Callable scorers in the port against the JAX package, on the CPU.

A callable ``scoring`` takes the host-side path
(``parallel/trial_map.py::run_trials_callable``): ``fit_single`` per
(trial, split) on the device, the scikit-learn export, the user's
``scorer(estimator, X, y)`` on the host. The cases of
``tests/test_scoring.py``'s callable tests, through both managers:

- ``make_scorer(f1_score, average="macro")`` on iris: every trial's
  holdout and CV scores within 2e-3 of the JAX package's, the same
  ``best_params_``;
- a scorer that raises marks its trial diverged at -inf with the
  ``scorer_error`` and leaves the job ``completed``;
- a plain callable ``(est, X, y)`` on a forest, whose fits are exact in
  both packages: the scores agree within 1e-6.
"""

import json

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import balanced_accuracy_score, f1_score, make_scorer
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.runtime import executor as texec
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    """The port's storage root in a per-test tmpdir (conftest does the
    same for the JAX package)."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _both(search, dataset="iris"):
    js = JaxManager().train(search, dataset, {"random_state": 0}, show_progress=False)
    ts = TorchManager(device="cpu").train(search, dataset, {"random_state": 0})
    assert js["job_status"] == ts["job_status"] == "completed"
    by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r  # noqa: E731
                    for r in s["job_result"]["results"]}
    return js, ts, by(js), by(ts)


@pytest.mark.parametrize("search,tol", [
    (GridSearchCV(LogisticRegression(max_iter=100), {"C": [1e-3, 1e-2, 0.1, 1.0]}, cv=3,
                  scoring=make_scorer(f1_score, average="macro")), 2e-3),
    (GridSearchCV(RandomForestClassifier(n_estimators=5, random_state=0),
                  {"max_depth": [1, 3]}, cv=3,
                  scoring=lambda est, X, y: balanced_accuracy_score(y, est.predict(X))), 1e-6),
], ids=["logreg_f1_macro", "forest_balanced_accuracy"])
def test_callable_scores_match_jax(search, tol):
    js, ts, jr, tr = _both(search)
    assert not ts["job_result"]["failed"] and jr.keys() == tr.keys() and len(tr) > 1
    for k in jr:
        assert tr[k]["scoring"] == jr[k]["scoring"] == "callable"
        assert tr[k]["score"] == pytest.approx(jr[k]["score"], abs=tol), k
        assert tr[k]["cv_scores"] == pytest.approx(jr[k]["cv_scores"], abs=tol), k
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=tol), k
        assert np.isfinite(tr[k]["mean_cv_score"])
    assert ts["job_result"]["best_result"]["search_params"] == \
        js["job_result"]["best_result"]["search_params"]


def test_callable_scoring_takes_the_host_path(monkeypatch):
    """A callable job never enters the batched trial engine: its fits are
    one lane a (trial, split), through ``fit_single``."""
    from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map

    def no_batched(*args, **kwargs):
        raise AssertionError("a callable job reached run_trials")

    fits = []
    fit_single = trial_map.fit_single
    monkeypatch.setattr(texec, "run_trials", no_batched)
    monkeypatch.setattr(trial_map, "fit_single",
                        lambda *a, **k: fits.append(k.get("split")) or fit_single(*a, **k))
    ts = TorchManager(device="cpu").train(
        GridSearchCV(LogisticRegression(max_iter=50), {"C": [0.5, 1.0]}, cv=3,
                     scoring=make_scorer(f1_score, average="macro")), "iris")
    assert [r["scoring"] for r in ts["job_result"]["results"]] == ["callable"] * 2
    assert fits == [0, 1, 2, 3] * 2  # the holdout and 3 folds, per trial


def test_callable_scorer_error_fails_trial_not_job():
    def bad_scorer(est, Xe, ye):
        raise RuntimeError("scorer bug")

    search = GridSearchCV(LogisticRegression(max_iter=100), {"C": [1.0]}, cv=3,
                          scoring=bad_scorer)
    js, ts, jr, tr = _both(search)
    (r,) = ts["job_result"]["results"]
    (j,) = js["job_result"]["results"]
    assert ts["job_result"]["failed"] == [] and ts["job_status"] == "completed"
    assert r.get("diverged") is True and "scorer bug" in r.get("scorer_error", "")
    assert r["mean_cv_score"] in (None, float("-inf"))  # -inf, nulled by the journal's JSON
    assert r["mean_cv_score"] == j["mean_cv_score"]
    assert r["scorer_error"] == j["scorer_error"]
