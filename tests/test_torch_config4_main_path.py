"""BASELINE config 4 through both MLTaskManagers, on the CPU: the titanic
builtin staged raw, preprocessed with examples/titanic_preprocess.yaml,
then ``GridSearchCV(GradientBoostingRegressor(random_state=0),
{n_estimators: [50, 100], learning_rate: [0.05, 0.1]}, cv=5)`` (as
benchmarks/measure_baseline.py runs it).

The port takes the search as the ``model_details`` payload chip_smoke.py
sends (the chip's machine has no scikit-learn) and the config as a dict.
``best_params_`` must be equal and every ``mean_cv_score`` (r2) within
2e-3: boosting's float-stat histograms add their bin prefix sums in other
orders in the two packages, so a close call may go either way and compound
over the stages (test_torch_boosting.py holds the stages one by one).
"""

import json

import pytest
import torch
import yaml
from sklearn.ensemble import GradientBoostingRegressor
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

SCORE_TOL = 2e-3
GRID = {"n_estimators": [50, 100], "learning_rate": [0.05, 0.1]}
MODEL_DETAILS = {
    "model_type": "GradientBoostingRegressor", "search_type": "GridSearchCV",
    "base_estimator_params": {"random_state": 0}, "param_grid": GRID,
    "cv_params": {"cv": 5},
}


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _stage(manager, config):
    assert manager.download_data("titanic", "titanic", "builtin")["status"] == "success"
    out = manager.preprocess("titanic", config)
    assert out["status"] == "success"
    return out["n_rows"]


def test_config4_download_preprocess_train_matches_jax():
    with open("examples/titanic_preprocess.yaml") as f:
        config = yaml.safe_load(f)
    jm, tm = JaxManager(), TorchManager(device="cpu")
    assert _stage(jm, config) == _stage(tm, dict(config)) == 867
    js = jm.train(GridSearchCV(GradientBoostingRegressor(random_state=0), GRID, cv=5),
                  "titanic", {"random_state": 42}, show_progress=False)
    ts = tm.train(MODEL_DETAILS, "titanic", {"random_state": 42})
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r  # noqa: E731
                    for r in s["job_result"]["results"]}
    jr, tr = by(js), by(ts)
    assert jr.keys() == tr.keys() and len(tr) == 4
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=SCORE_TOL), k
        assert tr[k]["r2_score"] == pytest.approx(jr[k]["r2_score"], abs=SCORE_TOL), k
        assert tr[k]["mse"] > 0 and len(tr[k]["cv_scores"]) == 5
    assert (ts["job_result"]["best_result"]["search_params"]
            == js["job_result"]["best_result"]["search_params"])
    # two buckets (n_estimators is static), unchunked at this size
    kernel = get_kernel("GradientBoostingRegressor")
    data = tm._coordinator.cache.get("titanic", "regression")
    assert data.X.shape == (867, 12)
    for n_estimators in GRID["n_estimators"]:
        static = kernel.resolve_static(kernel.static_from_key(kernel.canonicalize(
            {"random_state": 0, "n_estimators": n_estimators})[0]), 867, 12, 0)
        assert static["_depth"] == 3 and static["_n_bins"] == 128
        assert kernel.chunked_plan(static, 867, 12, 0, 6) is None
