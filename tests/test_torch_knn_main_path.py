"""The PyTorch port's whole KNN search path against the JAX package, on the
CPU: MLTaskManager(device="cpu") -> Coordinator -> executor -> trial engine
(one dispatch a bucket, or ``_run_chunked`` over query chunks) -> KNN
kernel -> aggregation.

Both packages get the same builtin dataset and the same scikit-learn
search. ``best_params_`` must be equal. Every ``mean_cv_score`` of the
synthetic tables must be within 2e-3 (accuracy) or 1e-4 (r2); measured
equal to the last few bits. Iris is held by the count of eval rows
instead, at most 2 apart in any split: its features have one decimal, so
many neighbours tie exactly in decimal arithmetic, and which of them f32
rounding puts first depends on the order the dot products are summed in,
which differs between XLA and PyTorch (measured: one eval row apart in
one fold, at n_neighbors=5).
"""

import json

import numpy as np
import pytest
import torch
from sklearn.model_selection import GridSearchCV
from sklearn.neighbors import KNeighborsClassifier, KNeighborsRegressor

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn
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


def _by_params(status):
    return {json.dumps(r["search_params"], sort_keys=True): r
            for r in status["job_result"]["results"]}


def _both(search, dataset):
    js = JaxManager().train(search, dataset, {"random_state": 42}, show_progress=False)
    ts = TorchManager(device="cpu").train(search, dataset, {"random_state": 42})
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    jr, tr = _by_params(js), _by_params(ts)
    assert jr.keys() == tr.keys() and len(tr) > 1
    assert ts["job_result"]["best_result"]["search_params"] == \
        js["job_result"]["best_result"]["search_params"]
    return jr, tr


def test_iris_grid_matches_jax():
    """The reference's own KNN job (tests/test_knn_transforms.py:147)."""
    search = GridSearchCV(KNeighborsClassifier(), {"n_neighbors": [1, 3, 5, 7]}, cv=5)
    cuda_knn.reset_launches()
    jr, tr = _both(search, "iris")
    assert len(tr) == 4 and cuda_knn.LAUNCHES["knn_topk"] == 0
    # iris: every split (the holdout and the 5 folds) scores 30 eval rows
    for key in jr:
        j = np.array([jr[key]["accuracy"]] + jr[key]["cv_scores"])
        t = np.array([tr[key]["accuracy"]] + tr[key]["cv_scores"])
        assert (np.abs(t - j) * 30).max() <= 2 + 1e-3, key


def test_classifier_grid_both_weights_matches_jax():
    search = GridSearchCV(KNeighborsClassifier(),
                          {"n_neighbors": [3, 20], "weights": ["uniform", "distance"]}, cv=3)
    jr, tr = _both(search, "synthetic_600x8x3")
    for key in jr:
        assert tr[key]["mean_cv_score"] == pytest.approx(jr[key]["mean_cv_score"], abs=2e-3), key


def test_regressor_grid_both_weights_matches_jax():
    search = GridSearchCV(KNeighborsRegressor(),
                          {"n_neighbors": [5, 20], "weights": ["uniform", "distance"]}, cv=3)
    jr, tr = _both(search, "synthetic_600x8x3")
    for key in jr:
        assert tr[key]["mean_cv_score"] == pytest.approx(jr[key]["mean_cv_score"], abs=1e-4), key
        assert tr[key]["r2_score"] == pytest.approx(jr[key]["r2_score"], abs=1e-4), key
        assert tr[key]["mse"] == pytest.approx(jr[key]["mse"], rel=1e-4), key


def test_chunked_search_matches_jax(monkeypatch):
    """Both engines split each bucket into query chunks (the budget cut so
    that 1,500 rows take 2 chunks of 1,024, the last one ragged)."""
    from cs230_distributed_machine_learning_tpu_torch.models.knn import KNNClassifierKernel

    monkeypatch.setenv("CS230_KNN_CHUNK_MACS", "3e7")
    static = {"n_neighbors": 20, "weights": "uniform", "p": 2}
    plan = KNNClassifierKernel().chunked_plan(static, 1500, 8, 3, 4, device=torch.device("cpu"))
    assert plan == {"n_chunks": 2, "rows_per_chunk": 1024}
    search = GridSearchCV(KNeighborsClassifier(),
                          {"n_neighbors": [5, 20], "weights": ["uniform", "distance"]}, cv=3)
    jr, tr = _both(search, "synthetic_1500x8x3")
    for key in jr:
        assert tr[key]["mean_cv_score"] == pytest.approx(jr[key]["mean_cv_score"], abs=2e-3), key
