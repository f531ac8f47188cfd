"""The PyTorch port's whole MLP search path against the JAX package, on the
CPU: MLTaskManager -> Coordinator -> executor -> trial engine -> MLP kernel
-> aggregation, for an MLPClassifier and an MLPRegressor search.

Both packages take their generic path here (the fused path needs the card,
or a TPU on the JAX side). ``best_params_`` must be identical and every
``mean_cv_score`` within 2e-3 (accuracy) or 1e-3 (r2); measured equal
for the classifier and 1.3e-4 apart for the regressor (r2 near -1.2, a
fold with little target variance). The thresholds of the reference's own MLP tests are not
used: the port is held to the reference's outputs on the same inputs.
"""

import json

import pytest
import torch
from sklearn.model_selection import GridSearchCV, RandomizedSearchCV
from sklearn.neural_network import MLPClassifier, MLPRegressor

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)

DATASET = "synthetic_600x8x3"


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    """Point the port's storage root at a per-test tmpdir (conftest does
    the same for the JAX package)."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _by_params(status):
    return {json.dumps(r["search_params"], sort_keys=True): r
            for r in status["job_result"]["results"]}


def _assert_same_search(js, ts, atol):
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    jr, tr = _by_params(js), _by_params(ts)
    assert jr.keys() == tr.keys() and len(tr) > 1
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=atol), k
        assert tr[k]["curve"]["steps"] == jr[k]["curve"]["steps"]
    assert ts["job_result"]["best_result"]["search_params"] == \
        js["job_result"]["best_result"]["search_params"]


def _classifier_search():
    return RandomizedSearchCV(
        MLPClassifier(max_iter=3, random_state=0),
        {"hidden_layer_sizes": [(8,), (12, 6)], "learning_rate_init": [1e-3, 1e-2, 3e-2],
         "alpha": [1e-4, 1e-2], "batch_size": [64]},
        n_iter=5, cv=3, random_state=0,
    )


def test_mlp_classifier_search_matches_jax():
    search = _classifier_search()
    js = JaxManager().train(search, DATASET, {"random_state": 42}, show_progress=False)
    ts = TorchManager(device="cpu").train(search, DATASET, {"random_state": 42})
    _assert_same_search(js, ts, atol=2e-3)
    best = ts["job_result"]["best_result"]
    assert 0.0 <= best["accuracy"] <= 1.0 and len(best["cv_scores"]) == 3
    assert best["curve"]["gmax"] and best["curve"]["loss"]


def test_mlp_regressor_search_matches_jax():
    search = GridSearchCV(
        MLPRegressor(hidden_layer_sizes=(8,), max_iter=3, batch_size=64, random_state=0),
        {"alpha": [1e-4, 1e-2], "learning_rate_init": [1e-3, 1e-2]}, cv=3,
    )
    js = JaxManager().train(search, DATASET, {"random_state": 42}, show_progress=False)
    ts = TorchManager(device="cpu").train(search, DATASET, {"random_state": 42})
    _assert_same_search(js, ts, atol=1e-3)
    jr, tr = _by_params(js), _by_params(ts)
    for k in jr:  # the regressor's extra leaf: the holdout MSE
        assert tr[k]["mse"] == pytest.approx(jr[k]["mse"], rel=1e-3), k
        assert tr[k]["r2_score"] == pytest.approx(jr[k]["r2_score"], abs=1e-3), k


def test_payload_with_list_sizes_matches_sklearn_objects():
    """A user without scikit-learn passes hidden_layer_sizes as lists in the
    model_details payload: the same trials, buckets and scores."""
    details = {
        "model_type": "MLPClassifier", "search_type": "RandomizedSearchCV",
        "base_estimator_params": {"max_iter": 3, "random_state": 0},
        "param_distributions": {"hidden_layer_sizes": [[8], [12, 6]],
                                "learning_rate_init": [1e-3, 1e-2, 3e-2],
                                "alpha": [1e-4, 1e-2], "batch_size": [64]},
        "n_iter": 5, "random_state": 0, "cv_params": {"cv": 3},
    }
    a = TorchManager(device="cpu").train(_classifier_search(), DATASET)
    b = TorchManager(device="cpu").train(details, DATASET)
    ra, rb = _by_params(a), _by_params(b)
    assert ra.keys() == rb.keys() and len(ra) == 5
    for k in ra:
        assert ra[k]["cv_scores"] == rb[k]["cv_scores"]
