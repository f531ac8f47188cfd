"""The port's whole RandomForestClassifier search path against the JAX
package, on the CPU: MLTaskManager(device="cpu") -> Coordinator -> executor
-> trial engine (generic lane path or ``_run_chunked``) -> forest kernel ->
tree builders -> B4's plain version -> aggregation.

Both packages get the same builtin dataset and the same scikit-learn
search; ``best_params_`` must be equal and every ``mean_cv_score`` within
1e-6. Three routes: iris (complete builder, one dispatch per bucket), a
deep-arena search (``CS230_TREE_DEEP_N`` lowered) and a chunked fit
(``CS230_TREE_CHUNK_MACS`` lowered), the last as a plain estimator, the
form of the repo's scaling curve. The arena is cut to 6 levels in both
packages so the JAX side compiles in seconds.
"""

import json

import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist
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


@pytest.fixture
def short_arena(monkeypatch):
    for mod in (jmt, tmt):
        monkeypatch.setattr(mod, "_DEEP_LEVELS", 6)


def _both(search, dataset):
    js = JaxManager().train(search, dataset, {"random_state": 42}, show_progress=False)
    ts = TorchManager(device="cpu").train(search, dataset, {"random_state": 42})
    assert js["job_status"] == ts["job_status"] == "completed"
    assert not ts["job_result"]["failed"], ts["job_result"]["failed"][:1]
    by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r  # noqa: E731
                    for r in s["job_result"]["results"]}
    jr, tr = by(js), by(ts)
    assert jr.keys() == tr.keys()
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=1e-6), k
        assert tr[k]["accuracy"] == pytest.approx(jr[k]["accuracy"], abs=1e-6), k
    assert (ts["job_result"]["best_result"]["search_params"]
            == js["job_result"]["best_result"]["search_params"])
    return ts


def _resolved(dataset_rows, d, c, params):
    kernel = tmt.RandomForestClassifierKernel()
    static = kernel.resolve_static(dict(params), dataset_rows, d, c)
    static["_n_classes"] = c
    return kernel, static


def test_iris_grid_matches_jax():
    """BASELINE config 1's family on iris: the complete builder (depth 6,
    128 bins), one lane per (trial, split), no chunking."""
    kernel, static = _resolved(150, 4, 3, {"n_estimators": 4})
    assert not static.get("_deep") and static["_depth"] == 6
    assert kernel.chunked_plan(static, 150, 4, 3, 6) is None
    cuda_hist.reset_launches()
    ts = _both(GridSearchCV(RandomForestClassifier(random_state=0),
                            {"n_estimators": [2, 4]}, cv=5), "iris")
    assert len(ts["job_result"]["results"]) == 2
    assert cuda_hist.LAUNCHES["level_histogram"] == 0  # CPU tensors: plain version


def test_deep_arena_search_matches_jax(monkeypatch, short_arena):
    monkeypatch.setenv("CS230_TREE_DEEP_N", "256")
    kernel, static = _resolved(600, 8, 3, {"n_estimators": 3})
    assert static["_deep"] and static["_levels"] == 6 and static["_W"] == 64
    assert kernel.chunked_plan(static, 600, 8, 3, 4) is None
    _both(GridSearchCV(RandomForestClassifier(random_state=1),
                       {"n_estimators": [2, 3]}, cv=3),
          "synthetic_600x8x3")


def test_chunked_plain_estimator_matches_jax(monkeypatch, short_arena):
    """A plain estimator (search_type None), the scaling curve's form, whose
    forest is split across chunks of trees (``_run_chunked``)."""
    monkeypatch.setenv("CS230_TREE_DEEP_N", "256")
    monkeypatch.setenv("CS230_TREE_CHUNK_MACS", "1e8")
    kernel, static = _resolved(600, 8, 3, {"n_estimators": 4, "random_state": 42})
    assert kernel.chunked_plan(static, 600, 8, 3, 6)["n_chunks"] == 4
    ts = _both(RandomForestClassifier(n_estimators=4, random_state=42), "synthetic_600x8x3")
    assert len(ts["job_result"]["results"]) == 1
