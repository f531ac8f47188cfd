"""The PyTorch port's whole LogisticRegression search path against the JAX
package, on the CPU: MLTaskManager -> Coordinator -> executor -> trial
engine -> LogReg kernel -> aggregation, plus its data layer and package
boundaries.

The search parity tests feed both packages the same builtin dataset and
the same sklearn search object; ``best_params_`` must be identical and
every ``mean_cv_score`` within 2e-3.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.stats import loguniform
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import GridSearchCV, RandomizedSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.data import datasets as jds
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops.folds import build_split_plan as jax_plan
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.data import datasets as tds
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel as torch_kernel
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan as torch_plan
from cs230_distributed_machine_learning_tpu_torch.runtime.store import JobStore
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)


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


def _assert_same_search(js, ts):
    assert js["job_status"] == ts["job_status"] == "completed"
    jr, tr = _by_params(js), _by_params(ts)
    assert jr.keys() == tr.keys()
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=2e-3), k
    # best_params_: the winning trial's sampled parameters
    assert ts["job_result"]["best_result"]["search_params"] == \
        js["job_result"]["best_result"]["search_params"]


def test_packed_random_search_matches_jax(monkeypatch):
    """bench.py's job shape (RandomizedSearchCV over C and tol) at a tier-1
    size, forced onto the packed path in both packages: the port runs the
    fused step kernel's plain version, the JAX package its Pallas kernel in
    interpret mode."""
    monkeypatch.setenv("CS230_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    for kernel in (jax_kernel("LogisticRegression"), torch_kernel("LogisticRegression")):
        orig = kernel.resolve_static
        monkeypatch.setattr(kernel, "resolve_static",
                            lambda s, n, d, c, o=orig: {**o(s, n, d, c), "_method": "nesterov"})
    search = RandomizedSearchCV(
        LogisticRegression(max_iter=50),
        {"C": loguniform(1e-4, 1e1), "tol": [1e-4, 1e-3]},
        n_iter=6, cv=5, random_state=0,
    )
    ds = "synthetic_2000x10x3"
    js = JaxManager().train(search, ds, {"random_state": 42}, show_progress=False)
    tm = TorchManager(device="cpu")
    ts = tm.train(search, ds, {"random_state": 42})
    _assert_same_search(js, ts)
    assert len(ts["job_result"]["results"]) == 6
    assert len(tm.check_job_status()) == 6
    assert tm.best_result() == ts["job_result"]["best_result"]


def test_iris_grid_search_newton_matches_jax():
    search = GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.01, 0.1, 1.0, 10.0]}, cv=5)
    js = JaxManager().train(search, "iris", show_progress=False)
    ts = TorchManager(device="cpu").train(search, "iris")
    _assert_same_search(js, ts)


def test_train_takes_bench_keywords_like_jax():
    """Both managers called with the keywords bench.py passes
    (``train_params``, ``show_progress=False``, ``timeout``), positionally
    where bench.py is: the same winner. ``stream=True`` follows the job to
    the same result, and ``search_params`` runs the search as ASHA with the
    JAX package's winner."""
    search = GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.1, 1.0]}, cv=3)
    kw = dict(show_progress=False, timeout=600)
    js = JaxManager().train(search, "iris", {"random_state": 42}, **kw)
    tm = TorchManager(device="cpu")
    ts = tm.train(search, "iris", {"random_state": 42}, **kw)
    _assert_same_search(js, ts)
    # the JAX signature's positional order: wait_for_completion, timeout, show_progress
    ts2 = tm.train(search, "iris", {"random_state": 42}, True, 600, False)
    assert ts2["job_result"]["best_result"]["search_params"] == \
        ts["job_result"]["best_result"]["search_params"]
    streamed = tm.train(search, "iris", {"random_state": 42}, stream=True, **kw)
    assert streamed["job_status"] == "completed"
    assert streamed["job_result"]["best_result"]["search_params"] == \
        ts["job_result"]["best_result"]["search_params"]
    asha = {"type": "asha", "eta": 3}
    ja = JaxManager().train(search, "iris", {"random_state": 42}, search_params=asha, **kw)
    ta = tm.train(search, "iris", {"random_state": 42}, search_params=asha, **kw)
    assert ta["job_result"]["search"] == ja["job_result"]["search"]
    assert ta["job_result"]["best_result"]["parameters"] == \
        ja["job_result"]["best_result"]["parameters"]


def test_synthetic_covertype_and_fold_plans_are_identical():
    jdf = jds._synthetic_covertype(n=2000)
    tdf = tds._synthetic_covertype(n=2000)
    assert list(jdf.columns) == list(tdf.columns)
    assert jdf.to_numpy().tobytes() == tdf.to_numpy().tobytes()
    y = tdf["Cover_Type"].to_numpy()
    jp = jax_plan(y, task="classification", n_folds=5, random_state=42)
    tp = torch_plan(y, task="classification", n_folds=5, random_state=42)
    assert jp.train_w.tobytes() == tp.train_w.tobytes()
    assert jp.eval_w.tobytes() == tp.eval_w.tobytes()
    assert jp.signature == tp.signature


@pytest.mark.parametrize("name", ["iris", "covertype"])
def test_csv_parse_matches_jax_loader(tmp_path, name):
    """The port parses staged CSVs with pandas; the JAX package with its
    native loader when the toolchain is there. Both must yield equal
    arrays and the same label encoding (covertype cut to 2000 rows)."""
    roots = {"j": str(tmp_path / "j"), "t": str(tmp_path / "t")}
    if name == "covertype":
        for key, mod in (("j", jds), ("t", tds)):
            pre = os.path.join(roots[key], name, "preprocessed")
            os.makedirs(pre)
            mod._synthetic_covertype(n=2000).to_csv(
                os.path.join(pre, f"{name}_preprocessed.csv"), index=False)
    jd = jds.DatasetCache(root=roots["j"]).get(name, "classification")
    td = tds.DatasetCache(root=roots["t"]).get(name, "classification")
    with open(jds.find_csv(name, preprocessed=True, root=roots["j"]), "rb") as f1, \
            open(tds.find_csv(name, preprocessed=True, root=roots["t"]), "rb") as f2:
        assert f1.read() == f2.read()
    assert jd.X.dtype == td.X.dtype == np.float32
    np.testing.assert_array_equal(jd.X, td.X)
    np.testing.assert_array_equal(jd.y, td.y)
    assert jd.n_classes == td.n_classes


def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter with scikit-learn made unimportable, the port
    runs a small LogReg search, a small forest, a small MLP search and a
    small KNN search from model_details payloads (the form a user without
    scikit-learn passes) and never loads JAX or the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None  # any import of it now fails\n"
        "from cs230_distributed_machine_learning_tpu_torch import MLTaskManager\n"
        "import cs230_distributed_machine_learning_tpu_torch.ops.cuda_logreg\n"
        "details = {'model_type': 'LogisticRegression',\n"
        "           'search_type': 'RandomizedSearchCV',\n"
        "           'base_estimator_params': {'max_iter': 30},\n"
        "           'param_distributions': {'C': [0.01, 0.1, 1.0], 'tol': [1e-4]},\n"
        "           'n_iter': 3, 'random_state': 0, 'cv_params': {'cv': 3}}\n"
        "s = MLTaskManager(device='cpu').train(details, 'synthetic_300x6x3')\n"
        "assert s['job_status'] == 'completed', s\n"
        "assert len(s['job_result']['results']) == 3, s\n"
        "import cs230_distributed_machine_learning_tpu_torch.ops.cuda_hist\n"
        "rf = {'model_type': 'RandomForestClassifier', 'search_type': None,\n"
        "      'base_estimator_params': {'n_estimators': 2, 'random_state': 0}}\n"
        "s = MLTaskManager(device='cpu').train(rf, 'synthetic_300x6x3')\n"
        "assert s['job_status'] == 'completed' and not s['job_result']['failed'], s\n"
        "import cs230_distributed_machine_learning_tpu_torch.ops.cuda_mlp\n"
        "mlp = {'model_type': 'MLPClassifier', 'search_type': 'GridSearchCV',\n"
        "       'base_estimator_params': {'max_iter': 2, 'hidden_layer_sizes': [4]},\n"
        "       'param_grid': {'alpha': [1e-4, 1e-3]}, 'cv_params': {'cv': 3}}\n"
        "s = MLTaskManager(device='cpu').train(mlp, 'synthetic_300x6x3')\n"
        "assert s['job_status'] == 'completed' and not s['job_result']['failed'], s\n"
        "import cs230_distributed_machine_learning_tpu_torch.ops.cuda_knn\n"
        "import cs230_distributed_machine_learning_tpu_torch.ops.kernel_cases\n"
        "knn = {'model_type': 'KNeighborsClassifier', 'search_type': 'GridSearchCV',\n"
        "       'base_estimator_params': {},\n"
        "       'param_grid': {'n_neighbors': [3, 20], 'weights': ['uniform', 'distance']},\n"
        "       'cv_params': {'cv': 3}}\n"
        "s = MLTaskManager(device='cpu').train(knn, 'synthetic_300x6x3')\n"
        "assert s['job_status'] == 'completed' and not s['job_result']['failed'], s\n"
        "assert len(s['job_result']['results']) == 4, s\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m.startswith('jaxlib.') or m == 'cs230_distributed_machine_learning_tpu'\n"
        "       or m.startswith('cs230_distributed_machine_learning_tpu.')]\n"
        "print(bad)\n"
    )
    env = {**os.environ, "TPUML_STORAGE__ROOT": str(tmp_path), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_model_details_payload_matches_sklearn_objects():
    """The payload form of a search gives the same trials and scores as the
    scikit-learn objects it stands for."""
    from scipy.stats import loguniform as lu

    search = RandomizedSearchCV(LogisticRegression(max_iter=30),
                                {"C": lu(1e-2, 1e1), "tol": [1e-4, 1e-3]},
                                n_iter=4, cv=3, random_state=0)
    details = {"model_type": "LogisticRegression", "search_type": "RandomizedSearchCV",
               "base_estimator_params": {"max_iter": 30},
               "param_distributions": {"C": lu(1e-2, 1e1), "tol": [1e-4, 1e-3]},
               "n_iter": 4, "random_state": 0, "cv_params": {"cv": 3}}
    a = TorchManager(device="cpu").train(search, "synthetic_300x6x3")
    b = TorchManager(device="cpu").train(details, "synthetic_300x6x3")
    ra, rb = _by_params(a), _by_params(b)
    assert ra.keys() == rb.keys() and len(ra) == 4
    for k in ra:
        assert ra[k]["cv_scores"] == rb[k]["cv_scores"]


def test_default_device_is_the_card():
    """No device argument means CUDA: without a card that raises instead
    of running on the host."""
    if torch.cuda.is_available():
        assert TorchManager().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchManager()


def test_not_yet_ported_model_fails_its_subtasks():
    """Every family of the JAX package is ported: a model type neither
    package supports still fails its subtasks, and the job completes."""
    from sklearn.linear_model import Lasso

    ts = TorchManager(device="cpu").train(
        GridSearchCV(Lasso(), {"alpha": [0.5, 1.0]}, cv=3), "iris"
    )
    assert ts["job_status"] == "completed"
    result = ts["job_result"]
    assert result["results"] == [] and len(result["failed"]) == 2
    assert "Unsupported model type 'Lasso'" in result["failed"][0]["error"]


def test_svc_search_completes():
    """SVC, the last family refused before, runs a search to the end."""
    from sklearn.svm import SVC

    ts = TorchManager(device="cpu").train(
        GridSearchCV(SVC(), {"C": [0.5, 1.0]}, cv=3), "iris"
    )
    result = ts["job_result"]
    assert ts["job_status"] == "completed" and not result["failed"]
    assert len(result["results"]) == 2
    assert all(0.9 < r["mean_cv_score"] <= 1.0 for r in result["results"])


def test_coordinator_journal_reads_back_finished_jobs():
    """A journaled coordinator's finished job is there, with its results,
    in a new coordinator over the same storage root."""
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    first = Coordinator(device="cpu", journal=True)
    manager = TorchManager(coordinator=first)
    ts = manager.train(GridSearchCV(LogisticRegression(), {"C": [0.1, 1.0]}, cv=3), "iris")
    again = Coordinator(device="cpu", journal=True)
    status = again.check_status(manager.session_id, manager.job_id)
    assert status["job_status"] == "completed"
    assert status["job_result"] == ts["job_result"]


def test_store_journal_round_trip(tmp_path):
    store = JobStore(journal_dir=str(tmp_path))
    sid = store.create_session()
    specs = [{"subtask_id": f"j-subtask-{i}"} for i in range(2)]
    store.create_job(sid, "j", {"dataset_id": "iris"}, specs)
    store.update_subtask(sid, "j", "j-subtask-0", "completed", {"mean_cv_score": 0.9})
    assert store.job_progress(sid, "j")["job_status"] == "50.0%"
    store.update_subtask(sid, "j", "j-subtask-1", "failed", {"error": "x"})
    store.finalize_job(sid, "j", {"results": [], "best_result": None})
    with open(tmp_path / "jobs.jsonl", "a") as f:
        f.write('{"op": "update_sub')  # torn tail of a killed writer
    again = JobStore(journal_dir=str(tmp_path))
    assert again.get_job(sid, "j") == store.get_job(sid, "j")
    assert again.job_progress(sid, "j")["job_status"] == "completed"


def test_manager_constructor_takes_the_jax_signature():
    """Both managers take ``(url, coordinator, priority)`` positionally; the
    priority reaches the session and its ``create_session`` journal line.
    The port refuses a URL (remote mode is not ported yet)."""
    from cs230_distributed_machine_learning_tpu.runtime.coordinator import (
        Coordinator as JaxCoordinator,
    )
    from cs230_distributed_machine_learning_tpu.utils.config import get_config as jax_config
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    lines = {}
    for name, coord, root in (
            ("jax", JaxCoordinator(journal=True), jax_config().storage.journal_dir),
            ("torch", Coordinator(device="cpu", journal=True),
             tcfg.get_config().storage.journal_dir)):
        manager = (JaxManager if name == "jax" else TorchManager)(None, coord, 2)
        assert manager.priority == 2
        assert coord.store.session_priority(manager.session_id) == 2
        with open(os.path.join(root, "jobs.jsonl")) as f:
            entries = [json.loads(line) for line in f]
        (line,) = [e for e in entries if e.get("sid") == manager.session_id]
        lines[name] = {k: v for k, v in line.items() if k != "sid"}
    assert lines["torch"] == lines["jax"] == {"op": "create_session", "priority": 2}
    assert TorchManager(device="cpu").priority == 0
    with pytest.raises(ValueError, match="remote mode .* not yet ported"):
        TorchManager("http://localhost:5001")
    with pytest.raises(ValueError, match="remote mode .* not yet ported"):
        TorchManager(url="http://localhost:5001", device="cpu")
