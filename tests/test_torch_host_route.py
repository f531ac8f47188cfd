"""The host route for tiny buckets (``CS230_HOST_EXEC_MACS``, the JAX
package's ``parallel/trial_map.py:631-637, 950-966``) in the port's trial
engine, on the CPU.

The route is off unless ``CS230_HOST_EXEC_MACS`` is set (the port's
default, ROADMAP C39); these tests set it to the JAX package's default,
2e8. The decision is held against a CUDA device object, which launches
nothing: iris goes to the host and covertype's shape stays on the card; a
mesh, a chunk plan or a cap of 0 keep a bucket on the card; the bucket's
MACs equal the JAX kernels' ``macs_estimate`` times splits times trials.
Searches handed a CUDA device run wholly on the host when every bucket is
under the cap (this box has no card, so any launch would raise), and
their scores equal the JAX package's within the LogReg limit 2e-3
(``tests/test_trial_engine.py:63``'s job) and to the bit for an
integer-stat tree.
"""

import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris

from cs230_distributed_machine_learning_tpu.models.base import TrialData as JData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jtm
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map as tm

torch.set_num_threads(1)
CUDA = torch.device("cuda", 0)  # a device object: nothing is launched on it
CPU = torch.device("cpu")
LOGREG_TOL = 2e-3
#: the JAX package's default cap
JAX_CAP = "2e8"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("CS230_HOST_EXEC_MACS", JAX_CAP)
    monkeypatch.delenv("CS230_FORCE_PACKED", raising=False)
    tm.reset_host_route()


def _iris():
    X, y = load_iris(return_X_y=True)
    return X.astype(np.float32), y.astype(np.int32), 3


def _bucket(kernel, params, n, d, c, X=None):
    """(resolved static, prepared forms) of one bucket, as the engine
    resolves them."""
    static = kernel.static_from_key(kernel.canonicalize(params[0])[0])
    if hasattr(kernel, "resolve_static"):
        static = kernel.resolve_static(static, n, d, c)
    static["_n_classes"] = c
    static = kernel.bucket_static(static, [kernel.canonicalize(p)[1] for p in params]) \
        if hasattr(kernel, "bucket_static") else static
    prepared = kernel.prepare_data(X, static) if hasattr(kernel, "prepare_data") else None
    return static, prepared


def test_iris_goes_to_the_host_and_covertype_stays_on_the_card():
    k = get_kernel("LogisticRegression")
    params = [{"C": c} for c in (0.1, 1.0, 10.0)]
    static, _ = _bucket(k, params, 150, 4, 3)
    assert static["_method"] == "newton"
    assert tm.host_exec(k, None, 150, 4, static, 6, 3, device=CUDA)
    assert not tm.host_exec(k, None, 150, 4, static, 6, 3, device=CPU)
    # bench.py's job: 116,202 x 54, 7 classes, 1000 trials, max_iter 200
    main = [{"C": 1.0, "tol": 1e-4, "max_iter": 200}]
    cstatic, _ = _bucket(k, main, 116_202, 54, 7)
    assert tm.bucket_macs(k, None, 116_202, 54, cstatic, 6, 1000) > 1e12
    assert not tm.host_exec(k, None, 116_202, 54, cstatic, 6, 1000, device=CUDA)


def test_the_route_is_off_unless_the_cap_is_set(monkeypatch):
    k = get_kernel("LogisticRegression")
    static, _ = _bucket(k, [{"C": 1.0}], 150, 4, 3)
    assert tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA)
    monkeypatch.delenv("CS230_HOST_EXEC_MACS")
    assert tm._host_exec_cap() == 0.0
    assert not tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA)


def test_a_mesh_a_chunk_plan_or_a_cap_of_zero_keep_the_card(monkeypatch):
    k = get_kernel("LogisticRegression")
    static, _ = _bucket(k, [{"C": 1.0}], 150, 4, 3)
    assert tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA)
    assert not tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA, mesh=object())
    assert not tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA,
                            chunk_plan={"n_chunks": 2, "trees_per_chunk": 1})
    monkeypatch.setenv("CS230_HOST_EXEC_MACS", "0")
    assert not tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA)
    # the cap is inclusive, as the reference's
    macs = tm.bucket_macs(k, None, 150, 4, static, 6, 1)
    monkeypatch.setenv("CS230_HOST_EXEC_MACS", repr(macs))
    assert tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA)
    monkeypatch.setenv("CS230_HOST_EXEC_MACS", repr(macs * (1 - 1e-9)))
    assert not tm.host_exec(k, None, 150, 4, static, 6, 1, device=CUDA)
    # a kernel with no estimate never takes the route
    nb = get_kernel("GaussianNB")
    assert tm.bucket_macs(nb, None, 150, 4, {"_n_classes": 3}, 6, 1) is None
    assert not tm.host_exec(nb, None, 150, 4, {"_n_classes": 3}, 6, 1, device=CUDA)


@pytest.mark.parametrize("model,params", [
    ("LogisticRegression", [{"C": 1.0, "max_iter": 50}, {"C": 3.0, "max_iter": 80}]),
    ("MLPClassifier", [{"hidden_layer_sizes": [32], "max_iter": 10}]),
    ("DecisionTreeClassifier", [{"max_depth": 4}]),
    ("GradientBoostingClassifier", [{"n_estimators": 10, "learning_rate": 0.1}]),
    ("KNeighborsClassifier", [{"n_neighbors": 5}]),
    ("Ridge", [{"alpha": 1.0}]),
])
def test_bucket_macs_equal_jax_estimate_times_splits_and_trials(model, params):
    X, y, c = _iris()
    n, d = X.shape
    k, jk = get_kernel(model), jax_kernel(model)
    static, prepared = _bucket(k, params, n, d, c, X)
    jstatic, jprepared = _bucket(jk, params, n, d, c, X)
    jmacs = jtm._call_with_prepared(
        jk.macs_estimate, jprepared if jprepared is not None else X, n, d, jstatic)
    assert tm.bucket_macs(k, prepared, n, d, static, 6, len(params)) == \
        pytest.approx(float(jmacs) * 6 * len(params), rel=1e-12)


def test_tiny_searches_run_on_the_host_and_match_jax():
    """A CUDA device handed to run_trials: each bucket under the cap runs
    on the host (the kernels' plain versions), counted by HOST_ROUTE."""
    X = np.random.RandomState(0).randn(120, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32)
    plan = build_split_plan(y, task="classification", n_folds=3)
    params = [{"C": c} for c in (0.1, 1.0, 10.0)]
    out = tm.run_trials(get_kernel("LogisticRegression"), TrialData(X=X, y=y, n_classes=2),
                        plan, params, device=CUDA)
    ref = jtm.run_trials(jax_kernel("LogisticRegression"), JData(X=X, y=y, n_classes=2),
                         plan, params)
    assert tm.HOST_ROUTE == {"buckets": 1, "trials": 3}
    assert out.hbm_peak_bytes is None or out.hbm_peak_bytes >= 0
    for m, r in zip(out.trial_metrics, ref.trial_metrics):
        assert abs(m["mean_cv_score"] - r["mean_cv_score"]) <= LOGREG_TOL
        assert 0.5 <= m["mean_cv_score"] <= 1.0

    Xi, yi, c = _iris()
    plan = build_split_plan(yi, task="classification", n_folds=5)
    tree = [{"max_depth": 3}, {"max_depth": 4}]
    out = tm.run_trials(get_kernel("DecisionTreeClassifier"), TrialData(X=Xi, y=yi, n_classes=c),
                        plan, tree, device=CUDA)
    ref = jtm.run_trials(jax_kernel("DecisionTreeClassifier"), JData(X=Xi, y=yi, n_classes=c),
                         plan, tree)
    assert tm.HOST_ROUTE == {"buckets": 3, "trials": 5}
    assert [m["cv_scores"] for m in out.trial_metrics] == [r["cv_scores"] for r in
                                                           ref.trial_metrics]
