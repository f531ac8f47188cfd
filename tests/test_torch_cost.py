"""The port's device cost accounting against the JAX package's, on the CPU.

``macs_estimate`` (LogReg newton / nesterov, the linear models) equal term
for term at several shapes; a search's ``model_flops`` and coverage equal
in both trial engines; the JAX ``TrialRunResult`` fields, the batch phases
tiling the run; the executor's ``batch_cost`` on a batch's first result
only and the ``batch_*`` fields of its metrics messages; the valve; the
job cost report's keys and totals against the JAX coordinator's; MFU None
on the CPU and against a known peak; the remote metrics ingest's
same-process dedup.
"""

import dataclasses

import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris, make_regression

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models.base import TrialData as JaxTrialData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops.folds import build_split_plan as jax_plan
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jtm
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch import obs as tobs
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.obs import devprof
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map as ttm
from cs230_distributed_machine_learning_tpu_torch.runtime import cluster as tcluster
from cs230_distributed_machine_learning_tpu_torch.runtime import executor as texec
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils import flops as tflops

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


MACS_CASES = [
    ("LogisticRegression", 150, 4, {"_n_classes": 3, "_method": "newton"}),
    ("LogisticRegression", 116_202, 54, {"_n_classes": 7, "_method": "nesterov", "_iters": 200}),
    ("LogisticRegression", 60_000, 784, {"_n_classes": 10, "_method": "nesterov"}),
    ("LogisticRegression", 500, 20, {"_n_classes": 2, "_method": "newton", "_iters": 7}),
    ("LogisticRegression", 1000, 8, {}),
    ("LinearRegression", 442, 10, {}),
    ("Ridge", 20_640, 8, {"fit_intercept": False}),
]


@pytest.mark.parametrize("model,n,d,static", MACS_CASES)
def test_macs_estimate_matches_jax(model, n, d, static):
    got = get_kernel(model).macs_estimate(n, d, dict(static))
    assert got == jax_kernel(model).macs_estimate(n, d, dict(static)) and got > 0


def _iris():
    X, y = load_iris(return_X_y=True)
    return X.astype(np.float32), y.astype(np.int32), 3


def _regression():
    X, y = make_regression(n_samples=300, n_features=6, noise=0.5, random_state=0)
    return X.astype(np.float32), y.astype(np.float32), 0


SEARCHES = {
    "logreg_iris": ("LogisticRegression", _iris, "classification",
                    [{"C": c, "max_iter": 50} for c in (0.1, 1.0, 10.0)]),
    "ridge_regression": ("Ridge", _regression, "regression",
                         [{"alpha": a} for a in (0.1, 1.0)]),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_model_flops_match_jax(case):
    model, make, task, params = SEARCHES[case]
    X, y, c = make()
    plan = build_split_plan(y, task=task, n_folds=3, random_state=0)
    run = ttm.run_trials(get_kernel(model), TrialData(X=X, y=y, n_classes=c), plan, params,
                         device=CPU)
    ref = jtm.run_trials(jax_kernel(model), JaxTrialData(X, y, c),
                         jax_plan(y, task=task, n_folds=3, random_state=0), params)
    assert run.model_flops == pytest.approx(ref.model_flops, rel=1e-12)
    assert run.flops_coverage == ref.flops_coverage == 1.0
    assert run.hbm_peak_bytes is None and run.xla_flops is None and run.bytes_accessed is None
    assert run.n_dispatches >= 1 and run.n_host_fetches >= 1 and run.result_bytes > 0
    assert run.compile_time_s == 0.0  # no kernel library on the CPU
    assert run.run_time_s >= run.fetch_time_s >= 0.0 and run.stage_time_s >= 0.0


def test_trial_run_result_has_the_jax_fields():
    """Every field, ``device_best`` (the trial mesh's collective argmax)
    included since the multi-device slice."""
    port = {f.name for f in dataclasses.fields(ttm.TrialRunResult)}
    assert {f.name for f in dataclasses.fields(jtm.TrialRunResult)} - port == set()


def test_phases_tile_the_run():
    """compile + stage + run never exceed the engine call's wall, and the
    staging of a fresh dataset counts (a second run over it hits)."""
    import time

    X, y, c = _iris()
    plan = build_split_plan(y, task="classification", n_folds=3, random_state=1)
    data = TrialData(X=X, y=y, n_classes=c)
    t0 = time.perf_counter()
    run = ttm.run_trials(get_kernel("LogisticRegression"), data, plan, [{"C": 1.0}],
                         device=CPU)
    wall = time.perf_counter() - t0
    assert run.compile_time_s + run.stage_time_s + run.run_time_s <= wall
    assert run.stage_time_s > 0.0
    again = ttm.run_trials(get_kernel("LogisticRegression"), data, plan, [{"C": 1.0}],
                           device=CPU)
    assert again.stage_time_s < run.stage_time_s


def _subtasks(n, trace_id=None):
    return [{"subtask_id": f"job-{i}", "job_id": "job", "dataset_id": "iris",
             "model_type": "LogisticRegression", "parameters": {"C": 0.5 + i},
             "train_params": {"cv": 3, "random_state": 0}, **(
                 {"trace_id": trace_id} if trace_id else {})} for i in range(n)]


def test_executor_stamps_batch_cost_on_the_first_result_only():
    ex = texec.LocalExecutor(CPU)
    msgs = []
    before = devprof.phase_totals()
    flops0 = tobs.REGISTRY.counter("tpuml_executor_flops_total").value(
        model="LogisticRegression")
    results = ex.run_subtasks(_subtasks(3), on_metrics=msgs.append)
    costs = [r.get("batch_cost") for r in results]
    assert costs[0] is not None and costs[1:] == [None, None]
    cost = costs[0]
    assert cost["n_subtasks"] == 3 and cost["flops_coverage"] == 1.0
    assert cost["model_flops"] > 0 and cost["mfu"] is None and cost["hbm_peak_bytes"] is None
    assert [m["batch_primary"] for m in msgs] == [True, False, False]
    assert all(m["batch_model_flops"] == cost["model_flops"] and m["obs_pid"] for m in msgs)
    assert tobs.REGISTRY.counter("tpuml_executor_flops_total").value(
        model="LogisticRegression") == pytest.approx(flops0 + cost["model_flops"])
    after = devprof.phase_totals()
    assert after["dispatch"] > before["dispatch"]


def test_cost_accounting_obeys_the_valve(monkeypatch):
    monkeypatch.setenv("CS230_OBS", "0")
    X, y, c = _iris()
    plan = build_split_plan(y, task="classification", n_folds=3, random_state=0)
    run = ttm.run_trials(get_kernel("LogisticRegression"), TrialData(X=X, y=y, n_classes=c),
                         plan, [{"C": 1.0}], device=CPU)
    assert run.model_flops is None and run.flops_coverage is None
    results = texec.LocalExecutor(CPU).run_subtasks(_subtasks(2))
    assert all("batch_cost" not in r for r in results)


def test_mfu_from_a_known_peak(monkeypatch):
    monkeypatch.setattr(tflops, "device_peak_flops", lambda: 1e9)
    results = texec.LocalExecutor(CPU).run_subtasks(_subtasks(2))
    cost = results[0]["batch_cost"]
    assert cost["mfu"] == pytest.approx(cost["model_flops"] / cost["device_seconds"] / 1e9)


def test_hbm_gauges_silent_on_the_cpu():
    g = tobs.REGISTRY.gauge("tpuml_device_hbm_bytes")
    before = list(g.cells())
    texec.record_hbm_gauges()
    assert list(g.cells()) == before


SEARCH = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
          "base_estimator_params": {"max_iter": 100},
          "param_grid": {"C": [0.1, 1.0, 10.0]}, "cv_params": {"cv": 3}}


def test_job_cost_matches_jax():
    reports = {}
    for name, manager in (("torch", TorchManager(device="cpu")), ("jax", JaxManager())):
        assert manager.train(dict(SEARCH), "iris", show_progress=False)["job_status"] == \
            "completed"
        reports[name] = manager._coordinator.job_cost(manager.job_id)
        assert manager._coordinator.job_cost("nope") is None
    got, ref = reports["torch"], reports["jax"]
    assert sorted(got) == sorted(ref)
    assert sorted(got["groups"][0]) == sorted(ref["groups"][0])
    assert got["n_groups"] == ref["n_groups"] == 1
    assert got["model_flops"] == pytest.approx(ref["model_flops"], rel=1e-12)
    assert got["mfu"] is None and got["device_peak_flops"] is None
    assert got["job_status"] == "completed" and got["device_seconds"] > 0


def test_job_cost_mfu_against_a_known_peak(monkeypatch):
    monkeypatch.setattr(tflops, "device_peak_flops", lambda: 1e9)
    m = TorchManager(device="cpu")
    m.train(dict(SEARCH), "iris", show_progress=False)
    rep = m._coordinator.job_cost(m.job_id)
    assert rep["mfu"] == pytest.approx(rep["model_flops"] / rep["device_seconds"] / 1e9)
    assert rep["device_peak_flops"] == 1e9


def test_push_metrics_counts_remote_batches_once():
    cluster = tcluster.ClusterRuntime()
    try:
        flops = tobs.REGISTRY.counter("tpuml_executor_flops_total")
        before, phases0 = flops.value(model="Remote"), devprof.phase_totals()
        msg = {"subtask_id": "s", "algo": "Remote", "batch_primary": True,
               "batch_compile_s": 0.5, "batch_stage_s": 0.25, "batch_dispatch_s": 2.0,
               "batch_fetch_s": 0.5, "batch_model_flops": 1e6, "obs_pid": "elsewhere:1"}
        cluster.push_metrics("w-remote", msg)
        cluster.push_metrics("w-remote", {**msg, "batch_primary": False})
        cluster.push_metrics("w-remote", {**msg, "obs_pid": tobs.process_token()})
        assert flops.value(model="Remote") == before + 1e6
        phases = devprof.phase_totals()
        assert phases["dispatch"] - phases0["dispatch"] == pytest.approx(1.5)
        assert phases["compile"] - phases0["compile"] == pytest.approx(0.5)
    finally:
        cluster.shutdown()
