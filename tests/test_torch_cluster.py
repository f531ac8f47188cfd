"""The port's scheduled runtime (runtime/cluster.py and the coordinator's
scheduled mode) against the JAX package's, both on the CPU.

- A scheduled iris ``GridSearchCV`` of LogisticRegression and of a small
  RandomForest under ``cluster=ClusterRuntime()`` with two in-process
  executors: the same ``best_params_`` as the JAX package's scheduled run,
  every score within the family's limit (LogReg 2e-3, RF 1e-6).
- The fault-tolerance layer, the same scenario in both packages: a worker
  that fails every batch (its subtasks are retried on the other), a
  subtask that fails everywhere (quarantined after its budget:
  ``completed_with_failures``), a subtask that kills two workers
  (quarantined as poisoned), and ``FaultInjector(device_lost_after=1)``
  (the worker leaves the pool and its tasks are requeued onto the
  survivor).
- ``_recover`` after a simulated restart mid-job: the journal's placed
  subtasks resume under a fresh attempt and the job completes.
- ``_is_device_fatal`` on both CUDA error spellings, with out-of-memory
  kept task-level, and the executor escalating a sticky error to
  ``DeviceLostError`` instead of failing its subtasks.
"""

import json
import time
import types

import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.obs import REGISTRY as JAX_REGISTRY
from cs230_distributed_machine_learning_tpu.runtime import cluster as jcluster
from cs230_distributed_machine_learning_tpu.runtime import coordinator as jcoord
from cs230_distributed_machine_learning_tpu.runtime import executor as jexec
from cs230_distributed_machine_learning_tpu.runtime import store as jstore
from cs230_distributed_machine_learning_tpu.runtime import subtasks as jsub
from cs230_distributed_machine_learning_tpu.utils import config as jcfg
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.obs import REGISTRY as TORCH_REGISTRY
from cs230_distributed_machine_learning_tpu_torch.runtime import cluster as tcluster
from cs230_distributed_machine_learning_tpu_torch.runtime import coordinator as tcoord
from cs230_distributed_machine_learning_tpu_torch.runtime import executor as texec
from cs230_distributed_machine_learning_tpu_torch.runtime import store as tstore
from cs230_distributed_machine_learning_tpu_torch.runtime import subtasks as tsub
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

CPU = torch.device("cpu")
PACKAGES = {
    "jax": types.SimpleNamespace(
        cluster=jcluster, coord=lambda **kw: jcoord.Coordinator(**kw), manager=JaxManager,
        executor=lambda fi=None: jexec.LocalExecutor(executor_id="tmp", fault_injector=fi),
        add=lambda cl: cl.add_executor(), registry=JAX_REGISTRY, store=jstore, sub=jsub,
        cfg=lambda: jcfg.get_config()),
    "torch": types.SimpleNamespace(
        cluster=tcluster, coord=lambda **kw: tcoord.Coordinator(device="cpu", **kw),
        manager=TorchManager,
        executor=lambda fi=None: texec.LocalExecutor(CPU, fault_injector=fi),
        add=lambda cl: cl.add_executor(device="cpu"), registry=TORCH_REGISTRY, store=tstore,
        sub=tsub, cfg=lambda: tcfg.get_config()),
}


@pytest.fixture(autouse=True)
def _fast_scheduler(tmp_path):
    """The port's storage root in a per-test tmpdir (conftest does the JAX
    package's), and both packages' scheduler on fast cadences."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    for c in (tcfg.get_config(), jcfg.get_config()):
        c.scheduler.heartbeat_interval_s = 0.05
        c.scheduler.dead_after_s = 2.0
        c.scheduler.sweep_interval_s = 0.1
        c.scheduler.lease_floor_s = 60.0
        c.scheduler.retry_backoff_s = 0.05
        c.scheduler.speculative_enabled = False
        c.service.client_timeout_s = 120.0
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _by_params(status):
    return {json.dumps(r["search_params"], sort_keys=True): r
            for r in status["job_result"]["results"]}


def _run_both(fn):
    out = {}
    for name, pkg in PACKAGES.items():
        cluster = pkg.cluster.ClusterRuntime()
        try:
            out[name] = fn(pkg, cluster)
        finally:
            cluster.shutdown()
    return out


# ---------------- scheduled searches ----------------


@pytest.mark.parametrize("family,search,limit", [
    ("LogisticRegression",
     GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.01, 0.1, 1.0, 10.0]}, cv=3), 2e-3),
    ("RandomForestClassifier",
     GridSearchCV(RandomForestClassifier(random_state=0), {"n_estimators": [2, 4]}, cv=3), 1e-6),
])
def test_scheduled_search_matches_jax(family, search, limit):
    def run(pkg, cluster):
        pkg.add(cluster)
        pkg.add(cluster)
        coord = pkg.coord(cluster=cluster)
        status = pkg.manager(coordinator=coord).train(search, "iris", show_progress=False)
        workers = {r["worker_id"] for r in status["job_result"]["results"]}
        return status, workers, coord.predictor_calibration()

    got = _run_both(run)
    (js, _, jcal), (ts, tworkers, tcal) = got["jax"], got["torch"]
    assert js["job_status"] == ts["job_status"] == "completed"
    jr, tr = _by_params(js), _by_params(ts)
    assert jr.keys() == tr.keys()
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=limit), k
    assert (ts["job_result"]["best_result"]["search_params"]
            == js["job_result"]["best_result"]["search_params"])
    assert tworkers <= {"worker-0", "worker-1"}
    assert set(tcal["families"]) == set(jcal["families"]) == {family}


def test_scheduled_asha_search_matches_jax():
    """An ASHA search under ``cluster=``: the rung controller fed by the
    scheduled ingest (``_run_job_search_scheduled``). Its promotions follow
    the order the reports arrive in, which the batching decides, so the
    two packages are held where that order does not matter: the same
    ladder, every trial accounted for (completed or pruned, none failed),
    and every trial that stopped at the same rung in both with the same
    score there."""
    grid = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
            "base_estimator_params": {}, "cv_params": {"cv": 3},
            "param_grid": {"C": [round(1e-3 * 3.0 ** i, 6) for i in range(9)]}}
    asha = {"type": "asha", "eta": 3, "min_resource": 5, "max_resource": 45}

    def run(pkg, cluster):
        pkg.add(cluster)
        coord = pkg.coord(cluster=cluster)
        return pkg.manager(coordinator=coord).train(grid, "iris", {"random_state": 42},
                                                    show_progress=False, search_params=asha)

    got = _run_both(run)
    ends = {}
    for name, status in got.items():
        res = status["job_result"]
        assert status["job_status"] == "completed" and res["failed"] == [], name
        assert len(res["results"]) + res["n_pruned"] == 9 and res["results"], name
        (bracket,) = res["search"]["brackets"]
        assert [r["resource"] for r in bracket["rungs"]] == [5, 15, 45], name
        ends[name] = {json.dumps(r["search_params"], sort_keys=True):
                      (r["parameters"]["max_iter"], r["mean_cv_score"])
                      for r in res["results"] + res["pruned_results"]}
    assert ends["torch"].keys() == ends["jax"].keys()
    same = [k for k in ends["jax"] if ends["torch"][k][0] == ends["jax"][k][0]]
    assert same
    for k in same:
        assert ends["torch"][k][1] == pytest.approx(ends["jax"][k][1], abs=2e-3), k


# ---------------- the fault-tolerance layer ----------------


def _counter(pkg, name, **labels):
    return pkg.registry.counter(name).value(**labels)


def test_failing_worker_is_retried_on_the_survivor_like_jax():
    def run(pkg, cluster):
        pkg.cfg().scheduler.breaker_failure_ratio = 0.0  # isolate the retry path
        before = _counter(pkg, "tpuml_subtasks_retried_total", reason="failure")
        cluster.add_executor(executor=pkg.executor(_injector(pkg, fail_batches=10 ** 6)))
        pkg.add(cluster)
        coord = pkg.coord(cluster=cluster)
        status = pkg.manager(coordinator=coord).train(
            GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.01, 0.1, 1.0, 10.0]}, cv=3),
            "iris", show_progress=False)
        return (status, _counter(pkg, "tpuml_subtasks_retried_total", reason="failure") - before)

    got = _run_both(run)
    for name, (status, retried) in got.items():
        assert status["job_status"] == "completed", name
        results = status["job_result"]["results"]
        assert len({r["subtask_id"] for r in results}) == 4 and not status["job_result"]["failed"]
        assert all(r["worker_id"] == "worker-1" for r in results), name
        assert retried > 0, name
    jr, tr = _by_params(got["jax"][0]), _by_params(got["torch"][0])
    for k in jr:
        assert tr[k]["mean_cv_score"] == pytest.approx(jr[k]["mean_cv_score"], abs=2e-3)


def _injector(pkg, **kw):
    mod = jexec if pkg is PACKAGES["jax"] else texec
    return mod.FaultInjector(**kw)


def _quarantine_report(coord, payload):
    sid = coord.create_session()
    submit = coord.submit_train(sid, payload)
    coord.wait_for_completion(sid, submit["job_id"], timeout_s=60)
    status = coord.check_status(sid, submit["job_id"])
    progress = coord.store.job_progress(sid, submit["job_id"])
    return status, progress


def test_quarantine_after_the_retry_budget_matches_jax():
    payload = {"dataset_id": "no_such_dataset",
               "model_details": {"model_type": "LogisticRegression",
                                 "base_estimator_params": {"max_iter": 100}},
               "train_params": {}}

    def run(pkg, cluster):
        pkg.cfg().scheduler.retry_max_attempts = 2
        pkg.add(cluster)
        pkg.add(cluster)
        before = _counter(pkg, "tpuml_subtasks_quarantined_total")
        status, progress = _quarantine_report(pkg.coord(cluster=cluster), payload)
        return status, progress, _counter(pkg, "tpuml_subtasks_quarantined_total") - before

    got = _run_both(run)
    shapes = {}
    for name, (status, progress, quarantined) in got.items():
        assert status["job_status"] == "completed_with_failures", name
        (report,) = status["job_result"]["failed_subtasks"]
        assert (report["attempts"], report["reason"]) == (2, "retries_exhausted")
        assert "no_such_dataset" in report["error"]
        assert status["failed_subtasks"] == status["job_result"]["failed_subtasks"]
        assert progress["tasks_failed"] == 1 and quarantined == 1
        shapes[name] = (sorted(status), sorted(report), sorted(status["job_result"]))
    assert shapes["torch"] == shapes["jax"]


def test_subtask_that_kills_two_workers_is_poisoned_like_jax():
    payload = {"dataset_id": "iris",
               "model_details": {"model_type": "LogisticRegression",
                                 "base_estimator_params": {"max_iter": 100}},
               "train_params": {}}

    def run(pkg, cluster):
        pkg.cfg().scheduler.dead_after_s = 0.5
        pkg.cfg().scheduler.poison_kill_threshold = 2
        for _ in range(2):
            cluster.add_executor(executor=pkg.executor(_injector(pkg, device_lost=True)))
        status, _ = _quarantine_report(pkg.coord(cluster=cluster), payload)
        deadline = time.time() + 10
        while cluster.engine.worker_snapshot() and time.time() < deadline:
            time.sleep(0.1)
        return status, cluster.engine.worker_snapshot()

    got = _run_both(run)
    for name, (status, workers) in got.items():
        assert status["job_status"] == "completed_with_failures", name
        (report,) = status["job_result"]["failed_subtasks"]
        assert report["reason"] == "poisoned" and workers == {}, name


def test_device_lost_after_one_batch_requeues_onto_the_survivor_like_jax():
    """The doomed executor runs one healthy batch on its own, then joins
    the pool beside a survivor: its next batch loses the device, it leaves
    the pool, and the dead-worker sweep requeues its tasks onto the
    survivor."""
    search = GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.01, 0.1, 1.0, 10.0]}, cv=3)
    warm = {"model_type": "LogisticRegression", "base_estimator_params": {"max_iter": 100}}

    def run(pkg, cluster):
        pkg.cfg().scheduler.dead_after_s = 0.5
        doomed_ex = pkg.executor(_injector(pkg, device_lost_after=1))
        (healthy,) = doomed_ex.run_subtasks(pkg.sub.create_subtasks("w", "s", "iris", warm, {}))
        doomed = cluster.add_executor(executor=doomed_ex)
        survivor = pkg.add(cluster)
        coord = pkg.coord(cluster=cluster)
        status = pkg.manager(coordinator=coord).train(search, "iris", show_progress=False)
        deadline = time.time() + 10
        while doomed in cluster.engine.worker_snapshot() and time.time() < deadline:
            time.sleep(0.1)
        return healthy, status, doomed, survivor, set(cluster.engine.worker_snapshot())

    got = _run_both(run)
    for name, (healthy, status, doomed, survivor, live) in got.items():
        assert healthy["status"] == "completed", name
        assert status["job_status"] == "completed", name
        results = status["job_result"]["results"]
        assert len({r["subtask_id"] for r in results}) == 4 and not status["job_result"]["failed"]
        assert {r["worker_id"] for r in results} == {survivor}, name
        assert live == {survivor}, name
    for k, r in _by_params(got["jax"][1]).items():
        assert _by_params(got["torch"][1])[k]["mean_cv_score"] == pytest.approx(
            r["mean_cv_score"], abs=2e-3)


# ---------------- recovery ----------------


def test_recover_after_a_restart_mid_job_matches_jax():
    """A journal with one completed and two placed-but-unreported subtasks
    (the coordinator died mid-job) boots on a fresh cluster: the job
    resumes, the placed subtasks run under a fresh attempt, a late zombie
    duplicate is dropped."""
    model_details = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
                     "base_estimator_params": {"max_iter": 100},
                     "param_grid": {"C": [0.1, 1.0, 10.0]}}

    def run(pkg, cluster):
        store = pkg.store.JobStore(journal_dir=pkg.cfg().storage.journal_dir)
        sid = store.create_session()
        subtasks = pkg.sub.create_subtasks("jobc", sid, "iris", model_details, {"cv": 3})
        store.create_job(sid, "jobc", {"dataset_id": "iris"}, subtasks)
        done = subtasks[0]["subtask_id"]
        store.update_subtask(sid, "jobc", done, "completed",
                             {"subtask_id": done, "status": "completed",
                              "mean_cv_score": 0.91, "accuracy": 0.9, "attempt": 0})
        for st in subtasks[1:]:
            store.record_placement(sid, "jobc", st["subtask_id"], "worker-dead", attempt=0,
                                   lease_deadline=time.time() + 60)
        del store
        pkg.add(cluster)
        coord = pkg.coord(cluster=cluster, journal=True)
        recovery = dict(coord.recovery)
        assert coord.ready and coord.store.wait_job(sid, "jobc", timeout=120)
        cluster.bus.publish("result", {"subtask_id": done, "job_id": "jobc",
                                       "status": "completed", "mean_cv_score": 0.5,
                                       "attempt": 0}, key=done)
        time.sleep(0.3)
        job = coord.store.get_job(sid, "jobc")
        attempts = [job["subtasks"][st["subtask_id"]]["spec"]["attempt"]
                    for st in subtasks[1:]]
        return (coord.check_status(sid, "jobc"), recovery, attempts,
                coord.store.job_progress(sid, "jobc")["tasks_completed"],
                job["subtasks"][done]["result"]["mean_cv_score"])

    got = _run_both(run)
    (js, jrec, jatt, jdone, jkept), (ts, trec, tatt, tdone, tkept) = got["jax"], got["torch"]
    for key in ("replayed_ops", "replay_skipped", "jobs_resumed", "subtasks_requeued"):
        assert trec[key] == jrec[key], key
    assert trec["jobs_resumed"] == 1 and trec["subtasks_requeued"] == 2
    assert ts["job_status"] == js["job_status"] == "completed"
    assert tatt == jatt and min(tatt) >= 1
    assert tdone == jdone == 3 and tkept == jkept == 0.91
    jr = {r["subtask_id"]: r["mean_cv_score"] for r in js["job_result"]["results"]}
    tr = {r["subtask_id"]: r["mean_cv_score"] for r in ts["job_result"]["results"]}
    assert tr.keys() == jr.keys()
    for k in jr:
        assert tr[k] == pytest.approx(jr[k], abs=2e-3), k


# ---------------- fault containment on the card ----------------


@pytest.mark.parametrize("error,fatal", [
    (RuntimeError("packed_nesterov_step failed: CUDA error 700"), True),
    (RuntimeError("level_histogram failed: CUDA error 719"), True),
    (RuntimeError("mlp_epoch failed: CUDA error 214"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered\nCUDA kernel "
                  "errors might be asynchronously reported"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("knn_topk failed: CUDA error 2"), False),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("CUDA error: out of memory"), False),
    (RuntimeError("shape mismatch"), False),
])
def test_is_device_fatal_on_both_cuda_spellings(error, fatal):
    assert texec._is_device_fatal(error) is fatal
    assert texec._is_device_fatal(texec.DeviceLostError("lost")) is True


@pytest.mark.parametrize("error,fatal", [
    (RuntimeError("masked_softmax_grad failed: CUDA error 716"), True),
    (torch.OutOfMemoryError("CUDA out of memory."), False),
])
def test_executor_escalates_only_sticky_errors(monkeypatch, error, fatal):
    def boom(*a, **k):
        raise error

    monkeypatch.setattr(texec, "run_trials", boom)
    ex = texec.LocalExecutor(CPU)
    specs = tsub.create_subtasks("j", "s", "iris", {"model_type": "LogisticRegression",
                                                    "base_estimator_params": {}}, {"cv": 3})
    posted = []
    if fatal:
        with pytest.raises(texec.DeviceLostError):
            ex.run_subtasks(specs, on_result=lambda *a: posted.append(a))
        assert posted == []  # no per-task failures: the tasks stay queued
    else:
        results = ex.run_subtasks(specs, on_result=lambda *a: posted.append(a))
        assert [r["status"] for r in results] == ["failed"] and len(posted) == 1
