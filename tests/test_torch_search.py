"""The port's adaptive search (runtime/search.py, its expansion, its store
plumbing and its rung loop) against the JAX package's, on the CPU.

- ``plan_trials`` / ``create_subtasks``: identical specs for ASHA and
  Hyperband over a grid, over distributions with a ``random_state``, with
  and without ``n_iter``, and with a sampled resource parameter that is
  dropped.
- ``SearchJobDriver``: one scripted report sequence (out of order,
  duplicated, a failed, a diverged and a worker-pruned trial, promotions,
  a ``stop_score`` hit on the metrics feed, then ``resume`` from the
  journaled rung history) gives equal Steps and summaries in both
  packages.
- The controller's unit cases of ``tests/test_search_asha.py`` (ladder and
  bracket math, async promotion, prunes, expansion, the driver, the
  cooperative cancel, the store's ``pruned`` / ``promoted`` plumbing), run
  against both packages.
- End to end in direct mode, both packages on the CPU: a LogReg ASHA job
  and a RandomForest Hyperband job give the same pruned set, the same
  trials at each rung, every (trial, rung) score within the family's
  limit (LogReg 2e-3, RF 1e-6, the RF score-vs-chunk curves included), the
  same ``best_params_``, ``n_pruned`` and ``search`` summary; the LogReg
  job also journals the same flight-recorder events in the same order and
  moves the search counters by the same amounts.
"""

import copy
import dataclasses
import json

import pytest
import torch
from scipy.stats import loguniform

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.obs import metrics as jax_metrics
from cs230_distributed_machine_learning_tpu.runtime import executor as jexec
from cs230_distributed_machine_learning_tpu.runtime import search as jsearch
from cs230_distributed_machine_learning_tpu.runtime import store as jstore
from cs230_distributed_machine_learning_tpu.runtime import subtasks as jsub
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.obs import metrics as torch_metrics
from cs230_distributed_machine_learning_tpu_torch.runtime import executor as texec
from cs230_distributed_machine_learning_tpu_torch.runtime import search as tsearch
from cs230_distributed_machine_learning_tpu_torch.runtime import store as tstore
from cs230_distributed_machine_learning_tpu_torch.runtime import subtasks as tsub
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

#: (search module, store module, subtasks module, an executor factory)
PACKAGES = {
    "jax": (jsearch, jstore, jsub, lambda: jexec.LocalExecutor(executor_id="t")),
    "torch": (tsearch, tstore, tsub, lambda: texec.LocalExecutor(torch.device("cpu"))),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    """The port's storage root in a per-test tmpdir (conftest does the
    same for the JAX package)."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


# ---------------- expansion: identical specs ----------------


def _details(search_type="asha", model="LogisticRegression", **kw):
    d = {"model_type": model, "search_type": search_type, "base_estimator_params": {},
         "cv_params": {"cv": 3}}
    d.update(kw)
    return d


PLANS = {
    "asha_grid_n_iter": _details(param_grid={"C": [0.01, 0.1, 1.0, 10.0]}, n_iter=3,
                                 asha={"eta": 3, "min_resource": 20, "max_resource": 180}),
    "asha_grid_full": _details(param_grid={"C": [0.1 * (i + 1) for i in range(12)],
                                           "tol": [1e-4, 1e-3]},
                               asha={"eta": 3, "max_resource": 90}),
    "asha_distributions": _details(
        param_distributions={"C": loguniform(1e-3, 1e2), "tol": [1e-4, 1e-3]},
        n_iter=20, random_state=0, asha={"eta": 3}),
    "asha_distributions_default_n": _details(
        param_distributions={"C": loguniform(1e-3, 1e2)}, random_state=7,
        base_estimator_params={"max_iter": 200}, asha={"eta": 4, "stop_score": 0.9}),
    "asha_drops_sampled_resource": _details(
        param_grid={"C": [1.0, 2.0], "max_iter": [500, 50]}, n_iter=4,
        asha={"eta": 3, "min_resource": 10, "max_resource": 90}),
    "hyperband_distributions": _details(
        "hyperband", param_distributions={"C": loguniform(1e-2, 1e2), "max_iter": [5, 500]},
        n_iter=12, random_state=3, asha={"eta": 3, "max_resource": 27}),
    "hyperband_grid_brackets": _details(
        "hyperband", param_grid={"C": [0.1, 1.0, 10.0]}, asha={"eta": 3, "max_resource": 81,
                                                              "max_brackets": 3}),
    "hyperband_forest": _details(
        "hyperband", model="RandomForestClassifier",
        param_grid={"max_depth": [4, 8], "max_features": ["sqrt", 0.5]}, n_iter=9,
        asha={"eta": 3, "max_resource": 9}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_trials_and_subtasks_are_identical(case):
    details = PLANS[case]
    assert tsearch.plan_trials(copy.deepcopy(details)) == \
        jsearch.plan_trials(copy.deepcopy(details))
    train_params = {"test_size": 0.2, "random_state": 42}
    want = jsub.create_subtasks("j", "s", "iris", copy.deepcopy(details), dict(train_params))
    got = tsub.create_subtasks("j", "s", "iris", copy.deepcopy(details), dict(train_params))
    assert got == want and got
    rp = got[0]["asha"]["resource_param"]
    assert all(st["parameters"][rp] == st["asha"]["resource"] for st in got)
    assert all(rp not in st["search_params"] for st in got)


# ---------------- the driver: one scripted report sequence ----------------


def _script_specs():
    details = _details(param_grid={"C": [0.1 * (i + 1) for i in range(9)]}, n_iter=9,
                       asha={"eta": 3, "min_resource": 10, "max_resource": 90,
                             "stop_score": 0.95})
    return jsub.create_subtasks("j", "s", "iris", details, {})


def _result(task, score, tt=1.0, status="completed"):
    return {"subtask_id": task["subtask_id"], "job_id": "j", "status": status,
            "mean_cv_score": score, "training_time": tt,
            "parameters": dict(task["parameters"]), "asha": dict(task["asha"]),
            "attempt": int(task.get("attempt") or 0)}


def _run_script(srch):
    """Feed one report sequence; returns (every Step as a dict, summary,
    the journal record the sequence leaves, the Steps of a driver resumed
    from that record)."""
    specs = _script_specs()
    d = srch.SearchJobDriver(copy.deepcopy(specs))
    steps, record = [], {}

    def log(stid, status, result):
        sub = record.setdefault(stid, {"status": "pending", "rung_history": []})
        sub["status"] = status
        if result is not None and result.get("asha"):
            sub["rung_history"].append(dict(result["asha"]))

    def take(step):
        for tid, res in step.promoted:
            log(tid, "promoted", res)
        for tid, status, res in step.finished:
            log(tid, status, res)
        steps.append(dataclasses.asdict(step))
        return step

    tasks = d.pending_tasks()
    steps.append({"pending": copy.deepcopy(tasks)})
    by_id = {t["subtask_id"]: t for t in tasks}
    ids = [t["subtask_id"] for t in tasks]
    scores = [0.61, 0.72, 0.55, 0.80, 0.67, 0.0, 0.0, 0.74, 0.0]
    # the early feed below stop_score, a foreign trial, a report with no score
    take(d.handle_metrics({"subtask_id": ids[0], "intermediate_score": 0.5, "rung": 0}))
    take(d.handle_metrics({"subtask_id": "ghost", "intermediate_score": 0.99, "rung": 0}))
    take(d.handle_metrics({"subtask_id": ids[1], "rung": 0}))
    # out-of-order reports, a duplicate, a failed, a diverged and a
    # worker-pruned trial
    new = []
    for i in (4, 0, 7):
        new += take(d.handle_result(ids[i], _result(by_id[ids[i]], scores[i]))).new_tasks
    new += take(d.handle_result(ids[0], _result(by_id[ids[0]], scores[0]))).new_tasks
    new += take(d.handle_quarantine(ids[5], {"subtask_id": ids[5], "status": "failed",
                                             "error": "boom"})).new_tasks
    new += take(d.handle_diverged(ids[6], {"nonfinite": True}, result=None)).new_tasks
    new += take(d.handle_pruned_result(ids[8], {"subtask_id": ids[8],
                                                "status": "pruned"})).new_tasks
    for i in (2, 3, 1):
        new += take(d.handle_result(ids[i], _result(by_id[ids[i]], scores[i]))).new_tasks
    assert new, "no promotion out of rung 0"
    # rung 1: one report, then a stop_score hit on the early feed, then the
    # stopped trial's own result and a late report (both absorbed by nothing)
    t1 = new[-1]
    take(d.handle_result(t1["subtask_id"], _result(t1, 0.81, tt=3.0)))
    stop = new[0]
    take(d.handle_metrics({"subtask_id": stop["subtask_id"], "intermediate_score": 0.97,
                           "rung": stop["asha"]["rung"]}))
    take(d.handle_result(stop["subtask_id"], _result(stop, 0.97, tt=3.0)))
    if len(new) > 2:
        take(d.handle_result(new[1]["subtask_id"], _result(new[1], 0.5, tt=3.0)))
    summary = d.summary()
    assert d.done()

    # resume a fresh driver from the rung history the sequence journaled
    d2 = srch.SearchJobDriver(copy.deepcopy(specs))
    d2.resume({"subtasks": copy.deepcopy(record)})
    resumed = [dataclasses.asdict(d2.resume_step()), {"pending": d2.pending_tasks()},
               d2.summary()]
    return steps, summary, record, resumed


def test_driver_steps_equal_on_a_scripted_sequence():
    jsteps, jsummary, jrecord, jresumed = _run_script(jsearch)
    tsteps, tsummary, trecord, tresumed = _run_script(tsearch)
    assert len(tsteps) == len(jsteps) > 10
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, f"step {i} differs"
    assert tsummary == jsummary
    assert trecord == jrecord
    assert tresumed == jresumed
    # the sequence reached every kind of decision
    statuses = {s for step in jsteps for _, s, _ in step.get("finished", [])}
    assert statuses == {"completed", "pruned", "failed", "diverged"}
    assert any(step.get("cancels") for step in jsteps)
    assert jsummary["brackets"][0]["stopped"]


# ---------------- the controller's unit cases, both packages ----------------


def _ctrl(srch, n=9, eta=3, **kw):
    kw.setdefault("min_resource", 10)
    kw.setdefault("max_resource", 90)
    return srch.AshaController([f"t{i}" for i in range(n)], eta=eta, **kw)


def _actions(decisions, kind):
    return [d["trial_id"] for d in decisions if d["action"] == kind]


def test_asha_schedule_geometric_and_degenerate(pkg):
    srch = pkg[0]
    assert srch.asha_schedule(10, 270, 3) == [10, 30, 90, 270]
    assert srch.asha_schedule(10, 100, 3) == [10, 30, 100]
    assert srch.asha_schedule(100, 100, 3) == [100]
    assert srch.asha_schedule(200, 100, 3) == [100]
    assert srch.asha_schedule(22, 200, 3) == [22, 66, 200]


def test_hyperband_bracket_allocation(pkg):
    srch = pkg[0]
    brackets = srch.hyperband_brackets(81, 3)
    assert [b["bracket"] for b in brackets] == [4, 3, 2, 1, 0]
    assert brackets[0]["min_resource"] == 1 and brackets[0]["n_trials"] == 81
    assert brackets[-1]["min_resource"] == 81
    capped = srch.hyperband_brackets(81, 3, max_brackets=2, n_trials=20)
    assert len(capped) == 2
    assert sum(b["n_trials"] for b in capped) == pytest.approx(20, abs=2)


def test_resource_param_mapping_and_rejection(pkg):
    srch = pkg[0]
    assert srch.resource_param_for("LogisticRegression") == "max_iter"
    assert srch.resource_param_for("GradientBoostingClassifier") == "n_estimators"
    with pytest.raises(ValueError, match="resource budget"):
        srch.resource_param_for("KNeighborsClassifier")


def test_promotes_the_moment_top_one_over_eta_of_reported(pkg):
    c = _ctrl(pkg[0])
    assert c.on_report("t0", 0, 0.5) == []
    assert c.on_report("t1", 0, 0.4) == []
    ds = c.on_report("t2", 0, 0.3)
    assert _actions(ds, "promote") == ["t0"]
    assert ds[0]["to_rung"] == 1 and ds[0]["to_resource"] == 30
    assert c.trial_rung["t0"] == 1


def test_outranked_trials_prune_terminally(pkg):
    c = _ctrl(pkg[0], n=9)
    ds = []
    for i, score in enumerate([0.9, 0.8, 0.7, 0.6, 0.5, 0.4]):
        ds += c.on_report(f"t{i}", 0, score)
    assert c.decided.get("t3") == "pruned"  # rank 4 > max 3
    pruned = [d for d in ds if d["action"] == "prune" and d["trial_id"] == "t3"]
    assert pruned and pruned[0]["reason"] == "outranked"


def test_rung_closure_prunes_remainder_and_cascades(pkg):
    c = _ctrl(pkg[0], n=4, eta=3)
    ds = []
    for i, score in enumerate([0.4, 0.3, 0.2, 0.1]):
        ds += c.on_report(f"t{i}", 0, score)
    assert _actions(ds, "promote") == ["t0"]
    assert set(_actions(ds, "prune")) == {"t1", "t2", "t3"}
    assert _actions(c.on_report("t0", 1, 0.5), "promote") == ["t0"]
    assert _actions(c.on_report("t0", 2, 0.6), "complete") == ["t0"]
    assert c.is_complete()


def test_out_of_order_and_duplicate_reports_are_idempotent(pkg):
    c = _ctrl(pkg[0], n=4, eta=3)
    for i, score in enumerate([0.4, 0.3, 0.2, 0.1]):
        c.on_report(f"t{i}", 0, score)
    assert c.on_report("t0", 0, 0.9) == []
    assert c.on_report("t1", 0, 0.9) == []
    assert c.on_report("ghost", 0, 0.9) == []
    assert c.rungs[0].reported["t0"] == 0.4
    assert c.on_report("t0", 2, 0.9) == []
    assert c.trial_rung["t0"] == 1


def test_failed_trial_leaves_ladder_and_unblocks_closure(pkg):
    c = _ctrl(pkg[0], n=4, eta=3)
    for i, score in enumerate([0.4, 0.3, 0.2]):
        c.on_report(f"t{i}", 0, score)
    assert c.decided.get("t1") == "pruned" and c.decided.get("t2") == "pruned"
    assert "t0" not in c.decided
    ds = c.on_trial_failed("t3")
    assert c.decided["t3"] == "failed"
    assert c.pending_rungs() == {"t0": (1, 30)}
    assert not _actions(ds, "prune")


def test_stop_score_completes_winner_and_prunes_the_field(pkg):
    c = _ctrl(pkg[0], n=4, eta=3, stop_score=0.95)
    c.on_report("t1", 0, 0.5)
    ds = c.on_report("t0", 0, 0.99)
    assert _actions(ds, "complete") == ["t0"]
    assert set(_actions(ds, "prune")) == {"t1", "t2", "t3"}
    assert c.stopped and c.is_complete()
    assert c.on_report("t2", 0, 1.0) == []


def test_degenerate_single_rung_never_prunes(pkg):
    c = pkg[0].AshaController([f"t{i}" for i in range(5)], min_resource=100,
                              max_resource=100, eta=3)
    ds = []
    for i in range(5):
        ds += c.on_report(f"t{i}", 0, 0.1 * i)
    assert len(_actions(ds, "complete")) == 5
    assert not _actions(ds, "prune")
    assert c.is_complete()


def test_force_decide_is_first_wins(pkg):
    c = _ctrl(pkg[0], n=4, eta=3)
    c.force_decide("t0", "pruned")
    assert c.decided["t0"] == "pruned"
    assert c.force_decide("t0", "completed") == []
    assert c.on_report("t0", 0, 0.9) == []


def test_pending_rungs_tracks_unreported_current_rungs(pkg):
    c = _ctrl(pkg[0], n=4, eta=3)
    assert set(c.pending_rungs()) == {"t0", "t1", "t2", "t3"}
    for i, score in enumerate([0.4, 0.3, 0.2, 0.1]):
        c.on_report(f"t{i}", 0, score)
    assert c.pending_rungs() == {"t0": (1, 30)}


def _asha_details(**asha):
    return {"model_type": "LogisticRegression", "search_type": "asha",
            "base_estimator_params": {}, "param_grid": {"C": [0.1, 1.0, 10.0]},
            "n_iter": 3, "asha": asha}


def test_create_subtasks_stamps_rung_state(pkg):
    subtasks = pkg[2].create_subtasks(
        "j", "s", "iris", _asha_details(eta=3, min_resource=20, max_resource=180), {"cv": 3})
    assert len(subtasks) == 3
    for st in subtasks:
        a = st["asha"]
        assert a["rung"] == 0 and a["resource"] == 20
        assert a["max_resource"] == 180 and a["eta"] == 3
        assert a["resource_param"] == "max_iter"
        assert st["parameters"]["max_iter"] == 20
        assert st["train_params"]["rung"] == 0 and st["train_params"]["resource"] == 20


def test_plan_trials_drops_sampled_resource_param(pkg):
    details = _asha_details(eta=3, min_resource=10, max_resource=90)
    details["param_grid"] = {"C": [1.0], "max_iter": [500]}
    details["n_iter"] = 1
    (combo, block), = pkg[0].plan_trials(details)
    assert "max_iter" not in combo
    assert block["resource"] == 10


def test_hyperband_expansion_spans_brackets(pkg):
    srch, _, sub, _ = pkg
    details = _asha_details(eta=3, max_resource=27)
    details["search_type"] = "hyperband"
    details["param_distributions"] = {"C": [0.1, 1.0, 10.0, 100.0]}
    del details["param_grid"]
    details["n_iter"] = 12
    subtasks = sub.create_subtasks("j", "s", "iris", details, {})
    brackets = {st["asha"]["bracket"] for st in subtasks}
    assert len(brackets) >= 2
    ctrl = srch.build_controller(subtasks)
    assert set(ctrl.brackets) == brackets
    assert ctrl.summary()["n_trials"] == len(subtasks)


def test_unsupported_family_rejected_at_expansion(pkg):
    details = _asha_details()
    details["model_type"] = "GaussianNB"
    with pytest.raises(ValueError, match="resource budget"):
        pkg[2].create_subtasks("j", "s", "iris", details, {})


def _driver(pkg, n=4, eta=3, **asha):
    details = _asha_details(eta=eta, min_resource=10, max_resource=90, **asha)
    details["param_grid"] = {"C": [0.1 * (i + 1) for i in range(n)]}
    details["n_iter"] = n
    return pkg[0].SearchJobDriver(pkg[2].create_subtasks("j", "s", "iris", details, {}))


def test_driver_promotion_restamps_spec_with_larger_budget(pkg):
    d = _driver(pkg, n=4)
    tasks = d.pending_tasks()
    steps = [d.handle_result(t["subtask_id"], _result(t, score))
             for t, score in zip(tasks, [0.4, 0.3, 0.2, 0.1])]
    new = [t for s in steps for t in s.new_tasks]
    assert len(new) == 1
    task = new[0]
    assert task["asha"]["rung"] == 1 and task["asha"]["resource"] == 30
    assert task["parameters"]["max_iter"] == 30
    assert task["asha"]["warm_from"]["rung"] == 0
    finished = {tid for s in steps for tid, _, _ in s.finished}
    assert len(finished) == 3
    assert task["subtask_id"] not in finished


def test_driver_duplicate_result_not_rejournaled(pkg):
    d = _driver(pkg, n=4)
    tasks = d.pending_tasks()
    r = _result(tasks[0], 0.4)
    d.handle_result(tasks[0]["subtask_id"], r)
    assert r["asha"]["report"] is True
    dup = _result(tasks[0], 0.4)
    step2 = d.handle_result(tasks[0]["subtask_id"], dup)
    assert "report" not in dup["asha"]
    assert not step2.finished and not step2.new_tasks and not step2.promoted


def test_driver_stop_score_cancels_inflight_peers(pkg):
    d = _driver(pkg, n=4, stop_score=0.9)
    tasks = d.pending_tasks()
    step = d.handle_result(tasks[0]["subtask_id"], _result(tasks[0], 0.95))
    done = {tid: status for tid, status, _ in step.finished}
    assert done[tasks[0]["subtask_id"]] == "completed"
    assert sorted(v for k, v in done.items() if k != tasks[0]["subtask_id"]) == ["pruned"] * 3
    assert len(step.cancels) == 3
    assert d.done()


def test_driver_resume_replays_without_double_promotion(pkg):
    d1 = _driver(pkg, n=4)
    tasks = d1.pending_tasks()
    results, terminal = {}, {}
    for t, score in zip(tasks, [0.4, 0.3, 0.2, 0.1]):
        r = _result(t, score)
        step = d1.handle_result(t["subtask_id"], r)
        results[t["subtask_id"]] = r
        for tid, status, _ in step.finished:
            terminal[tid] = status
    record = {"subtasks": {
        t["subtask_id"]: {"status": terminal.get(t["subtask_id"], "promoted"),
                          "rung_history": [dict(results[t["subtask_id"]]["asha"])]}
        for t in tasks}}
    d2 = _driver(pkg, n=4)
    d2.resume(record)
    pend = d2.pending_tasks()
    assert len(pend) == 1 and pend[0]["asha"]["rung"] == 1
    assert d2.controller.summary()["pruned"] == 3
    assert d2.resume_step().finished == []


def test_plan_trials_runs_full_grid_without_n_iter(pkg):
    details = _asha_details(eta=3, min_resource=10, max_resource=90)
    details["param_grid"] = {"C": [0.1 * (i + 1) for i in range(27)]}
    del details["n_iter"]
    assert len(pkg[0].plan_trials(details)) == 27
    details["n_iter"] = 5
    assert len(pkg[0].plan_trials(details)) == 5


def test_driver_worker_pruned_result_unblocks_rung_closure(pkg):
    d = _driver(pkg, n=4)
    tasks = d.pending_tasks()
    for t, score in zip(tasks[:3], [0.4, 0.3, 0.2]):
        d.handle_result(t["subtask_id"], _result(t, score))
    step = d.handle_pruned_result(tasks[3]["subtask_id"],
                                  {"subtask_id": tasks[3]["subtask_id"], "status": "pruned"})
    assert tasks[3]["subtask_id"] in {tid for tid, _, _ in step.finished}
    assert d.controller.is_complete() or d.controller.pending_rungs()


def test_executor_cancel_respects_attempt_stamp(pkg):
    ex = pkg[3]()
    ex.cancel([{"subtask_id": "s1", "attempt": 1}])
    subtasks = [{"subtask_id": "s1", "attempt": 2}, {"subtask_id": "s1", "attempt": 1}]
    assert ex._take_cancelled(subtasks, [0]) == ([0], [])
    assert ex._take_cancelled(subtasks, [1]) == ([], [1])
    assert ex._take_cancelled(subtasks, [1]) == ([1], [])


def test_store_counts_pruned_and_replays_rung_history(pkg, tmp_path):
    store_mod = pkg[1]
    jd = str(tmp_path / "journal")
    store = store_mod.JobStore(journal_dir=jd)
    sid = store.create_session()
    store.create_job(sid, "j", {}, [{"subtask_id": f"j-subtask-{i}"} for i in range(3)])
    asha = {"rung": 0, "resource": 10, "score": 0.5, "seq": 1, "report": True}
    store.update_subtask(sid, "j", "j-subtask-0", "promoted",
                         {"status": "completed", "asha": asha})
    assert store.job_progress(sid, "j")["tasks_completed"] == 0
    store.update_subtask(sid, "j", "j-subtask-0", "completed",
                         {"status": "completed", "mean_cv_score": 0.9,
                          "asha": {**asha, "rung": 1, "seq": 2}})
    store.update_subtask(sid, "j", "j-subtask-1", "pruned",
                         {"status": "pruned", "asha": {**asha, "seq": 3}})
    store.update_subtask(sid, "j", "j-subtask-2", "failed", {"status": "failed"})
    prog = store.job_progress(sid, "j")
    assert prog["tasks_completed"] == 3 and prog["tasks_pruned"] == 1
    assert prog["tasks_failed"] == 1
    assert "pruned" in store_mod.SUBTASK_TERMINAL_STATUSES
    store.update_subtask(sid, "j", "j-subtask-1", "pruned", {"status": "pruned"})
    assert store.job_progress(sid, "j")["tasks_pruned"] == 1
    replayed = store_mod.JobStore(journal_dir=jd)
    job = replayed.get_job(sid, "j")
    assert job["pruned_subtasks"] == 1 and job["completed_subtasks"] == 1
    assert [h["seq"] for h in job["subtasks"]["j-subtask-0"]["rung_history"]] == [1, 2]
    p2 = replayed.job_progress(sid, "j")
    assert p2["tasks_pruned"] == 1 and p2["tasks_completed"] == 3


def test_store_search_state_rides_progress_unjournaled(pkg, tmp_path):
    store_mod = pkg[1]
    jd = str(tmp_path / "journal")
    store = store_mod.JobStore(journal_dir=jd)
    sid = store.create_session()
    store.create_job(sid, "j", {}, [{"subtask_id": "j-subtask-0"}])
    store.set_search_state(sid, "j", {"pruned": 2, "rungs": []})
    assert store.job_progress(sid, "j")["search"]["pruned"] == 2
    assert "search" not in store_mod.JobStore(journal_dir=jd).get_job(sid, "j")


# ---------------- end to end, both packages in direct mode ----------------

#: per-(trial, rung) score limits: LogReg's generic fits agree within 2e-3
#: (tests/test_torch_main_path.py), the forests exactly
E2E_TOL = {"LogisticRegression": 2e-3, "RandomForestClassifier": 1e-6}


def _rung_reports(manager, status):
    """{trial index: [(rung, score), ...]} from the journaled rung history,
    {trial index: final status}, and the curves' score rows by (trial, rung)."""
    store = manager._coordinator.store
    job = store.get_job(manager.session_id, manager.job_id)
    reports, final = {}, {}
    for stid, sub in job["subtasks"].items():
        i = int(stid.rsplit("-", 1)[1])
        reports[i] = [(h["rung"], h["score"]) for h in sub.get("rung_history") or []
                      if h.get("report")]
        final[i] = sub["status"]
    curves = {}
    for e in manager.curves()["curves"]:
        i = int(e["subtask_id"].rsplit("-", 1)[1])
        curves[(i, e["rung"])] = e["curve"].get("score")
    return reports, final, curves


def _assert_no_close_cut(reports, tol):
    """The precondition of comparing rung decisions: at no rung does a
    promoted trial and a trial stopped there lie within ``tol`` (and not
    tied exactly), so a difference within the score limit cannot flip a
    decision."""
    by_rung = {}
    for i, reps in reports.items():
        for rung, score in reps:
            by_rung.setdefault(rung, {})[i] = score
    for rung, scores in by_rung.items():
        up = {i for i in scores if (rung + 1) in by_rung and i in by_rung[rung + 1]}
        stay = set(scores) - up
        for p in up:
            for q in stay:
                gap = abs(scores[p] - scores[q])
                assert gap == 0.0 or gap > tol, (
                    f"rung {rung}: trials {p} (promoted) and {q} lie {gap} apart, within "
                    f"the {tol} score limit, so the packages may decide them differently")


#: the counters both packages' search runtime increments on a direct job
#: (``tpuml_jobs_completed_total`` moves after the manager has returned)
SEARCH_COUNTERS = ("tpuml_trials_promoted_total", "tpuml_trials_pruned_total",
                   "tpuml_trials_cancelled_total", "tpuml_trials_diverged_total",
                   "tpuml_curve_points_total", "tpuml_subtasks_completed_total",
                   "tpuml_subtasks_pruned_total", "tpuml_subtasks_failed_total")


def _events(path):
    """The flight recorder's journal as (kind, trial index, attempt, data
    keys, rung, status, to_rung), without the JAX package's data-plane
    ``stage.upload`` events (ROADMAP A1)."""
    out = []
    for line in path.read_text().splitlines():
        e = json.loads(line)
        if e["kind"] != "stage.upload":
            d = e["data"]
            out.append((e["kind"], int(e["subtask_id"].rsplit("-", 1)[1]), e["attempt"],
                        sorted(d), d.get("rung"), d.get("status"), d.get("to_rung")))
    return out


def _compare_adaptive(search, dataset, search_params, model, journals=None):
    """Run the job through both managers and compare them. With
    ``journals`` (monkeypatch, a directory), each package journals its
    events under its own subdirectory, and the recorder's events and the
    search counters' increments must be equal too."""
    tol = E2E_TOL[model]
    counted = {}
    statuses = []
    for tag, make, registry in (("jax", JaxManager, jax_metrics.REGISTRY),
                                ("torch", lambda: TorchManager(device="cpu"),
                                 torch_metrics.REGISTRY)):
        if journals is not None:
            journals[0].setenv("CS230_JOURNAL_DIR", str(journals[1] / tag))
        before = {n: registry.counter(n).value() for n in SEARCH_COUNTERS}
        m = make()
        statuses.append((m, m.train(search, dataset, {"random_state": 42},
                                    show_progress=False, search_params=search_params)))
        counted[tag] = {n: registry.counter(n).value() - before[n] for n in SEARCH_COUNTERS}
    (jm, js), (tm, ts) = statuses
    if journals is not None:
        assert counted["torch"] == counted["jax"]
        assert counted["torch"]["tpuml_trials_pruned_total"] > 0
        events = _events(journals[1] / "torch" / "events.jsonl")
        assert events == _events(journals[1] / "jax" / "events.jsonl")
        assert {e[0] for e in events} == {"result", "curve.ingest", "rung.prune",
                                          "rung.promote"}
    assert js["job_status"] == ts["job_status"] == "completed"
    jr, tr = js["job_result"], ts["job_result"]
    assert jr["failed"] == [] and tr["failed"] == []
    jrep, jfinal, jcurves = _rung_reports(jm, js)
    trep, tfinal, tcurves = _rung_reports(tm, ts)
    _assert_no_close_cut(jrep, tol)
    assert tfinal == jfinal  # the same pruned and completed trials
    for i in jrep:
        assert [r for r, _ in trep[i]] == [r for r, _ in jrep[i]], i  # the same rungs
        for (_, a), (_, b) in zip(trep[i], jrep[i]):
            assert a == pytest.approx(b, abs=tol), i
    assert tr["n_pruned"] == jr["n_pruned"] > 0
    assert tr["search"] == jr["search"]
    assert tr["best_result"]["search_params"] == jr["best_result"]["search_params"]
    assert tr["best_result"]["parameters"] == jr["best_result"]["parameters"]
    return jcurves, tcurves


def test_logreg_asha_end_to_end_matches_jax(monkeypatch, tmp_path):
    search = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
              "base_estimator_params": {}, "cv_params": {"cv": 3},
              "param_grid": {"C": [round(1e-3 * 2.2 ** i, 6) for i in range(18)]}}
    _compare_adaptive(search, "synthetic_600x8x3",
                      {"type": "asha", "eta": 3, "min_resource": 5, "max_resource": 45},
                      "LogisticRegression", journals=(monkeypatch, tmp_path))


def test_forest_hyperband_end_to_end_matches_jax(monkeypatch):
    # one tree a dispatch, so every trial past one tree draws its
    # score-vs-chunk curve
    monkeypatch.setenv("CS230_TREE_CHUNK_MACS", "1e4")
    search = {"model_type": "RandomForestClassifier", "search_type": "GridSearchCV",
              "base_estimator_params": {"random_state": 0}, "cv_params": {"cv": 3},
              "param_grid": {"max_depth": [2, 3, 4], "max_features": ["sqrt"]}}
    # two brackets (1 -> 3 trees, and 3 trees); three configurations keep
    # the JAX side's compiles (one a bucket and budget) to seconds
    jcurves, tcurves = _compare_adaptive(
        search, "synthetic_300x6x3",
        {"type": "hyperband", "eta": 3, "max_resource": 3, "n_iter": 6},
        "RandomForestClassifier")
    multi = [k for k, v in jcurves.items() if v]
    assert multi and tcurves.keys() == jcurves.keys()
    for k in multi:
        assert len(tcurves[k]) == len(jcurves[k]) == 4  # holdout + 3 folds
        for ra, rb in zip(tcurves[k], jcurves[k]):
            assert len(ra) == len(rb) == 3  # one point a tree
            assert ra == pytest.approx(rb, abs=1e-6), k
