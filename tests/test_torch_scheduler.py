"""The port's scheduling pieces against the JAX package's, on the CPU.

- ``TopicBus``: one scripted publish sequence over priority lanes, with and
  without lane aging, is delivered in the same order by both packages.
- ``AttemptLedger``: one scripted sequence of seeds, attempts, failures,
  device losses, staleness checks and completions gives equal decisions.
- ``utils/sklearn_compat.GradientBoostingRegressor`` against
  scikit-learn's ``GradientBoostingRegressor(random_state=0)``: predictions
  within 1e-9, on continuous data and on the predictor's kind of data,
  whose repeated columns tie exactly; the ``.npz`` state round-trips.
- ``RuntimePredictor``: both packages fed the same observation stream
  predict within 1e-6 at every step, report the same calibration, and the
  port's ``.npz`` state reloads to the same predictions.
- ``PlacementEngine``: scripted workers, placements, metrics feedback,
  unsubscribes and a dead-worker sweep give the same placements, loads,
  queues and speed factors.
"""

import time
import types

import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingRegressor as SkGBRT

from cs230_distributed_machine_learning_tpu.runtime import faults as jfaults
from cs230_distributed_machine_learning_tpu.runtime import predictor as jpred
from cs230_distributed_machine_learning_tpu.runtime import queue as jqueue
from cs230_distributed_machine_learning_tpu.runtime import scheduler as jsched
from cs230_distributed_machine_learning_tpu.utils import config as jcfg
from cs230_distributed_machine_learning_tpu_torch.runtime import faults as tfaults
from cs230_distributed_machine_learning_tpu_torch.runtime import predictor as tpred
from cs230_distributed_machine_learning_tpu_torch.runtime import queue as tqueue
from cs230_distributed_machine_learning_tpu_torch.runtime import scheduler as tsched
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils.sklearn_compat import (
    GradientBoostingRegressor,
)

torch.set_num_threads(1)

PACKAGES = {
    "jax": types.SimpleNamespace(queue=jqueue, faults=jfaults, pred=jpred, sched=jsched,
                                 cfg=jcfg),
    "torch": types.SimpleNamespace(queue=tqueue, faults=tfaults, pred=tpred, sched=tsched,
                                   cfg=tcfg),
}


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


class FakeClock:
    """``time.time`` that moves only when the test says so."""

    def __init__(self, start=1_000_000.0):
        self.now = start

    def __call__(self):
        return self.now


# ---------------- TopicBus ----------------


def _bus_order(pkg, clock, aging_s):
    bus = pkg.queue.TopicBus()
    sub = bus.subscribe("train", key_filter=lambda k: k in ("w0", "w1"), priority=True,
                        aging_s=aging_s)
    plain = bus.subscribe("train")
    script = [("a", 0, "w0"), ("b", 2, "w1"), ("c", 1, "w0"), ("d", 0, "w9"), ("e", 2, "w0"),
              ("f", 0, "w1"), ("g", 1, "w1")]
    for i, (name, prio, key) in enumerate(script):
        clock.now += 7.0 * i  # older messages age into higher lanes
        bus.publish("train", {"subtask_id": name, "priority": prio}, key=key)
    clock.now += 40.0
    out = [sub.get_nowait() for _ in range(len(sub))]
    fifo = [plain.get_nowait()[1]["subtask_id"] for _ in range(len(plain))]
    return [(k, m["subtask_id"]) for k, m in out], fifo, bus.depths()


@pytest.mark.parametrize("aging_s", [0.0, 10.0])
def test_topic_bus_order_and_aging_match_jax(monkeypatch, aging_s):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    got = {name: _bus_order(pkg, clock, aging_s) for name, pkg in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    order, fifo, _ = got["torch"]
    assert fifo == list("abcdefg") and "d" not in [s for _, s in order]
    if not aging_s:  # strict priority: lane 2 first, FIFO within a lane
        assert [s for _, s in order] == ["b", "e", "c", "g", "a", "f"]


# ---------------- AttemptLedger ----------------


def _ledger_trace(pkg):
    ledger = pkg.faults.AttemptLedger()
    hooks = []
    ledger.on_attempt = lambda task, entry, reason: hooks.append(
        (task["subtask_id"], entry.attempt, entry.failures, list(entry.excluded), reason))
    out = []
    a = {"subtask_id": "a", "job_id": "j"}
    b = {"subtask_id": "b", "job_id": "j", "attempt": 3, "failures": 1,
         "excluded_workers": ["w9"]}
    ledger.seed(a)
    ledger.seed(b)
    ledger.next_attempt(a, exclude_worker="w0", reason="failure")
    out.append(("a1", a["attempt"], list(a.get("excluded_workers") or [])))
    e = ledger.record_failure("a", "w0")
    out.append(("fail", e.failures, e.attempt, list(e.excluded)))
    out.append(("stale", ledger.is_stale("a", 0), ledger.is_stale("a", a["attempt"])))
    ledger.next_attempt(a, exclude_worker="w1", reason="lease")
    out.append(("a2", a["attempt"], sorted(a.get("excluded_workers") or [])))
    out.append(("kills", ledger.note_device_loss("b"), ledger.note_device_loss("b")))
    spec = dict(b)
    ledger.next_attempt(spec, reason="speculation")
    out.append(("spec", spec["attempt"], ledger.was_speculated("b")))
    ledger.mark_done("a")
    out.append(("done", ledger.is_done("a"), ledger.is_done("b")))
    ledger.forget(["a"])
    out.append(("forgot", ledger.is_done("a")))
    return out, hooks


def test_attempt_ledger_decisions_match_jax():
    got = {name: _ledger_trace(pkg) for name, pkg in PACKAGES.items()}
    assert got["torch"] == got["jax"]


# ---------------- the GBRT copy ----------------


def _predictor_like(rng, n):
    """Rows like the predictor's features: three datasets' constant
    columns (which cut the rows into identical sets: exact ties), two
    continuous columns, a zero column."""
    ds = rng.randint(0, 3, n)
    return np.stack([rng.choice([417.0, 33.0, 902.0], n),
                     np.array([116202.0, 150.0, 5000.0])[ds],
                     np.array([54.0, 4.0, 20.0])[ds], rng.rand(n) * 100, rng.rand(n) * 100,
                     np.zeros(n), np.array([30.1, 0.01, 1.2])[ds]], 1), ds


@pytest.mark.parametrize("kind", ["continuous", "predictor_like"])
def test_gbrt_copy_matches_scikit_learn(kind):
    rng = np.random.RandomState(7)
    for n in (2, 13, 60, 200):
        if kind == "continuous":
            X = rng.rand(n, 7) * [1000, 1e5, 50, 100, 100, 1, 20]
            y = rng.rand(n) * 5 + X[:, 1] / 1e4
            Xt = rng.rand(200, 7) * [1000, 1e5, 50, 100, 100, 1, 20]
        else:
            X, ds = _predictor_like(rng, n)
            y = rng.rand(n) + ds
            Xt = np.concatenate([X, X + rng.randn(*X.shape)])
        ref = SkGBRT(random_state=0).fit(X, y)
        ours = GradientBoostingRegressor(random_state=0).fit(X, y)
        for rows in (X, Xt):
            np.testing.assert_allclose(ours.predict(rows), ref.predict(rows), rtol=0, atol=1e-9)
        back = GradientBoostingRegressor.from_state(ours.state())
        np.testing.assert_array_equal(back.predict(Xt), ours.predict(Xt))


def test_gbrt_cold_start_is_the_dummy_fit():
    ours = GradientBoostingRegressor(random_state=0).fit(np.zeros((2, 7)), np.ones(2))
    assert ours.predict(np.random.RandomState(0).rand(4, 7)).tolist() == [1.0] * 4


# ---------------- RuntimePredictor ----------------


def _observations(n=47):
    rng = np.random.RandomState(3)
    metas = [{"n_rows": 150, "n_cols": 4, "size_mb": 0.01},
             {"n_rows": 116202, "n_cols": 54, "size_mb": 30.1}]
    out = []
    for i in range(n):
        task = {"model_type": ["LogisticRegression", "RandomForestClassifier"][i % 2],
                "metadata": metas[(i // 3) % 2], "cpu_percent_avg": float(rng.rand() * 100),
                "mem_percent_avg": float(rng.rand() * 100)}
        if i % 5 == 0:
            task["asha"] = {"resource": 22, "max_resource": 200}
        out.append((task, float(0.5 + rng.rand() * (5 if i % 2 else 1))))
    return out


def test_runtime_predictor_matches_jax_on_one_stream(tmp_path):
    preds = {name: pkg.pred.RuntimePredictor(model_path=str(tmp_path / f"{name}.state"),
                                             refit_batch=4, algo_weights={"SVC": 1.5})
             for name, pkg in PACKAGES.items()}
    stream = _observations()
    for task, actual in stream:
        est = {name: p.predict(task) for name, p in preds.items()}
        assert est["torch"] == pytest.approx(est["jax"], rel=1e-6, abs=1e-9)
        for name, p in preds.items():
            p.observe(task, actual)
            p.record_calibration(task["model_type"], est[name], actual)
    probe = [task for task, _ in stream] + [{"model_type": "SVC", "metadata": {"n_rows": 10}}]
    ours = [preds["torch"].predict(t) for t in probe]
    np.testing.assert_allclose(ours, [preds["jax"].predict(t) for t in probe], rtol=1e-6)
    assert len(set(np.round(ours, 6))) > 2  # the refits learned something
    jrep, trep = (preds[n].calibration_report() for n in ("jax", "torch"))
    assert trep.keys() == jrep.keys() == {"LogisticRegression", "RandomForestClassifier"}
    for fam in trep:
        for k, v in trep[fam].items():
            assert v == pytest.approx(jrep[fam][k], rel=1e-6), (fam, k)
    assert preds["torch"].hot_families() == preds["jax"].hot_families()
    # the port's state is an .npz of the fitted stages; a new process reads it back
    again = tpred.RuntimePredictor(model_path=str(tmp_path / "torch.state"), refit_batch=4,
                                   algo_weights={"SVC": 1.5})
    assert [again.predict(t) for t in probe] == ours
    with np.load(str(tmp_path / "torch.state")) as state:
        assert {"init", "offsets", "feature", "threshold", "value"} <= set(state.files)


# ---------------- PlacementEngine ----------------


def _placement_trace(pkg, clock, tmp_path, name):
    pkg.cfg.get_config().scheduler.dead_after_s = 10.0
    pred = pkg.pred.RuntimePredictor(model_path=str(tmp_path / f"eng_{name}"), refit_batch=3)
    eng = pkg.sched.PlacementEngine(predictor=pred)
    trace = []
    w = [eng.subscribe(mem_capacity_mb=cap) for cap in (100.0, 5000.0, 5000.0)]
    meta = {"n_rows": 150, "n_cols": 4, "size_mb": 0.01}
    placed = {}
    for i in range(12):
        task = {"subtask_id": f"t{i}", "job_id": "j", "model_type": "LogisticRegression",
                "metadata": meta, "mem_estimate_mb": 300.0 if i % 4 == 0 else 20.0}
        placed[task["subtask_id"]] = eng.place(task)
        trace.append(("place", task["subtask_id"], placed[task["subtask_id"]]))
    for i in range(0, 12, 2):  # worker feedback: each worker at its own speed
        stid = f"t{i}"
        wid = placed[stid]
        dur = {w[0]: 0.2, w[1]: 1.0, w[2]: 4.0}[wid]
        eng.on_metrics({"worker_id": wid, "subtask_id": stid, "started_at": clock.now,
                        "finished_at": clock.now + dur, "algo": "LogisticRegression",
                        "cpu_percent_avg": 10.0, "mem_percent_avg": 20.0})
        clock.now += 1.0
    trace.append(("requeued", sorted(t["subtask_id"] for t in eng.unsubscribe(w[2]))))
    for i in range(12, 16):
        task = {"subtask_id": f"t{i}", "job_id": "j", "model_type": "LogisticRegression",
                "metadata": meta, "mem_estimate_mb": 20.0}
        trace.append(("place", task["subtask_id"], eng.place(task)))
    clock.now += 20.0  # w1 goes silent; w0 heartbeats
    eng.heartbeat(w[0])
    trace.append(("dead", eng.sweep()))
    snap = eng.worker_snapshot()
    for wid in sorted(snap):
        s = snap[wid]
        trace.append((wid, round(s["load_seconds"], 9), round(s["mem_load_mb"], 9),
                       round(s["speed_factor"], 9), s["queue_depth"]))
    trace.append(("queues", eng.queue_snapshot()))
    return trace


def test_placement_engine_matches_jax_on_scripted_workers(monkeypatch, tmp_path):
    got = {}
    for name, pkg in PACKAGES.items():
        clock = FakeClock()
        monkeypatch.setattr(time, "time", clock)
        got[name] = _placement_trace(pkg, clock, tmp_path, name)
    assert got["torch"] == got["jax"]
    places = [p for p in got["torch"] if p[0] == "place"]
    assert {p[2] for p in places} >= {"worker-1", "worker-2"}
