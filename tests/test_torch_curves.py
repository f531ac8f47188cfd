"""The port's trial telemetry plane against the JAX package's, on the CPU:
the numerical-health watchdog, the curve store, the curve journal, the
event stream, and the diverging MLP job of ``tests/test_telemetry_curves.py``.

- ``divergence`` and ``last_k_slope``: the JAX cases, and both packages'
  verdicts on the same records.
- ``CurveStore``: dedup on (subtask, rung, attempt), the version cursor
  behind the stream, the per-job bound, ``mark_diverged``.
- The journal's ``curve`` op: replay at every crash point never raises and
  drains exactly the intact curve lines; a torn last line is skipped. The
  flight recorder's event journal writes the JAX package's lines.
- The ASHA MLP job whose third learning rate explodes, through both
  packages' direct coordinators on iris (the generic path): the same trial
  diverges, at rung 0, nothing fails, and the winner has a sane rate. The
  same job on the port's fused path (B5's plain version, the route the
  card takes at covertype's size) diverges too, from the fused path's
  per-epoch loss curve.
- ``train(stream=True)`` returns the terminal status; ``stream_status``
  yields every curve once, before the terminal snapshot.
"""

import json
import os

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.obs import curves as jcurves
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.obs.curves import (
    CurveStore,
    build_curve_record,
    divergence,
    last_k_slope,
    trace_update,
)
from cs230_distributed_machine_learning_tpu_torch.runtime.store import JobStore
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


# ---------------- the watchdog rule and the store ----------------

RECORDS = {
    "falling_gmax": ({"gmax": np.geomspace(10.0, 0.01, 32)}, 32, [0.9, 0.9]),
    "nan_loss": ({"loss": [1.0, 2.0, float("nan"), 4.0]}, 4, [0.1]),
    "growing_loss": ({"loss": np.geomspace(1.0, 1e7, 32)}, 32, [0.1]),
    "short_blowup": ({"loss": [1.0, 1e6]}, 2, [0.1]),
    "score_only": ({"score": [[0.5, 0.6, 0.7]]}, 3, [0.7]),
    "zero_early": ({"gmax": [0.0] * 16 + [5e3] * 16}, 32, [0.2]),
}


@pytest.mark.parametrize("case", sorted(RECORDS))
@pytest.mark.parametrize("factor", [1e3, 1e9])
def test_divergence_verdicts_match_jax(case, factor):
    channels, steps, tail = RECORDS[case]
    got = build_curve_record(channels, 1, steps, tail=tail)
    want = jcurves.build_curve_record(channels, 1, steps, tail=tail)
    assert json.dumps(got) == json.dumps(want)
    assert divergence(got, factor) is jcurves.divergence(want, factor)


def test_divergence_rule_and_slope():
    ok = build_curve_record({"gmax": np.geomspace(10.0, 0.01, 32)}, 1, 32, tail=[0.9, 0.9])
    assert divergence(ok, 1e3) is False
    bad = build_curve_record({"loss": [1.0, 2.0, float("nan"), 4.0]}, 1, 4, tail=[0.1])
    assert bad["nonfinite"] is True and bad["loss"][0][2] is None
    assert divergence(bad, 1e3) is True
    grow = build_curve_record({"loss": np.geomspace(1.0, 1e7, 32)}, 1, 32, tail=[0.1])
    assert divergence(grow, 1e3) is True
    assert divergence(grow, 1e9) is False
    short = build_curve_record({"loss": [1.0, 1e6]}, 1, 2, tail=[0.1])
    assert divergence(short, 1e3) is False
    assert last_k_slope([1.0, 2.0, 3.0, 4.0]) == pytest.approx(1.0)
    assert last_k_slope([5.0, None, 5.0]) == pytest.approx(0.0)
    assert last_k_slope([1.0]) == 0.0
    rows = [[0.3, 0.5, 0.4, 0.9, 1.2, 1.0, 1.5, 2.0, 2.2, 2.1]]
    assert last_k_slope(rows[0], k=4) == jcurves.last_k_slope(rows[0], k=4)


def test_trace_update_keeps_inactive_lanes():
    buf = torch.zeros((3, 2))
    trace_update(buf, 0, torch.tensor([1.0, 2.0]), 2)
    trace_update(buf, 1, torch.tensor([3.0, 4.0]), 2, active=torch.tensor([True, False]))
    trace_update(buf, 5, torch.tensor([5.0, 6.0]), 2)
    assert buf.tolist() == [[3.0, 2.0], [0.0, 0.0], [5.0, 6.0]]


def test_curve_store_dedup_updates_and_bounds():
    store = CurveStore(max_entries_per_job=2, max_jobs=2)
    rec = build_curve_record({"gmax": [1.0, 0.5, 0.1, 0.05]}, 1, 4, tail=[0.9])
    assert store.ingest("j1", "s0", rec, rung=0, attempt=0) == 4
    assert store.ingest("j1", "s0", rec, rung=0, attempt=0) == 0
    assert store.ingest("j1", "s0", rec, rung=1, attempt=0) == 4
    assert store.n_entries("j1") == 2
    fresh, mark = store.updates("j1", 0)
    assert [e["rung"] for e in fresh] == [0, 1]
    again, mark2 = store.updates("j1", mark)
    assert again == [] and mark2 == mark
    store.ingest("j1", "s1", rec, rung=0)
    assert store.n_entries("j1") == 2
    assert store.subtask("j1", "s1") is not None
    store.mark_diverged("j1", "s1")
    assert store.subtask("j1", "s1")["curves"][-1]["diverged"] is True
    fresh, _ = store.updates("j1", mark)
    assert any(e["subtask_id"] == "s1" and e["diverged"] for e in fresh)
    # the job bound evicts the least recently used job
    store.ingest("j2", "s0", rec)
    store.ingest("j3", "s0", rec)
    assert store.job("j1") is None and store.job("j3")["n_curves"] == 1
    assert store.job("nope") is None
    assert store.subtask("j3", "nope") is None


# ---------------- the curve journal ----------------


def _curve_journal(jd):
    store = JobStore(journal_dir=jd)
    sid = store.create_session()
    store.create_job(sid, "cj", {}, [{"subtask_id": "cj-s0"}, {"subtask_id": "cj-s1"}])
    rec = build_curve_record({"gmax": [1.0, 0.5, 0.1, 0.05]}, 1, 4, tail=[0.9])
    store.record_curve(sid, "cj", "cj-s0", rec, rung=0)
    store.record_curve(sid, "cj", "cj-s0", rec, rung=1)
    bad = build_curve_record({"loss": [1.0, float("inf")] * 4}, 1, 8, tail=[0.0])
    store.record_curve(sid, "cj", "cj-s1", bad, rung=0, diverged=True)
    return sid


def test_curve_journal_crash_point_fuzz(tmp_path):
    jd_full = str(tmp_path / "full")
    _curve_journal(jd_full)
    lines = open(os.path.join(jd_full, "jobs.jsonl"), "rb").read().splitlines(keepends=True)
    is_curve = [json.loads(ln).get("op") == "curve" for ln in lines]
    assert sum(is_curve) == 3
    for i in range(len(lines) + 1):
        jd = str(tmp_path / f"cut{i}")
        os.makedirs(jd)
        with open(os.path.join(jd, "jobs.jsonl"), "wb") as f:
            f.writelines(lines[:i])
        cut = JobStore(journal_dir=jd)  # never raises
        assert cut.replay_skipped == 0
        drained = cut.drain_replayed_curves()
        assert len(drained) == sum(is_curve[:i])
        assert cut.drain_replayed_curves() == []
        assert all(e["jid"] == "cj" and e["curve"]["v"] == 1 for e in drained)
    full = JobStore(journal_dir=jd_full)
    assert full.replay_ops.get("curve") == 3
    drained = full.drain_replayed_curves()
    assert [e["rung"] for e in drained] == [0, 1, 0]
    assert [e["diverged"] for e in drained] == [False, False, True]
    assert divergence(drained[2]["curve"], 1e3) is True


def test_curve_journal_torn_write_skipped(tmp_path):
    jd_full = str(tmp_path / "full")
    _curve_journal(jd_full)
    lines = open(os.path.join(jd_full, "jobs.jsonl"), "rb").read().splitlines(keepends=True)
    jd = str(tmp_path / "torn")
    os.makedirs(jd)
    with open(os.path.join(jd, "jobs.jsonl"), "wb") as f:
        f.writelines(lines[:-1])
        f.write(lines[-1][: len(lines[-1]) // 2])
    store = JobStore(journal_dir=jd)
    assert store.replay_skipped == 1
    assert store.replay_ops.get("curve") == 2
    assert len(store.drain_replayed_curves()) == 2
    # the torn line was terminated: the next append starts on a clean line
    store.create_session("after")
    assert JobStore(journal_dir=jd).has_session("after")


def test_coordinator_reads_back_journaled_curves():
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    first = Coordinator(device="cpu", journal=True)
    m = TorchManager(coordinator=first)
    m.train({"model_type": "LogisticRegression", "search_type": "GridSearchCV",
             "base_estimator_params": {"max_iter": 20}, "param_grid": {"C": [0.1, 1.0]},
             "cv_params": {"cv": 3}}, "iris")
    again = Coordinator(device="cpu", journal=True)
    assert again.job_curves(m.job_id)["n_curves"] == first.job_curves(m.job_id)["n_curves"] == 2


def test_event_journal_writes_the_jax_lines(tmp_path, monkeypatch):
    """The flight recorder's journal writer appends the JAX package's lines
    once flushed (each to the directory current when it was appended),
    makes its directory again when it was removed, rolls the file to
    ``<name>.1`` once it passes the size cap, and writes a file's lines
    unflushed once it holds ``_MAX_PENDING``."""
    from cs230_distributed_machine_learning_tpu.obs import tracing as jtracing
    from cs230_distributed_machine_learning_tpu_torch.obs import tracing

    events = [{"kind": "result", "job_id": "j", "data": {"score": 0.5}},
              {"kind": "curve.ingest", "job_id": "j", "data": {"n_points": 4}}]
    for name, mod in (("jax", jtracing), ("torch", tracing)):
        monkeypatch.setenv("CS230_JOURNAL_DIR", str(tmp_path / name))
        for e in events:
            mod.journal_append("events.jsonl", e)
    assert not (tmp_path / "torch").exists()
    tracing.flush_journal()
    assert (tmp_path / "torch" / "events.jsonl").read_text() == \
        (tmp_path / "jax" / "events.jsonl").read_text()
    monkeypatch.setenv("CS230_JOURNAL_DIR", str(tmp_path / "gone"))
    tracing.journal_append("events.jsonl", events[0])
    tracing.flush_journal()
    (tmp_path / "gone" / "events.jsonl").unlink()
    (tmp_path / "gone").rmdir()
    tracing.journal_append("events.jsonl", events[1])
    tracing.flush_journal()
    assert json.loads((tmp_path / "gone" / "events.jsonl").read_text()) == events[1]
    monkeypatch.setenv("CS230_JOURNAL_MAX_MB", "0.00005")  # 50 bytes
    tracing.journal_append("events.jsonl", events[0])
    tracing.flush_journal()
    assert not (tmp_path / "gone" / "events.jsonl").exists()
    rolled = (tmp_path / "gone" / "events.jsonl.1").read_text().splitlines()
    assert [json.loads(line) for line in rolled] == [events[1], events[0]]
    monkeypatch.delenv("CS230_JOURNAL_MAX_MB")
    monkeypatch.setattr(tracing, "_MAX_PENDING", 2)
    monkeypatch.setenv("CS230_JOURNAL_DIR", str(tmp_path / "full"))
    tracing.journal_append("events.jsonl", events[0])
    assert not (tmp_path / "full").exists()
    tracing.journal_append("events.jsonl", events[1])
    written = (tmp_path / "full" / "events.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in written] == events


# ---------------- the diverging MLP job ----------------


def _asha_mlp_job():
    # tests/test_telemetry_curves.py's job: one learning rate explodes to a
    # non-finite loss inside rung 0
    return {
        "model_type": "MLPClassifier",
        "search_type": "asha",
        "base_estimator_params": {"hidden_layer_sizes": (4,), "solver": "sgd",
                                  "random_state": 0},
        "param_grid": {"learning_rate_init": [0.05, 0.02, 1e6]},
        "cv_params": {"cv": 2},
        "n_iter": 3,
        "asha": {"eta": 3, "min_resource": 10, "max_resource": 30},
    }


def _diverged_outcome(status):
    assert status["job_status"] == "completed"
    jr = status["job_result"]
    assert jr.get("failed") == []
    (dv,) = jr.get("diverged_results") or [None]
    assert dv["status"] == "diverged"
    assert dv["parameters"].get("learning_rate_init") == 1e6
    assert int((dv.get("asha") or {}).get("rung") or 0) == 0
    assert jr.get("n_diverged") == 1
    assert jr["best_result"]["parameters"]["learning_rate_init"] < 1.0
    def trial(r):
        return int(r["subtask_id"].rsplit("-", 1)[1])

    return trial(dv), trial(jr["best_result"]), jr["search"]


@pytest.mark.filterwarnings("ignore")
def test_watchdog_diverges_the_same_trial_as_jax():
    js = JaxManager().train(_asha_mlp_job(), "iris", show_progress=False, timeout=300)
    tm = TorchManager(device="cpu")
    ts = tm.train(_asha_mlp_job(), "iris", timeout=300)
    assert _diverged_outcome(ts) == _diverged_outcome(js)
    body = tm.curves()
    assert body["job_status"] == "completed" and body["tasks_diverged"] == 1
    flagged = [e for e in body["curves"] if e["diverged"]]
    assert flagged and flagged[0]["curve"]["nonfinite"] is True
    stid = flagged[0]["subtask_id"]
    assert tm.curves(subtask_id=stid)["subtask_id"] == stid
    with pytest.raises(KeyError):
        tm.curves(subtask_id="no-such-subtask")
    with pytest.raises(KeyError):
        tm.curves(job_id="no-such-job")


def test_fused_path_emits_the_loss_curve_the_watchdog_reads(monkeypatch):
    """B5's route (the fused path, forced here onto its plain version)
    writes the per-epoch loss curve, so the diverging job ends the same way
    on the route the card takes at covertype's size."""
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    k = get_kernel("MLPClassifier")
    n, d, c, S = 150, 4, 3, 3
    static = k.resolve_static({**k.static_defaults, "hidden_layer_sizes": (4,),
                               "solver": "sgd", "max_iter": 10}, n, d, c)
    static["_n_classes"] = c
    fn = k.build_batched_fn(static, n, d, c, S, 2, torch.device("cpu"))
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.randn(n, d), dtype=torch.float32)
    y = torch.tensor(rng.randint(0, c, n))
    TW = torch.tensor((rng.rand(S, n) > 0.3).astype(np.float32))
    out = fn(X, y, TW, 1.0 - TW, {"alpha": torch.tensor([1e-4, 1e-4]),
                                  "learning_rate_init": torch.tensor([0.05, 1e6])})
    assert out["curve_loss"].shape == (2, S, 10)
    sane = build_curve_record({"loss": out["curve_loss"][0].numpy()}, 1, 10)
    wild = build_curve_record({"loss": out["curve_loss"][1].numpy()}, 1, 10)
    assert divergence(sane, 1e3) is False and divergence(wild, 1e3) is True

    ts = TorchManager(device="cpu").train(_asha_mlp_job(), "iris", timeout=300)
    _diverged_outcome(ts)


# ---------------- the event stream ----------------


def test_stream_returns_the_terminal_status_and_every_curve_once():
    tm = TorchManager(device="cpu")
    job = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
           "base_estimator_params": {}, "param_grid": {"C": [0.01 * 3 ** i for i in range(9)]},
           "cv_params": {"cv": 3}}
    status = tm.train(job, "iris", stream=True, show_progress=False,
                      search_params={"type": "asha", "eta": 3, "min_resource": 10,
                                     "max_resource": 90})
    assert status["job_status"] == "completed" and status["job_result"] == tm.result
    assert status["tasks_pruned"] == status["job_result"]["n_pruned"] == 8
    events = list(tm._coordinator.stream_status(tm.session_id, tm.job_id, tick_s=0.01))
    curves = [e for e in events if e.get("kind") == "curve"]
    assert events[-1]["job_status"] == "completed"
    assert all(e.get("kind") == "curve" for e in events[:-1])
    keys = [(e["subtask_id"], e["rung"], e["attempt"]) for e in curves]
    assert len(keys) == len(set(keys)) == tm.curves()["n_curves"] == 9 + 3 + 1
    assert {e["subtask_id"] for e in curves} == {e["subtask_id"] for e in
                                                 tm.curves()["curves"]}
