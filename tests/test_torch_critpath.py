"""The port's critical-path engine and trace export against the JAX
package's, on the CPU.

Synthetic spans and flight-recorder timelines with hand-picked timestamps
(the JAX ``tests/test_critpath.py`` scenarios: the happy path with an
untraced gap, a front end's span anchoring the window, a hung worker's
reclaim wait, a speculative win, phases overrunning their batch) go
through both packages' ``critical_path``, ``compare``, ``to_perfetto`` and
``to_otlp``, and the reports must be equal dicts. Then a local iris search
through each package's ``MLTaskManager``: the same span names and parent
names, and a critical path whose segments tile the job's wall.
"""

import json
import uuid

import pytest
import torch

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.obs import TRACER as JTRACER
from cs230_distributed_machine_learning_tpu.obs import critpath as jcrit
from cs230_distributed_machine_learning_tpu.obs import export as jexport
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.obs import TRACER as TTRACER
from cs230_distributed_machine_learning_tpu_torch.obs import critpath as tcrit
from cs230_distributed_machine_learning_tpu_torch.obs import export as texport
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

T = 1_700_000_000.0
TID = "aaaabbbbccccdddd"


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _span(name, start, end, *, sid=None, parent=None, attrs=None, process="pid:1"):
    return {"trace_id": TID, "span_id": sid or uuid.uuid4().hex[:8], "parent_id": parent,
            "name": name, "start": T + start, "end": T + end, "attrs": attrs or {},
            "process": process}


def _ev(kind, ts, *, stid="st1", attempt=0, worker=None, data=None):
    return {"ts": T + ts, "kind": kind, "job_id": "job-1", "subtask_id": stid,
            "worker_id": worker, "attempt": attempt, "data": data or {}, "seq": 0}


def _happy(aggregate_end=10.0):
    spans = [
        _span("http.train", 0.0, 0.5, sid="http0001"),
        _span("job.submit", 0.05, 0.45, parent="http0001"),
        _span("job.expand", 0.1, 0.3),
        _span("job.execute", 0.5, 9.0),
        _span("schedule.place", 0.9, 1.0, attrs={"subtask_id": "st1", "worker": "w1",
                                                 "attempt": 0}),
        _span("executor.batch", 1.0, 7.0, sid="batch123", attrs={"worker": "w1"}),
        _span("executor.compile", 1.0, 3.0, parent="batch123"),
        _span("executor.stage", 3.0, 3.0, parent="batch123"),
        _span("executor.dispatch", 3.0, 6.5, parent="batch123"),
        _span("executor.fetch", 6.5, 7.0, parent="batch123"),
        _span("job.aggregate", 9.0, aggregate_end),
    ]
    timelines = {
        "st1": [_ev("placement", 1.0, worker="w1"),
                _ev("result", 8.0, worker="w1", data={"status": "completed"})],
        "st0": [_ev("placement", 1.0, stid="st0", worker="w2"),
                _ev("result", 5.0, stid="st0", worker="w2", data={"status": "completed"})],
    }
    return spans, timelines


def _frontend():
    spans, timelines = _happy()
    return [_span("frontend.proxy", -0.3, 0.6, process="frontend:1")] + spans, timelines


def _reclaim():
    spans = [
        _span("job.submit", 0.0, 0.2), _span("job.execute", 0.2, 12.0),
        _span("schedule.place", 0.4, 0.5, attrs={"subtask_id": "st1", "worker": "w0",
                                                 "attempt": 0}),
        _span("schedule.place", 5.5, 5.6, attrs={"subtask_id": "st1", "worker": "w1",
                                                 "attempt": 1}),
        _span("executor.batch", 5.6, 9.6, attrs={"worker": "w1"}),
        _span("job.aggregate", 12.0, 12.5),
    ]
    timelines = {"st1": [
        _ev("placement", 0.5, attempt=0, worker="w0"),
        _ev("lease.reclaim", 5.5, attempt=0, worker="w0", data={"overdue_s": 2.0}),
        _ev("placement", 5.6, attempt=1, worker="w1"),
        _ev("result", 10.0, attempt=1, worker="w1", data={"status": "completed"})]}
    return spans, timelines


def _speculative():
    spans = [
        _span("job.submit", 0.0, 0.2), _span("job.execute", 0.2, 7.0),
        _span("executor.batch", 0.6, 6.8, attrs={"worker": "w0"}),
        _span("executor.batch", 3.2, 5.9, attrs={"worker": "w1"}),
        _span("job.aggregate", 7.0, 7.2),
    ]
    timelines = {"st1": [
        _ev("placement", 0.5, attempt=0, worker="w0"),
        _ev("speculate.launch", 3.0, attempt=1, worker="w1"),
        _ev("placement", 3.1, attempt=1, worker="w1"),
        _ev("speculate.win", 6.0, attempt=1, worker="w1"),
        _ev("result", 6.0, attempt=1, worker="w1", data={"status": "completed"})]}
    return spans, timelines


def _overrun():
    spans = [
        _span("job.submit", 0.0, 0.2), _span("job.execute", 0.2, 2.0),
        _span("executor.batch", 0.4, 2.0, sid="bb000001", attrs={"worker": "w1"}),
        _span("executor.compile", 0.4, 2.0, parent="bb000001"),
        _span("executor.dispatch", 2.0, 3.6, parent="bb000001"),
        _span("job.aggregate", 2.0, 4.0),
    ]
    timelines = {"st1": [_ev("placement", 0.4, worker="w1"),
                         _ev("result", 2.0, worker="w1", data={"status": "completed"})]}
    return spans, timelines


def _direct():
    """A direct-mode job as the coordinator records it: the executor's
    batch under job.execute, results with no worker, a 0.4 s gap."""
    spans = [
        _span("client.train", 0.0, 0.3, sid="client01"),
        _span("job.submit", 0.01, 0.29, parent="client01"),
        _span("job.execute", 0.3, 2.0, sid="exec0001"),
        _span("executor.batch", 0.35, 1.6, sid="batch001", parent="exec0001",
              attrs={"worker": "local"}),
        _span("executor.stage", 0.35, 0.5, parent="batch001"),
        _span("executor.dispatch", 0.5, 1.4, parent="batch001"),
        _span("executor.fetch", 1.4, 1.6, parent="batch001"),
        _span("job.aggregate", 2.0, 2.1),
    ]
    timelines = {"st1": [_ev("result", 1.6, data={"status": "completed"})]}
    return spans, timelines


SCENARIOS = {"happy": _happy, "frontend": _frontend, "reclaim": _reclaim,
             "speculative": _speculative, "overrun": _overrun, "direct": _direct}


def _tiles(report):
    segs = report["segments"]
    assert segs[0]["start"] == pytest.approx(report["t0"])
    assert segs[-1]["end"] == pytest.approx(report["t1"])
    for a, b in zip(segs, segs[1:]):
        assert a["end"] == pytest.approx(b["start"])
    assert abs(sum(s["duration_s"] for s in segs) - report["wall_s"]) <= 1e-6


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_critical_path_matches_jax(scenario):
    spans, timelines = SCENARIOS[scenario]()
    got = tcrit.critical_path("job-1", trace_id=TID, spans=spans, timelines=timelines,
                              job_wall_s=9.5)
    ref = jcrit.critical_path("job-1", trace_id=TID, spans=spans, timelines=timelines,
                              job_wall_s=9.5)
    assert got == ref
    _tiles(got)


def test_no_spans_is_none_in_both():
    assert tcrit.critical_path("j", trace_id=None, spans=[]) is None
    assert jcrit.critical_path("j", trace_id=None, spans=[]) is None


def test_compare_matches_jax():
    base = tcrit.critical_path("job-1", trace_id=TID, spans=_happy()[0], timelines=_happy()[1])
    slow_spans, slow_tl = _happy(aggregate_end=13.0)
    slow = tcrit.critical_path("job-1", trace_id=TID, spans=slow_spans, timelines=slow_tl)
    got = tcrit.compare(base, slow)
    assert got == jcrit.compare(base, slow)
    assert got["dominant_segment"] == "aggregate" and got["delta_wall_s"] == pytest.approx(3.0)


@pytest.mark.parametrize("fmt", ["perfetto", "otlp"])
def test_exports_match_jax(fmt):
    spans = _happy()[0]
    if fmt == "perfetto":
        assert texport.to_perfetto(spans) == \
            jexport.to_perfetto(spans)
    else:
        assert texport.to_otlp(spans) == \
            jexport.to_otlp(spans)


def test_export_trace_writes_under_the_journal_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CS230_JOURNAL_DIR", str(tmp_path / "j"))
    out = texport.export_trace(TID, _happy()[0], "perfetto", job_id="job-1")
    doc = json.load(open(out["path"]))
    assert out["path"].startswith(str(tmp_path / "j")) and doc["traceEvents"]
    with pytest.raises(ValueError):
        texport.export_trace(TID, _happy()[0], "jaeger")


# ---------------- a local iris search in both packages ----------------

SEARCH = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
          "base_estimator_params": {"max_iter": 100},
          "param_grid": {"C": [0.1, 1.0]}, "cv_params": {"cv": 3}}


def _search_spans(manager, tracer):
    status = manager.train(dict(SEARCH), "iris", show_progress=False, timeout=300)
    assert status["job_status"] == "completed"
    manager._coordinator._job_threads[manager.job_id].join(timeout=30)
    tid = tracer.trace_for_job(manager.job_id)
    assert tid == manager.trace_id
    spans = tracer.spans_for(tid)
    by_id = {s["span_id"]: s["name"] for s in spans}
    names = sorted((s["name"], by_id.get(s["parent_id"])) for s in spans)
    return names, manager


def test_local_search_spans_match_jax_and_tile_the_wall():
    got, tm = _search_spans(TorchManager(device="cpu"), TTRACER)
    ref, _ = _search_spans(JaxManager(), JTRACER)
    assert got == ref
    assert ("executor.batch", "job.execute") in got
    assert ("job.submit", "client.train") in got
    for phase in ("compile", "stage", "dispatch", "fetch"):
        assert (f"executor.{phase}", "executor.batch") in got
    report = tm.critical_path()
    _tiles(report)
    assert report["trace_id"] == tm.trace_id
    stid = tm.check_status()["job_result"]["results"][0]["subtask_id"]
    assert [e["kind"] for e in tm.explain(subtask_id=stid)["events"]][-1] == "result"
    with pytest.raises(KeyError):
        tm.explain(subtask_id="nope")
    with pytest.raises(KeyError):
        tm.critical_path(job_id="nope")
    diff = tm.critical_path(compare=tm.job_id)["diff"]
    assert diff["delta_wall_s"] == pytest.approx(0.0)
