"""The port's observability core against the JAX package's, on the CPU.

The metric catalog (the same family names in both registries, each in
docs/OBSERVABILITY.md), the tracer (span trees, propagation, the bounded
ring, remote ingest, the agent's drain, errors, synthesized phases, the
valve), the flight recorder (timelines, the firehose's cursors, eviction),
the embedded time series, the alert engine and the capacity signals on one
scripted series, the device profiler on ``torch.profiler`` (a round trip,
the busy and foreign-session refusals, tag sanitizing), the device-seconds
phases and the FLOP helpers (the H100 peaks; None on the CPU).
"""

import json
import os
import re
from types import SimpleNamespace

import pytest
import torch

import cs230_distributed_machine_learning_tpu.obs as jobs_
import cs230_distributed_machine_learning_tpu_torch.obs as tobs
from cs230_distributed_machine_learning_tpu.obs import devprof as jdevprof
from cs230_distributed_machine_learning_tpu.obs import recorder as jrecorder
from cs230_distributed_machine_learning_tpu.obs import signals as jsignals
from cs230_distributed_machine_learning_tpu.obs import slo as jslo
from cs230_distributed_machine_learning_tpu.obs import timeseries as jts
from cs230_distributed_machine_learning_tpu.obs import tracing as jtracing
from cs230_distributed_machine_learning_tpu.utils import config as jcfg
from cs230_distributed_machine_learning_tpu.utils import flops as jflops
from cs230_distributed_machine_learning_tpu_torch.obs import devprof as tdevprof
from cs230_distributed_machine_learning_tpu_torch.obs import recorder as trecorder
from cs230_distributed_machine_learning_tpu_torch.obs import signals as tsignals
from cs230_distributed_machine_learning_tpu_torch.obs import slo as tslo
from cs230_distributed_machine_learning_tpu_torch.obs import timeseries as tts
from cs230_distributed_machine_learning_tpu_torch.obs import tracing as ttracing
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils import flops as tflops

torch.set_num_threads(1)

PACKAGES = {"jax": (jtracing, jrecorder), "torch": (ttracing, trecorder)}
NOW = 1_700_000_000.0
DOC = os.path.join(os.path.dirname(__file__), "..", "docs", "OBSERVABILITY.md")


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


# ---------------- the metric catalog ----------------


def _eager_catalog(mod):
    """The family names ``register_catalog`` registers, into a fresh
    registry (the live one also holds families other tests created)."""
    fresh = mod.MetricsRegistry()
    saved, flag = mod.REGISTRY, mod._CATALOG_REGISTERED
    mod.REGISTRY, mod._CATALOG_REGISTERED = fresh, False
    try:
        mod.register_catalog()
    finally:
        mod.REGISTRY, mod._CATALOG_REGISTERED = saved, flag
    return set(fresh.names())


def test_registry_families_equal_and_documented():
    """The port registers the JAX catalog's family names eagerly, no other,
    each documented in docs/OBSERVABILITY.md, and importing the runtime
    leaves every one of them in the live registry."""
    import cs230_distributed_machine_learning_tpu_torch.runtime.server  # noqa: F401

    port, ref = _eager_catalog(tobs), _eager_catalog(jobs_)
    assert port == ref and len(port) > 70
    documented = set(re.findall(r"tpuml_[a-z0-9_]+", open(DOC).read()))
    assert not (port - documented)
    assert port <= set(tobs.REGISTRY.names())


def test_facade_exports_match():
    assert set(jobs_.__all__) <= set(tobs.__all__)
    assert {"refresh_route_p99", "timeseries_sample", "flush_journal"} <= set(tobs.__all__)


# ---------------- the tracer ----------------


def _norm(spans):
    """Spans as (name, parent name, attrs without timing) in start order."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: (s["start"], s["name"])):
        parent = by_id.get(s["parent_id"])
        attrs = {k: v for k, v in s["attrs"].items() if k != "error"}
        out.append((s["name"], parent["name"] if parent else None, sorted(attrs.items()),
                    "error" in s["attrs"]))
    return out


def _tree_names(nodes):
    return [(n["name"], _tree_names(n["children"])) for n in nodes]


def _scenario_nesting(tr, tracer):
    with tr.span("job.submit", trace_id="t1", tracer=tracer, job_id="j"):
        with tr.span("job.expand", tracer=tracer):
            pass
        with tr.span("schedule.place", tracer=tracer, worker="w1"):
            pass
    return _norm(tracer.spans_for("t1")), _tree_names(tracer.tree("t1"))


def _scenario_activate(tr, tracer):
    with tr.activate("t2"):
        assert tr.current_trace_id() == "t2"
        with tr.span("http.train", tracer=tracer) as sp:
            inner = tr.current_span_id()
            assert inner == sp.span_id
    with tr.activate("t2", "parent00"):
        with tr.span("job.execute", tracer=tracer):
            pass
    spans = tracer.spans_for("t2")
    return _norm(spans), sorted(s["parent_id"] for s in spans if s["parent_id"])


def _scenario_eviction(tr, tracer):
    for i in range(tr._MAX_TRACES + 3):
        tracer.record({"trace_id": f"t{i}", "span_id": f"s{i}", "parent_id": None,
                       "name": "x", "start": 0.0, "end": 1.0, "attrs": {}})
    tracer.bind_job("job-1", "t5")
    return len(tracer.traces()), tracer.traces()[:2], tracer.trace_for_job("job-1")


def _scenario_ingest(tr, tracer):
    n = tracer.ingest([{"trace_id": "t3", "span_id": "a", "name": "executor.batch",
                        "start": 1.0, "end": 2.0, "attrs": {}},
                       {"name": "no trace"}, "junk", {"trace_id": "t3"}])
    return n, [s["name"] for s in tracer.spans_for("t3")]


def _scenario_pending(tr, _tracer):
    agent = tr.Tracer(pending=True, journal=False)
    with tr.span("agent.poll", trace_id="t4", parent_id=None, tracer=agent):
        pass
    with tr.use_tracer(agent):
        with tr.span("executor.batch", trace_id="t4"):
            pass
    first = [s["name"] for s in agent.drain()]
    return first, agent.drain(), tr.Tracer(journal=False).drain()


def _scenario_error(tr, tracer):
    with pytest.raises(ValueError):
        with tr.span("job.execute", trace_id="t5", tracer=tracer):
            raise ValueError("boom")
    (s,) = tracer.spans_for("t5")
    return s["attrs"]["error"], s["name"]


def _scenario_phases(tr, tracer):
    with tr.span("executor.batch", trace_id="t6", tracer=tracer) as sp:
        t = tr.record_phase(sp, "executor.compile", 0.5, start=100.0, tracer=tracer)
        t = tr.record_phase(sp, "executor.stage", 0.25, start=t, tracer=tracer)
        end = tr.record_phase(sp, "executor.fetch", -1.0, start=t, tracer=tracer)
    phases = [(s["name"], s["start"], s["end"], s["attrs"]) for s in tracer.spans_for("t6")
              if s["name"] != "executor.batch"]
    return phases, end


SCENARIOS = {"nesting": _scenario_nesting, "activate": _scenario_activate,
             "eviction": _scenario_eviction, "ingest": _scenario_ingest,
             "pending": _scenario_pending, "error": _scenario_error,
             "phases": _scenario_phases}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tracer_matches_jax(scenario):
    got = {}
    for name, (tr, _) in PACKAGES.items():
        got[name] = SCENARIOS[scenario](tr, tr.Tracer(journal=False))
    assert got["torch"] == got["jax"]


def test_disabled_valve_records_nothing(monkeypatch):
    monkeypatch.setenv("CS230_OBS", "0")
    tracer = ttracing.Tracer(journal=False)
    with ttracing.span("job.submit", trace_id="off", tracer=tracer) as sp:
        sp.attrs["x"] = 1
        assert sp.span_id is None
    assert ttracing.record_phase(sp, "executor.stage", 1.0, tracer=tracer) is None
    assert tracer.spans_for("off") == []
    assert trecorder.FlightRecorder(journal=False).record("result", job_id="j") is None


def test_span_journal_is_buffered_until_flush(tmp_path, monkeypatch):
    monkeypatch.setenv("CS230_JOURNAL_DIR", str(tmp_path / "journal"))
    tracer = ttracing.Tracer()
    with ttracing.span("job.submit", trace_id="jt", tracer=tracer):
        pass
    path = tmp_path / "journal" / "spans.jsonl"
    ttracing.flush_journal()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["name"] for x in lines] == ["job.submit"] and lines[0]["trace_id"] == "jt"
    monkeypatch.setenv("CS230_OBS_JOURNAL", "0")
    with ttracing.span("job.expand", trace_id="jt", tracer=tracer):
        pass
    ttracing.flush_journal()
    assert len(path.read_text().splitlines()) == 1


# ---------------- the flight recorder ----------------


def _recorder_script(rec_mod, limit):
    rec = rec_mod.FlightRecorder(journal=False, max_events=6, max_subtasks=2)
    for i in range(4):
        rec.record("placement", job_id="j", subtask_id=f"s{i % 3}", worker_id="w1",
                   attempt=0, score=float(i))
    rec.record("breaker.trip", worker_id="w1")
    rec.record("result", job_id="j", subtask_id="s2", attempt=1, status="completed")
    evts, cursor = rec.events(since=1, limit=limit)
    strip = lambda e: {k: v for k, v in e.items() if k != "ts"}  # noqa: E731
    return ([strip(e) for e in evts], cursor, rec.job_subtasks("j"),
            [strip(e) for e in rec.timeline("j", "s2") or []],
            [strip(e) for e in rec.timeline("j", "s0") or []], rec.timeline("j", "nope"),
            rec.last_seq())


@pytest.mark.parametrize("limit", [2, 4, 1000])
def test_recorder_matches_jax(limit):
    assert _recorder_script(trecorder, limit) == _recorder_script(jrecorder, limit)


# ---------------- time series, alerts, capacity signals ----------------


def _series_store(ts_mod, series):
    st = ts_mod.TimeSeriesStore()
    for name, labels, samples in series:
        for t, v in samples:
            st._append(name, labels, t, v)
    return st


def test_timeseries_samples_counters_and_gauges():
    reg = tobs.MetricsRegistry()
    reg.counter("tpuml_c").inc(3, kind="a")
    reg.gauge("tpuml_g").set(2.5)
    reg.histogram("tpuml_h").observe(0.1)
    st = tts.TimeSeriesStore(min_interval_s=0.0)
    assert st.sample(reg, now=NOW) == 2
    assert st.sample(reg, now=NOW + 1) == 2
    assert sorted(st.names()) == ["tpuml_c", "tpuml_g"]
    (c,) = st.history("tpuml_c")
    assert c["labels"] == {"kind": "a"} and [v for _, v in c["samples"]] == [3.0, 3.0]
    (g,) = st.history("tpuml_g", since=NOW + 0.5)
    assert [list(x) for x in g["samples"]] == [[NOW + 1, 2.5]]


def _alert_run(slo, ts_mod, cfg_mod):
    cfg = cfg_mod.FrameworkConfig.load(env={})
    series = [
        ("tpuml_jobs_rejected_total", {}, [(NOW - 100 + 10 * i, 0.0) for i in range(9)]
         + [(NOW - 10, 20.0), (NOW, 60.0)]),
        ("tpuml_http_route_p99_seconds", {"route": "train"}, [(NOW - 1, 3.0)]),
        ("tpuml_http_route_p99_seconds", {"route": "next_tasks"}, [(NOW - 1, 9.0)]),
        ("tpuml_sse_lag_seconds", {}, [(NOW - 1, 1.0)]),
        ("tpuml_worker_breaker_state", {"wid": "w1"}, [(NOW - 1, 1.0)]),
        ("tpuml_stage_cache_overflow_total", {}, [(NOW - 200, 0.0), (NOW - 5, 1.0)]),
    ]
    st = _series_store(ts_mod, series)
    eng = slo.AlertEngine(slo.default_rules(cfg), interval_s=0.0)
    eng._store = st
    states = []
    for dt, extra in ((0, None), (11, ("tpuml_http_route_p99_seconds", {"route": "train"}, 0.5)),
                      (30, ("tpuml_worker_breaker_state", {"wid": "w1"}, 0.0)), (400, None)):
        if extra is not None:
            st._append(extra[0], extra[1], NOW + dt - 1, extra[2])
        eng.evaluate(now=NOW + dt, force=True)
        snap = eng.snapshot()
        states.append(sorted((a["rule"], a["state"]) for a in snap["alerts"]))
        states.append(eng.firing())
    return states


def test_alert_engine_fires_the_same_alerts():
    got = _alert_run(tslo, tts, tcfg)
    assert got == _alert_run(jslo, jts, jcfg)
    assert "admission_reject_rate" in got[1] and "route_p99_slo" not in got[1]


def _stub_coord(cfg, jobs, pending, workers):
    engine = SimpleNamespace(
        worker_snapshot=lambda: workers,
        total_devices=lambda: sum(int(w.get("n_devices") or 1) for w in workers.values()))
    return SimpleNamespace(
        config=cfg, n_shards=1, shard_id=None, cluster=SimpleNamespace(engine=engine),
        store=SimpleNamespace(unfinished_counts=lambda: {
            "jobs": jobs, "per_session": {}, "pending_subtasks": pending}))


def _signals_run(sig_mod, cfg_mod, monkeypatch):
    cfg = cfg_mod.FrameworkConfig.load(env={})
    cfg.service.autoscale_horizon_s = 10.0
    cfg.service.autoscale_downscale_hold_s = 30.0
    cfg.service.max_inflight_jobs = 4
    script = [  # (jobs, pending, per-worker (depth, load), p99, reject rate)
        (1, 12, [(4, 40.0), (4, 40.0), (4, 40.0)], 0.1, 0.0),
        (4, 3, [(1, 5.0), (1, 5.0), (1, 5.0)], 2.5, 0.5),
        (0, 0, [(0, 0.0), (0, 0.0), (0, 0.0)], 0.0, 0.0),
        (0, 0, [(0, 0.0), (0, 0.0), (0, 0.0)], 0.0, 0.0),
    ]
    state = {}
    monkeypatch.setattr(sig_mod, "_route_p99_worst", lambda now, max_age_s=120.0: state["p99"])
    monkeypatch.setattr(sig_mod, "windowed_rate", lambda *a, **k: state["rate"])
    out = []
    sig = None
    for i, (jobs, pending, ws, p99, rate) in enumerate(script):
        workers = {f"w{k}": {"queue_depth": d, "load_seconds": ld, "n_devices": 1}
                   for k, (d, ld) in enumerate(ws)}
        state.update(p99=p99, rate=rate)
        coord = _stub_coord(cfg, jobs, pending, workers)
        if sig is None:
            sig = sig_mod.CapacitySignals(coord)
        sig._coord = coord
        rep = sig.evaluate(now=NOW + 40 * i, force=True)
        out.append({k: v for k, v in rep.items() if k != "ts"})
    return out


def test_capacity_signals_match_jax(monkeypatch):
    got = _signals_run(tsignals, tcfg, monkeypatch)
    assert got == _signals_run(jsignals, jcfg, monkeypatch)
    assert got[0]["desired_workers"] == 12 and got[1]["signals"]["pressure"] is True
    assert got[2]["hysteresis"]["scale_down_held"] is True


# ---------------- the device profiler ----------------


def test_profile_round_trip_on_the_cpu():
    prof = tdevprof.DeviceProfiler()
    before = tobs.REGISTRY.counter("tpuml_profile_captures_total").value()
    seq = tobs.RECORDER.last_seq()
    out = prof.start("round-trip")
    assert out["status"] == "started" and prof.status()["active"] is True
    assert out["trace_dir"].endswith(os.path.join("profile", "round-trip"))
    x = torch.randn(64, 64)
    (x @ x).sum().item()
    busy = prof.start("second")
    assert (busy["status"], busy["reason"], busy["tag"]) == ("error", "busy", "round-trip")
    done = prof.stop()
    assert done["status"] == "stopped" and done["n_files"] >= 1 and done["duration_s"] >= 0
    trace = json.load(open(os.path.join(done["trace_dir"], tdevprof.TRACE_FILE)))
    assert "traceEvents" in trace
    assert prof.status() == {"active": False}
    assert prof.stop()["reason"] == "idle"
    assert tobs.REGISTRY.counter("tpuml_profile_captures_total").value() == before + 1
    kinds = [e["kind"] for e in tobs.RECORDER.events(since=seq)[0]]
    assert "profile.start" in kinds and "profile.stop" in kinds


def test_profile_refuses_a_foreign_session_as_backend():
    from torch.profiler import ProfilerActivity, profile

    prof = tdevprof.DeviceProfiler()
    with profile(activities=[ProfilerActivity.CPU]):
        out = prof.start("clash")
    assert (out["status"], out["reason"]) == ("error", "backend")
    assert "already running" in out["message"] and prof.status() == {"active": False}


def test_profile_disabled_valve(monkeypatch):
    monkeypatch.setenv("CS230_OBS", "0")
    got = {m.__name__.split(".")[0]: m.DeviceProfiler().start("x")
           for m in (tdevprof, jdevprof)}
    assert [v["reason"] for v in got.values()] == ["disabled", "disabled"]


@pytest.mark.parametrize("tag", ["../../etc", "ok-tag_1.2", "..", "a/b\\c", "", None,
                                 "spaces and *"])
def test_profile_tags_sanitized_like_jax(tag):
    assert tdevprof._sanitize_tag(tag) == jdevprof._sanitize_tag(tag)


def test_device_seconds_phases_match_jax():
    assert tdevprof.PHASES == jdevprof.PHASES
    deltas = {}
    for name, mod in (("torch", tdevprof), ("jax", jdevprof)):
        before = mod.phase_totals()
        mod.record_batch_device_seconds(0.5, 0.25, 2.0, 0.75)
        mod.device_seconds("stream", 0.125)
        mod.device_seconds("stream", -1.0)
        after = mod.phase_totals()
        deltas[name] = {p: round(after[p] - before[p], 9) for p in mod.PHASES}
    assert deltas["torch"] == deltas["jax"] == {
        "stage": 0.25, "compile": 0.5, "dispatch": 1.25, "fetch": 0.75, "stream": 0.125}


# ---------------- FLOPs and device memory ----------------


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.4e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA H100 NVL", 835e12),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_h100_peaks(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert tflops.device_peak_flops() == peak
    if peak is not None:
        assert tflops.mfu(peak, 2.0) == pytest.approx(0.5)


def test_flops_helpers_on_the_cpu():
    assert tflops.device_peak_flops() is None and tflops.mfu(1e12, 1.0) is None
    assert tflops.device_memory_stats() == {}
    kernel = SimpleNamespace(macs_estimate=lambda n, d, static: n * d * 3)
    assert tflops.analytical_flops(kernel, {}, 10, 4, 3, 5) == \
        jflops.analytical_flops(kernel, {}, 10, 4, 3, 5) == 2.0 * 120 * 15
    assert tflops.analytical_flops(object(), {}, 10, 4, 3, 5) is None
    pop = list(range(37))
    assert tflops.stratified_by(pop, lambda v: -v, 5) == jflops.stratified_by(pop, lambda v: -v, 5)
