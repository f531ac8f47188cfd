"""The port's observability routes and trace propagation against the JAX
package's, on the CPU.

One traced job (``X-Trace-Id``) runs on each package's coordinator over a
cluster with one in-process executor; then every observability route
(``/metrics/prom``, ``/dashboard``, ``/profile/*``, ``/trace``, its export,
``/critical_path``, ``/trace_spans``, ``/cost``, ``/explain``, ``/events``,
``/alerts``, ``/autoscale``, ``/metrics/history``) is asked the same
question on both servers, the JAX one through werkzeug's test client and
the port's through ``App.handle``: the status codes and the JSON key sets
must be equal. Then the port's server on a socket with a worker agent
thread and ``MLTaskManager(url=...)``: the manager's ``X-Trace-Id`` comes
back in ``/trace/<jid>`` with the agent's shipped ``agent.poll`` and
``executor.batch`` spans, the REST ``explain`` / ``critical_path`` work,
and a ``/profile/start`` -> ``/profile/stop`` capture lands its trace.
"""

import json
import os
import time

import pytest
import torch
from werkzeug.test import Client

from cs230_distributed_machine_learning_tpu.runtime import cluster as jcluster
from cs230_distributed_machine_learning_tpu.runtime import coordinator as jcoord
from cs230_distributed_machine_learning_tpu.runtime import server as jserver
from cs230_distributed_machine_learning_tpu.utils import config as jcfg
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch import obs as tobs
from cs230_distributed_machine_learning_tpu_torch.runtime import cluster as tcluster
from cs230_distributed_machine_learning_tpu_torch.runtime import coordinator as tcoord
from cs230_distributed_machine_learning_tpu_torch.runtime import server as tserver
from cs230_distributed_machine_learning_tpu_torch.runtime.agent import WorkerAgent
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils import http

torch.set_num_threads(1)

TRACE = "feedfacecafe0001"
SEARCH = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
          "base_estimator_params": {"max_iter": 100},
          "param_grid": {"C": [0.1, 1.0]}, "cv_params": {"cv": 3}}


class JaxSide:
    def __init__(self):
        self.cluster = jcluster.ClusterRuntime()
        self.cluster.add_executor()
        self.coord = jcoord.Coordinator(cluster=self.cluster)
        self.client = Client(jserver.create_app(self.coord))

    def call(self, method, path, query=None, body=None, headers=None):
        kw = {"query_string": query or {}, "headers": headers or {}}
        if body is not None:
            kw["json"] = body
        resp = self.client.open(path, method=method, **kw)
        return (resp.status_code, {k.lower(): v for k, v in resp.headers.items()},
                resp.get_data())


class TorchSide:
    def __init__(self):
        self.cluster = tcluster.ClusterRuntime()
        self.cluster.add_executor(device="cpu")
        self.coord = tcoord.Coordinator(device="cpu", cluster=self.cluster)
        self.app = tserver.create_app(self.coord)

    def call(self, method, path, query=None, body=None, headers=None):
        raw = json.dumps(body).encode() if body is not None else b""
        status, hdrs, chunks = self.app.handle(
            method, path, query or {}, {"Content-Type": "application/json", **(headers or {})},
            raw)
        return status, {k.lower(): v for k, v in hdrs}, b"".join(chunks)


def _configure(root):
    for mod, sub in ((tcfg, "tpuml_torch"), (jcfg, "tpuml_jax")):
        cfg = mod.FrameworkConfig.load(env={})
        cfg.storage.root = os.path.join(root, sub)
        cfg.service.sse_tick_s = 0.05
        cfg.scheduler.heartbeat_interval_s = 0.05
        cfg.scheduler.sweep_interval_s = 0.1
        mod.set_config(cfg)


def _run_traced_job(side):
    _, _, raw = side.call("POST", "/create_session", body={})
    sid = json.loads(raw)["session_id"]
    payload = {"job_id": "job-a", "dataset_id": "iris", "model_details": SEARCH,
               "train_params": {"test_size": 0.2}}
    status, headers, _ = side.call("POST", f"/train/{sid}", body=payload,
                                   headers={"X-Trace-Id": TRACE})
    assert status == 200 and headers["x-trace-id"] == TRACE
    assert side.coord.store.wait_job(sid, "job-a", timeout=120)
    side.coord._job_threads["job-a"].join(timeout=30)
    return sid


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    _configure(str(tmp_path_factory.mktemp("trace_rest")))
    out = {}
    try:
        for name, cls in (("jax", JaxSide), ("torch", TorchSide)):
            side = cls()
            out[name] = side
            sid = _run_traced_job(side)
            side.stid = sorted(side.coord.store.get_job(sid, "job-a")["subtasks"])[0]
        yield out
    finally:
        for side in out.values():
            side.cluster.shutdown()
        tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _keys(raw):
    body = json.loads(raw)
    return sorted(body) if isinstance(body, dict) else type(body).__name__


ROUTES = {  # case: (method, path, query, body)
    "profile_status": ("GET", "/profile/status", None, None),
    "profile_stop_idle": ("POST", "/profile/stop", None, None),
    "trace": ("GET", "/trace/job-a", None, None),
    "trace_unknown": ("GET", "/trace/nope", None, None),
    "export_perfetto": ("GET", "/trace/job-a/export", None, None),
    "export_otlp": ("GET", "/trace/job-a/export", {"format": "otlp"}, None),
    "export_bad_format": ("GET", "/trace/job-a/export", {"format": "jaeger"}, None),
    "export_unknown": ("GET", "/trace/nope/export", None, None),
    "critical_path": ("GET", "/critical_path/job-a", None, None),
    "critical_path_compare": ("GET", "/critical_path/job-a", {"compare": "job-a"}, None),
    "critical_path_bad_baseline": ("GET", "/critical_path/job-a", {"compare": "nope"}, None),
    "critical_path_unknown": ("GET", "/critical_path/nope", None, None),
    "trace_spans": ("POST", "/trace_spans/w9", None, {"spans": [
        {"trace_id": "0000aaaa", "span_id": "s1", "name": "agent.poll", "start": 1.0,
         "end": 2.0, "attrs": {}}, {"bad": 1}]}),
    "cost": ("GET", "/cost/job-a", None, None),
    "cost_unknown": ("GET", "/cost/nope", None, None),
    "explain_job": ("GET", "/explain/job-a", None, None),
    "explain_unknown_job": ("GET", "/explain/nope", None, None),
    "explain_unknown_subtask": ("GET", "/explain/job-a/nope", None, None),
    "events": ("GET", "/events", None, None),
    "events_cursor": ("GET", "/events", {"since": "1", "limit": "2"}, None),
    "events_bad_args": ("GET", "/events", {"since": "x", "limit": "y"}, None),
    "alerts": ("GET", "/alerts", {"force": "1"}, None),
    "autoscale": ("GET", "/autoscale", None, None),
    "history_names": ("GET", "/metrics/history", None, None),
    "history_series": ("GET", "/metrics/history",
                       {"name": "tpuml_jobs_submitted_total", "since": "bad"}, None),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_matches_jax(sides, case):
    method, path, query, body = ROUTES[case]
    got = {name: side.call(method, path, query, body) for name, side in sides.items()}
    (ts, th, tb), (js, jh, jb) = got["torch"], got["jax"]
    assert ts == js, (case, ts, js, tb[:200])
    assert th["content-type"].split(";")[0] == jh["content-type"].split(";")[0]
    assert _keys(tb) == _keys(jb)


def test_explain_subtask_matches_jax(sides):
    got = {}
    for name, side in sides.items():
        status, _, raw = side.call("GET", f"/explain/job-a/{side.stid}")
        body = json.loads(raw)
        # a late copy of a result is dropped as ``result.duplicate`` where
        # a bus delivers it twice (the JAX coordinator republishes its
        # ingest): timing, not the timeline's decisions
        got[name] = (status, sorted(body),
                     [e["kind"] for e in body["events"] if e["kind"] != "result.duplicate"])
    assert got["torch"] == got["jax"]


def test_traced_job_span_names_match_jax(sides):
    names = {}
    for name, side in sides.items():
        status, headers, raw = side.call("GET", "/trace/job-a", headers={"X-Trace-Id": "x1"})
        body = json.loads(raw)
        assert body["trace_id"] == TRACE and headers["x-trace-id"] == "x1"
        names[name] = sorted({s["name"] for s in body["spans"]})
    assert names["torch"] == names["jax"]
    assert {"http.train", "job.submit", "schedule.place", "executor.batch",
            "executor.dispatch", "job.aggregate"} <= set(names["torch"])


@pytest.mark.parametrize("path,kind", [("/metrics/prom", "text/plain"),
                                       ("/dashboard", "text/html")])
def test_text_routes_match_jax(sides, path, kind):
    for side in sides.values():
        status, headers, raw = side.call("GET", path)
        assert status == 200 and headers["content-type"].startswith(kind) and raw
    _, _, prom = sides["torch"].call("GET", "/metrics/prom")
    text = prom.decode()
    assert 'tpuml_http_request_seconds_count{code="200",method="POST",route="train"}' in text
    assert "tpuml_executor_device_seconds_total" in text


def test_profile_routes_on_the_port(sides):
    side = sides["torch"]
    status, _, raw = side.call("POST", "/profile/start", body={"tag": "../rest"})
    assert status == 201 and json.loads(raw)["tag"] == "rest"
    status, _, raw = side.call("POST", "/profile/start", body={"tag": "again"})
    assert status == 409 and json.loads(raw)["reason"] == "busy"
    assert json.loads(side.call("GET", "/profile/status")[2])["active"] is True
    status, _, raw = side.call("POST", "/profile/stop")
    out = json.loads(raw)
    assert status == 200 and out["n_files"] >= 1
    assert os.path.isfile(os.path.join(out["trace_dir"], "trace.json"))


def test_trace_id_round_trip_through_an_agent(tmp_path):
    """MLTaskManager(url=...) -> the port's server on a socket -> a worker
    agent thread: one trace id, the agent's spans shipped over
    POST /trace_spans."""
    _configure(str(tmp_path))
    cluster = tcluster.ClusterRuntime()
    coord = tcoord.Coordinator(device="cpu", cluster=cluster)
    server, thread = tserver.start_server(coord)
    agent = None
    try:
        agent = WorkerAgent(server.url, device="cpu", poll_timeout_s=0.5,
                            register_backoff_s=0.1)
        agent.start()
        ingested = tobs.REGISTRY.counter("tpuml_trace_spans_ingested_total").value()
        m = TorchManager(url=server.url)
        status = m.train(dict(SEARCH), "iris", show_progress=False, timeout=120)
        assert status["job_status"] == "completed" and m.trace_id
        required = {"http.train", "job.submit", "job.expand", "schedule.place",
                    "job.execute", "agent.poll", "executor.batch", "executor.compile",
                    "executor.stage", "executor.dispatch", "executor.fetch", "job.aggregate"}
        deadline, body = time.time() + 15, {}
        while time.time() < deadline:
            body = http.request("GET", f"{server.url}/trace/{m.job_id}").json()
            if required <= {s["name"] for s in body["spans"]}:
                break
            time.sleep(0.1)
        assert required <= {s["name"] for s in body["spans"]}
        assert body["trace_id"] == m.trace_id
        assert all(s["trace_id"] == m.trace_id for s in body["spans"])
        assert tobs.REGISTRY.counter("tpuml_trace_spans_ingested_total").value() > ingested
        batch = next(s for s in body["spans"] if s["name"] == "executor.batch")
        assert batch["attrs"]["worker"] == agent.worker_id and batch["attrs"]["model_flops"] > 0
        report = m.critical_path()
        assert abs(sum(s["duration_s"] for s in report["segments"]) - report["wall_s"]) <= 1e-6
        stid = status["job_result"]["results"][0]["subtask_id"]
        kinds = [e["kind"] for e in m.explain(subtask_id=stid)["events"]]
        assert "placement" in kinds and "result" in kinds
        with pytest.raises(KeyError):
            m.explain(subtask_id="nope")
        with pytest.raises(KeyError):
            m.critical_path(job_id="nope")
        cost = http.request("GET", f"{server.url}/cost/{m.job_id}").json()
        assert cost["n_groups"] >= 1 and cost["model_flops"] > 0
    finally:
        if agent is not None:
            agent.stop()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        cluster.shutdown()
        tcfg.set_config(tcfg.FrameworkConfig.load(env={}))
    assert not thread.is_alive()
