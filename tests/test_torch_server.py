"""The port's REST routes (runtime/server.py on the standard library)
against the JAX package's werkzeug server, on the CPU.

One request sequence goes to both: the JAX app through werkzeug's test
``Client``, the port's through ``App.handle`` (no socket). Every reply's
status code, JSON keys (nested where the bodies are the same structure;
the per-batch ``batch_cost``, whose carrier depends on the batching, left
out) and CORS headers
are equal, including the errors (404 unknown path,
unknown session or job, 400 bad input, 405 wrong method), admission's 429
and the recovering 503 with ``Retry-After``, the OPTIONS preflight, the
SSE framing of ``/train_status`` (the 2 KB comment prologue, ``data:``
events, the terminal event's ``job_result``), ``/download_model``'s
octet-stream, and ``/dataset``'s CSV, equal to the byte. Then the port's
server on a real socket: the same route through ``urllib``, and the
REST manager's client-side refusals.
"""

import json

import pytest
import torch
from werkzeug.test import Client

from cs230_distributed_machine_learning_tpu.runtime import cluster as jcluster
from cs230_distributed_machine_learning_tpu.runtime import coordinator as jcoord
from cs230_distributed_machine_learning_tpu.runtime import server as jserver
from cs230_distributed_machine_learning_tpu.utils import config as jcfg
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.runtime import cluster as tcluster
from cs230_distributed_machine_learning_tpu_torch.runtime import coordinator as tcoord
from cs230_distributed_machine_learning_tpu_torch.runtime import server as tserver
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

CORS = {"access-control-allow-origin": "*",
        "access-control-allow-headers": "Content-Type, Authorization",
        "access-control-allow-methods": "GET, POST, OPTIONS"}

TITANIC = {
    "impute": {"Age": "median", "Embarked": "mode"},
    "drop_columns": ["Cabin", "Ticket", "Name", "PassengerId"],
    "categorical": [{"Sex": "onehot"}, {"Embarked": "onehot"}],
    "target_column": "Survived",
}


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path, monkeypatch):
    monkeypatch.setenv("CS230_PREWARM", "0")  # the JAX /subscribe's hints: not ported
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    for c in (tcfg.get_config(), jcfg.get_config()):
        c.service.sse_tick_s = 0.05
        c.scheduler.heartbeat_interval_s = 0.05
        c.scheduler.sweep_interval_s = 0.1
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


class JaxSide:
    def __init__(self):
        self.cluster = jcluster.ClusterRuntime()
        self.cluster.add_executor()
        self.coord = jcoord.Coordinator(cluster=self.cluster)
        self.client = Client(jserver.create_app(self.coord))

    def call(self, method, path, query=None, body=None):
        kw = {"query_string": query or {}}
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

    def call(self, method, path, query=None, body=None):
        raw = json.dumps(body).encode() if body is not None else b""
        status, headers, chunks = self.app.handle(
            method, path, query or {}, {"Content-Type": "application/json"}, raw)
        return status, {k.lower(): v for k, v in headers}, b"".join(chunks)


#: result fields left out of the shape comparison: the per-batch
#: ``batch_cost`` rides the first result of each executor batch, and how
#: an in-process worker batches the subtasks it pulls depends on timing
NOT_PORTED_FIELDS = {"batch_cost"}


def _shape(value):
    """The structure of a JSON value: dict keys (recursively), list element
    shapes, scalar types collapsed."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items() if k not in NOT_PORTED_FIELDS}
    if isinstance(value, list):
        return [_shape(v) for v in value[:1]]
    return None


def _keys(value):
    return sorted(value) if isinstance(value, dict) else type(value).__name__


def _sse(body):
    text = body.decode()
    prologue, _, rest = text.partition("\n\n")
    events = [json.loads(block[len("data: "):]) for block in rest.split("\n\n") if block]
    return prologue, events


def _sequence(side, search_payload):
    """The request sequence; returns {step: (status, comparable, headers)}."""
    out = {}

    def rec(step, method, path, query=None, body=None, compare=_keys):
        status, headers, raw = side.call(method, path, query, body)
        data = raw
        if headers.get("content-type", "").startswith("application/json"):
            data = compare(json.loads(raw))
        out[step] = (status, data, {k: headers.get(k) for k in CORS})
        return json.loads(raw) if headers.get("content-type", "").startswith(
            "application/json") else raw

    rec("home", "GET", "/")
    rec("health", "GET", "/health")
    status, headers, _ = side.call("OPTIONS", "/train/anything")
    out["preflight"] = (status, None, {k: headers.get(k) for k in CORS})
    sid = rec("session", "POST", "/create_session", body={"priority": 1})["session_id"]
    rec("session_bad_priority", "POST", "/create_session", body={"priority": "high"})
    rec("check_data", "GET", f"/check_data/{sid}", {"dataset_name": "iris"})
    rec("check_data_no_arg", "GET", f"/check_data/{sid}")
    rec("check_data_bad_session", "GET", "/check_data/nope", {"dataset_name": "iris"})
    rec("download_data", "POST", f"/download_data/{sid}",
        body={"dataset_url": "", "dataset_name": "titanic", "dataset_type": "builtin"})
    pre = rec("preprocess", "POST", f"/preprocess/{sid}",
              body={"dataset_id": "titanic", "config": TITANIC})
    out["preprocess_rows"] = pre["n_rows"]
    payload = {"job_id": "job-a", "dataset_id": "iris", "model_details": search_payload,
               "train_params": {"test_size": 0.2}}
    rec("train", "POST", f"/train/{sid}", body=payload)
    assert side.coord.store.wait_job(sid, "job-a", timeout=120)
    rec("train_duplicate", "POST", f"/train/{sid}", body=payload)
    status, headers, raw = side.call("POST", f"/train_status/{sid}", body=payload)
    prologue, events = _sse(raw)
    out["train_status"] = (status, headers["content-type"].split(";")[0], prologue,
                           _keys(events[-1]), _shape(events[-1]["job_result"]["best_result"]),
                           events[-1]["job_status"], {k: headers.get(k) for k in CORS})
    rec("check_status", "GET", f"/check_status/{sid}/job-a", compare=_shape)
    rec("check_status_unknown", "GET", f"/check_status/{sid}/nope")
    rec("metrics", "GET", f"/metrics/{sid}/job-a", {"wait": "1"}, compare=len)
    status, headers, raw = side.call("GET", f"/download_model/{sid}/job-a")
    out["download_model"] = (status, headers["content-type"],
                             headers["content-disposition"], raw[:2] == b"\x80\x04")
    rec("download_model_unknown", "GET", f"/download_model/{sid}/nope")
    rec("workers", "GET", "/workers", compare=_shape)
    rec("queues", "GET", "/queues", compare=_shape)
    rec("supervisor", "GET", "/supervisor", compare=_shape)
    rec("jobs", "GET", "/jobs", compare=_shape)
    rec("healthz", "GET", "/healthz", compare=lambda b: {k: _keys(v) for k, v in b.items()})
    rec("livez", "GET", "/livez", compare=_shape)
    rec("readyz", "GET", "/readyz", compare=_shape)
    curves = rec("curves", "GET", "/curves/job-a", compare=lambda b: (_keys(b),
                                                                         b["n_curves"]))
    stid = sorted(side.coord.store.get_job(sid, "job-a")["subtasks"])[0]
    rec("curves_subtask", "GET", f"/curves/job-a/{stid}", compare=_keys)
    rec("curves_unknown", "GET", "/curves/nope")
    out["curves_n"] = curves["n_curves"]
    rec("calibration", "GET", "/predictor/calibration",
        compare=lambda b: (_keys(b), sorted(b["families"])))
    wid = rec("subscribe", "POST", "/subscribe", body={"mem_capacity_mb": 500.0})["worker_id"]
    rec("subscribe_bad", "POST", "/subscribe", body={"n_devices": "two"})
    rec("heartbeat", "POST", f"/heartbeat/{wid}", compare=_shape)
    rec("heartbeat_unknown", "POST", "/heartbeat/nope", compare=_shape)
    rec("next_tasks", "GET", f"/next_tasks/{wid}", {"max": "4", "timeout": "0.05"},
        compare=_shape)
    rec("next_tasks_unknown", "GET", "/next_tasks/nope", {"timeout": "0.05"})
    rec("task_result", "POST", f"/task_result/{wid}",
        body={"subtask_id": "zz", "status": "completed", "attempt": 0}, compare=_shape)
    rec("task_metrics", "POST", f"/task_metrics/{wid}",
        body={"subtask_id": "zz", "status": "DONE"}, compare=_shape)
    rec("unsubscribe", "POST", f"/unsubscribe/{wid}", compare=_shape)
    rec("dataset_probe", "GET", "/dataset/iris", {"probe": "1"}, compare=_shape)
    status, headers, raw = side.call("GET", "/dataset/iris")
    out["dataset"] = (status, headers["content-type"].split(";")[0],
                      headers["x-dataset-kind"], headers["content-disposition"], raw)
    rec("dataset_unknown", "GET", "/dataset/nope")
    rec("not_found", "GET", "/no/such/route")
    rec("wrong_method", "POST", "/health")
    # admission: the queue-depth watermark, then a recovering coordinator
    svc = side.coord.config.service
    side.coord.store.create_job(sid, "parked", {"dataset_id": "iris"},
                                [{"subtask_id": "p0"}, {"subtask_id": "p1"}])
    svc.admission_queue_watermark, watermark = 2, svc.admission_queue_watermark
    status, headers, raw = side.call("POST", f"/train/{sid}", body={**payload, "job_id": "b"})
    out["admission_429"] = (status, json.loads(raw), headers.get("retry-after"))
    svc.admission_queue_watermark = watermark
    side.coord.ready = False
    status, headers, raw = side.call("POST", f"/train/{sid}", body={**payload, "job_id": "c"})
    out["recovering_503"] = (status, json.loads(raw), headers.get("retry-after"))
    out["readyz_503"] = side.call("GET", "/readyz")[0]
    side.coord.ready = True
    return out


def test_every_ported_route_matches_the_jax_server():
    search = {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
              "base_estimator_params": {"max_iter": 100},
              "param_grid": {"C": [0.1, 1.0]}, "cv_params": {"cv": 3}}
    got = {}
    for name, side_cls in (("jax", JaxSide), ("torch", TorchSide)):
        side = side_cls()
        try:
            got[name] = _sequence(side, search)
        finally:
            side.cluster.shutdown()
    jax_out, torch_out = got["jax"], got["torch"]
    assert torch_out.keys() == jax_out.keys()
    for step in jax_out:
        if step == "home":  # the port lists only the routes it has
            assert torch_out[step][0] == jax_out[step][0] == 200
            assert torch_out[step][1] == jax_out[step][1] == ["endpoints", "service"]
            continue
        assert torch_out[step] == jax_out[step], step
    assert torch_out["preflight"] == (204, None, CORS)
    assert torch_out["admission_429"][0] == 429 and torch_out["recovering_503"][0] == 503
    assert torch_out["train_status"][2] == ":" + " " * 2048
    assert torch_out["train_status"][5] == "completed" and torch_out["curves_n"] == 2
    assert torch_out["dataset"][4].startswith(b"sepal length (cm)")


def test_home_lists_only_routes_the_port_serves():
    side = TorchSide()
    try:
        status, _, raw = side.call("GET", "/")
        for line in json.loads(raw)["endpoints"]:
            method, path = line.split()[:2]
            path = path.split("?")[0].split("[")[0]
            for name in ("session_id", "job_id", "subtask_id", "worker_id", "dataset_id"):
                path = path.replace(f"<{name}>", "x")
            endpoint, _ = side.app.match(method, path)
            assert endpoint
    finally:
        side.cluster.shutdown()


def test_the_port_server_answers_over_a_socket():
    """The same routes through ``http.server`` on port 0, read with the
    port's ``urllib`` client; the server thread is joined at the end."""
    from cs230_distributed_machine_learning_tpu_torch.utils import http

    coord = tcoord.Coordinator(device="cpu")
    server, thread = tserver.start_server(coord)
    try:
        resp = http.request("GET", f"{server.url}/health")
        assert resp.status == 200 and resp.json() == {"status": "ok"}
        assert resp.headers["Access-Control-Allow-Origin"] == "*"
        sid = http.request("POST", f"{server.url}/create_session").json()["session_id"]
        assert coord.store.has_session(sid)
        assert http.request("POST", f"{server.url}/subscribe").status == 400  # no cluster
        assert http.request("GET", f"{server.url}/dataset/iris", params={"probe": 1}).status \
            == 404  # nothing staged yet
        resp = http.request("OPTIONS", f"{server.url}/train/{sid}")
        assert resp.status == 204 and resp.headers["Access-Control-Allow-Methods"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


def test_rest_manager_refuses_what_json_cannot_carry():
    """A scipy distribution (JSON would make it a string the server cannot
    sample) and a callable scorer are refused at the client, before any
    request."""
    from scipy.stats import loguniform

    from cs230_distributed_machine_learning_tpu_torch.client import manager as tmanager

    manager = TorchManager.__new__(TorchManager)
    manager.api_url, manager._coordinator = "http://127.0.0.1:9", None
    manager.session_id, manager.priority = "s", 0
    sent = []
    manager._request = lambda *a, **k: sent.append(a)
    details = {"model_type": "LogisticRegression", "search_type": "RandomizedSearchCV",
               "param_distributions": {"C": loguniform(1e-3, 1e2), "tol": [1e-4]},
               "n_iter": 2, "random_state": 0}
    with pytest.raises(ValueError, match=r"param_distributions\['C'\] is a distribution"):
        manager.train(details, "iris")
    with pytest.raises(ValueError, match="callable scoring"):
        manager.train({**details, "param_distributions": {"C": [1.0]},
                       "cv_params": {"scoring": lambda est, X, y: 0.0}}, "iris")
    assert sent == []
    grid = [{"C": [0.5], "tol": [1e-4]}, {"C": [2.0], "tol": [1e-3]}]
    tmanager._check_rest_payload({"param_grid": grid})  # lists cross as they are
