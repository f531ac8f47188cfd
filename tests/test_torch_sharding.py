"""The port's sharded control plane against the JAX package, on the CPU:
the id conventions (``runtime/sharding.py``), the front end's fleet
merges (``runtime/frontend.py``, rewritten on the standard library) byte
for byte against the JAX front end fed the same canned shard bodies
(tests/test_frontend_aggregation.py's cases), and one 2-shard
``ShardFleet`` + front-end job.

Fake shards are werkzeug servers on port 0 (test-side only); every HTTP
wait has a timeout.
"""

import json
import os
import threading
import uuid

import pytest
import torch
from werkzeug.serving import make_server
from werkzeug.test import Client
from werkzeug.wrappers import Request, Response

from cs230_distributed_machine_learning_tpu.runtime import frontend as jfe
from cs230_distributed_machine_learning_tpu.runtime import sharding as jsh
from cs230_distributed_machine_learning_tpu_torch.runtime import frontend as tfe
from cs230_distributed_machine_learning_tpu_torch.runtime import sharding as tsh
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


# ---------------- ids ----------------


def test_ids_match_jax_on_1000_ids():
    rng = uuid.UUID(int=15)
    ids = [str(uuid.uuid5(rng, str(i))) for i in range(1000)]
    for n in (1, 2, 3, 7, 100):
        assert [tsh.shard_of(s, n) for s in ids] == [jsh.shard_of(s, n) for s in ids]
    for i, s in enumerate(ids):
        k = i % 100
        stamped = tsh.stamp_job_id(k, s)
        assert stamped == jsh.stamp_job_id(k, s)
        assert tsh.id_shard(stamped) == jsh.id_shard(stamped) == k
        assert tsh.id_shard(s) is None and jsh.id_shard(s) is None
        # idempotent for its own stamp, wrapped again for a foreign one
        assert tsh.stamp_job_id(k, stamped) == stamped
        assert tsh.stamp_job_id((k + 1) % 100, stamped) == jsh.stamp_job_id((k + 1) % 100,
                                                                            stamped)
    assert tsh.worker_prefix(7) == jsh.worker_prefix(7) == "s07-"
    with pytest.raises(ValueError):
        tsh.stamp_job_id(100, "x")


def test_inject_shard_label_matches_jax():
    body = "\n".join(["# HELP tpuml_x things", "# TYPE tpuml_x counter", "tpuml_x 3",
                      'tpuml_y{route="train"} 1.5', 'tpuml_e{msg="q\\" {b} c",x="y"} 7 16',
                      ""])
    assert tfe._inject_shard_label(body, 2) == jfe._inject_shard_label(body, 2)


def test_shard_service_config_carves_like_jax():
    from cs230_distributed_machine_learning_tpu.utils.config import FrameworkConfig as JCfg

    for cap, n in ((10, 3), (1, 4), (0, 2)):
        t = tcfg.FrameworkConfig.load(env={}).merged(
            {"service": {"max_inflight_jobs": cap, "admission_queue_watermark": cap * 7}})
        j = JCfg.load(env={}).merged(
            {"service": {"max_inflight_jobs": cap, "admission_queue_watermark": cap * 7}})
        ts, js = tsh.shard_service_config(t, n).service, jsh.shard_service_config(j, n).service
        assert (ts.max_inflight_jobs, ts.admission_queue_watermark) == (
            js.max_inflight_jobs, js.admission_queue_watermark)


# ---------------- the front end's merges, byte for byte ----------------


def _fake_shard(handlers):
    @Request.application
    def app(request):
        h = handlers.get(request.path)
        if h is None:
            return Response(json.dumps({"status": "error", "message": "not found"}),
                            status=404, mimetype="application/json")
        out = h(request)
        if isinstance(out, Response):
            return out
        return Response(json.dumps(out), mimetype="application/json")

    srv = make_server("127.0.0.1", 0, app, threaded=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def _events_handler(events):
    def h(request):
        since = int(request.args.get("since", 0))
        limit = int(request.args.get("limit", 1000))
        evs = [dict(e) for e in events if e["seq"] > since][:limit]
        return {"events": evs, "n_events": len(evs),
                "last_seq": evs[-1]["seq"] if evs else since}

    return h


_PROM = [
    "\n".join(["# HELP tpuml_jobs_submitted_total jobs",
               "# TYPE tpuml_jobs_submitted_total counter", "tpuml_jobs_submitted_total 5",
               "# HELP tpuml_http_request_seconds latency",
               "# TYPE tpuml_http_request_seconds histogram",
               'tpuml_http_request_seconds_bucket{route="train",le="0.5"} 3',
               'tpuml_http_request_seconds_bucket{route="train",le="+Inf"} 4',
               'tpuml_http_request_seconds_count{route="train"} 4', ""]),
    "\n".join(["# HELP tpuml_jobs_submitted_total jobs",
               "# TYPE tpuml_jobs_submitted_total counter", "tpuml_jobs_submitted_total 7",
               'tpuml_weird{msg="a\\" b"} 1', ""]),
]


def _shard_handlers(k):
    events = [{"seq": i, "kind": f"k{k}.{i}", "ts": 100.0 * (k + 1) + i, "data": {}}
              for i in range(1, (8 if k == 0 else 6))]
    alerts = [{"rule": "admission_reject_rate", "state": "firing" if k == 0 else "ok",
               "value": 0.5 if k == 0 else 0.0, "severity": "page"},
              {"rule": "sse_lag", "state": "ok", "value": 0.0, "severity": "warn"}]
    return {
        "/events": _events_handler(events),
        "/metrics/prom": lambda r: Response(_PROM[k], mimetype="text/plain"),
        "/alerts": lambda r: {"status": "firing" if k == 0 else "ok", "alerts": alerts},
        "/autoscale": lambda r: {"desired_workers": 3 - 2 * k, "live_workers": 2 - k,
                                 "desired_shards": 2 + k,
                                 "signals": {"pressure": k == 0, "shard_pressure": 2.5 - 2 * k},
                                 "shard": k},
        "/metrics/history": lambda r: (
            {"names": [f"tpuml_{chr(97 + k)}", f"tpuml_{chr(98 + k)}"]}
            if not r.args.get("name") else {"name": r.args["name"], "series": [
                {"labels": {"route": "train"}, "samples": [[1.0 + k / 2, 2.0 + 2 * k]]}]}),
        "/jobs": lambda r: [{"job_id": f"s0{k}-j{i}", "created_at": 10.0 * i + k}
                            for i in range(3)],
        "/workers": lambda r: {f"s0{k}-worker-0": {"n_devices": 1 + k}},
        "/steal_candidates": lambda r: {"shard": k, "shard_pressure": 2.5 - 2 * k,
                                        "candidates": [{"subtask_id": f"t{k}",
                                                        "n_devices": 1}] if k == 0 else []},
        "/healthz": lambda r: {"status": "ok", "n_workers": 1 + k, "shard": k},
        "/readyz": lambda r: {"status": "ready"},
        "/health": lambda r: {"status": "ok"},
    }


@pytest.fixture(scope="module")
def fake_fleet():
    servers = [_fake_shard(_shard_handlers(k)) for k in range(2)]
    urls = [u for _, u in servers]
    yield {"jax": Client(jfe.create_frontend_app(urls)), "port": tfe.create_frontend_app(urls)}
    for srv, _ in servers:
        srv.shutdown()


def _port_get(app, path, query=""):
    status, headers, chunks = app.handle("GET", path, query, {}, b"")
    return status, b"".join(chunks)


CASES = [
    ("/events", ""), ("/events", "since=5"), ("/events", "limit=4"),
    ("/events", "since=" + json.dumps({"0": 3, "1": 4}, separators=(",", ":")) + "&limit=3"),
    ("/alerts", ""), ("/autoscale", ""), ("/metrics/history", ""),
    ("/metrics/history", "name=tpuml_b"), ("/jobs", ""), ("/workers", ""),
    ("/steal_candidates", ""), ("/readyz", ""), ("/health", ""),
]


@pytest.mark.parametrize("path,query", CASES)
def test_frontend_merges_match_jax_byte_for_byte(fake_fleet, path, query):
    ref = fake_fleet["jax"].get(path, query_string=query)
    status, body = _port_get(fake_fleet["port"], path, query)
    assert status == ref.status_code
    assert body == ref.get_data(), (body[:300], ref.get_data()[:300])


def test_frontend_prom_merge_matches_jax_on_shard_lines(fake_fleet):
    """One exposition with a shard label a series, metadata deduped; the
    shards' lines equal the JAX front end's (each front end appends its own
    registry under shard="frontend", which differs by package)."""
    ref = fake_fleet["jax"].get("/metrics/prom").get_data(as_text=True).splitlines()
    status, body = _port_get(fake_fleet["port"], "/metrics/prom")
    assert status == 200
    mine = body.decode().splitlines()
    shard_lines = lambda lines: [ln for ln in lines  # noqa: E731
                                 if 'shard="0"' in ln or 'shard="1"' in ln]
    assert shard_lines(mine) == shard_lines(ref)
    assert mine.count("# HELP tpuml_jobs_submitted_total jobs") == 1


def test_frontend_worker_and_job_routes(fake_fleet):
    app = fake_fleet["port"]
    status, body = _port_get(app, "/next_tasks/worker-9")
    assert status == 404 and b"no valid shard stamp" in body
    status = app.handle("POST", "/subscribe", "", {"Content-Type": "application/json"},
                        json.dumps({"shard": 5}).encode())[0]
    assert status == 400


# ---------------- a fleet of two shard processes ----------------


def test_shard_fleet_job_through_frontend(tmp_path):
    """Two shard processes (one CPU executor each) behind a front end: a
    session minted by the front end, a LogReg search through it whose job
    id wears its shard's stamp, the scores within 2e-3 of the JAX
    package's (best_params_ equal), ``/jobs`` through the front end and
    on the owning shard, and the winner's artifact."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import GridSearchCV

    from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.runtime.fleet import ShardFleet
    from cs230_distributed_machine_learning_tpu_torch.utils import http

    search = GridSearchCV(LogisticRegression(max_iter=60), {"C": [0.05, 1.0, 20.0]}, cv=3)
    ref = JaxManager().train(search, "iris", {"random_state": 42}, show_progress=False)
    fleet = ShardFleet(2, storage_root=str(tmp_path / "fleet"), device="cpu",
                       env={"OMP_NUM_THREADS": "1"})
    fleet.start(timeout_s=120)
    try:
        fe = fleet.frontend_urls[0]
        m = MLTaskManager(url=fe)
        home = tsh.shard_of(m.session_id, 2)
        st = m.train(search, "iris", {"random_state": 42}, timeout=120, show_progress=False)
        assert st["job_status"] == "completed"
        assert tsh.id_shard(m.job_id) == home
        by = lambda s: {json.dumps(r["search_params"], sort_keys=True): r["mean_cv_score"]  # noqa: E731
                        for r in s["job_result"]["results"]}
        got, want = by(st), by(ref)
        assert got.keys() == want.keys()
        assert all(abs(got[k] - want[k]) <= 2e-3 for k in want), (got, want)
        assert (st["job_result"]["best_result"]["search_params"]
                == ref["job_result"]["best_result"]["search_params"])
        merged = http.request("GET", f"{fe}/jobs", timeout=30).json()
        assert [j["job_id"] for j in merged] == [m.job_id]
        for k, url in enumerate(fleet.shard_urls):
            ids = [j["job_id"] for j in http.request("GET", f"{url}/jobs", timeout=30).json()]
            assert ids == ([m.job_id] if k == home else [])
        health = http.request("GET", f"{fe}/healthz", timeout=30).json()
        assert health["status"] == "ok" and health["n_shards"] == 2
        path = m.download_best_model(output_path=str(tmp_path / "best.pkl"))
        assert os.path.getsize(path) > 0
    finally:
        fleet.stop()
