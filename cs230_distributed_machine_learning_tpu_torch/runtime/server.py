"""Coordinator REST server on the standard library.

Port of the JAX package's ``runtime/server.py``: the same paths, methods,
status codes and JSON bodies, the allow-all CORS headers and OPTIONS
preflight, the same SSE framing on ``/train_status`` and the same
octet-stream body on ``/download_model``, the worker agents' control plane
(``/subscribe`` ... ``/task_metrics``) and the dataset route remote agents
fetch from. The JAX server is a werkzeug WSGI app; this one is a router of
its own behind ``http.server.ThreadingHTTPServer``, because the card's
machine has neither werkzeug nor requests.

``App.handle(method, path, query, headers, body) -> (status, headers,
body_iter)`` is the whole surface, callable without a socket (the tests
drive it as the JAX tests drive werkzeug's ``Client``); ``start_server``
serves it on a port in a background thread, ``serve`` / ``main`` in the
foreground. The observability routes (Prometheus exposition, profiles,
traces, cost, events, alerts, autoscale, history, the dashboard) and the
sharded control plane's routes (slices, migration, stealing, peers) are
not ported yet; ``/`` lists only the routes that exist.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.parse
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..obs import counter_inc, gauge_set, obs_enabled, observe
from ..utils.logging import get_logger
from ..utils.serialization import json_safe
from .coordinator import Coordinator

logger = get_logger("tpuml.server")

#: CORS parity with the reference master's flask-cors default (allow-all)
CORS_HEADERS = (
    ("Access-Control-Allow-Origin", "*"),
    ("Access-Control-Allow-Headers", "Content-Type, Authorization"),
    ("Access-Control-Allow-Methods", "GET, POST, OPTIONS"),
)

Headers = List[Tuple[str, str]]
Reply = Tuple[int, Headers, Iterable[bytes]]


class HTTPError(Exception):
    """A client error with its status, rendered like werkzeug's
    exceptions: ``"<code> <reason>: <description>"``."""

    def __init__(self, code: int, description: str):
        super().__init__(description)
        self.code = code
        self.description = description

    def __str__(self) -> str:
        return f"{self.code} {HTTPStatus(self.code).phrase}: {self.description}"


class Request:
    """One request as a handler sees it: the query arguments (first value
    of each) and the raw body."""

    def __init__(self, query, body: bytes):
        if isinstance(query, str):
            query = {k: v[0] for k, v in urllib.parse.parse_qs(query).items()}
        self.args: Dict[str, str] = dict(query or {})
        self.body = body or b""

    def arg(self, name: str) -> str:
        if name not in self.args:
            raise HTTPError(400, f"missing query argument {name!r}")
        return self.args[name]

    def json(self, silent: bool = False):
        """The body as JSON; an empty or malformed body (a client that died
        mid-request) is a 400 unless ``silent``."""
        try:
            return json.loads(self.body.decode())
        except ValueError:
            if silent:
                return None
            raise HTTPError(400, "Failed to decode JSON object")


def _json(data, status: int = 200, headers: Headers = ()) -> Reply:
    body = json.dumps(json_safe(data)).encode()
    return status, [("Content-Type", "application/json"), *headers], [body]


def _file_chunks(path: str, size: int = 1 << 20):
    with open(path, "rb") as f:
        while True:
            chunk = f.read(size)
            if not chunk:
                return
            yield chunk


class App:
    """The routes over one coordinator."""

    def __init__(self, coordinator: Coordinator):
        self.coord = coordinator
        #: (method, compiled path pattern, endpoint name)
        self._routes: List[Tuple[str, re.Pattern, str]] = []
        for method, pattern, endpoint in (
            ("GET", "/", "home"),
            ("GET", "/health", "health"),
            ("POST", "/create_session", "create_session"),
            ("POST", "/download_data/<sid>", "download_data"),
            ("GET", "/check_data/<sid>", "check_data"),
            ("POST", "/preprocess/<sid>", "preprocess"),
            ("POST", "/train/<sid>", "train"),
            ("POST", "/train_status/<sid>", "train_status"),
            ("GET", "/check_status/<sid>/<jid>", "check_status"),
            ("GET", "/metrics/<sid>/<jid>", "metrics"),
            ("GET", "/download_model/<sid>/<jid>", "download_model"),
            ("GET", "/workers", "workers"),
            ("GET", "/queues", "queues"),
            ("GET", "/supervisor", "supervisor"),
            ("GET", "/jobs", "jobs"),
            ("GET", "/healthz", "healthz"),
            ("GET", "/livez", "livez"),
            ("GET", "/readyz", "readyz"),
            ("GET", "/curves/<jid>", "curves_job"),
            ("GET", "/curves/<jid>/<stid>", "curves_subtask"),
            ("GET", "/predictor/calibration", "predictor_calibration"),
            ("POST", "/subscribe", "subscribe"),
            ("POST", "/unsubscribe/<wid>", "unsubscribe"),
            ("POST", "/heartbeat/<wid>", "heartbeat"),
            ("GET", "/next_tasks/<wid>", "next_tasks"),
            ("POST", "/task_result/<wid>", "task_result"),
            ("POST", "/task_metrics/<wid>", "task_metrics"),
            ("GET", "/dataset/<dataset_id>", "dataset"),
        ):
            regex = "^" + re.sub(r"<(\w+)>", r"(?P<\1>[^/]+)", pattern) + "$"
            self._routes.append((method, re.compile(regex), endpoint))

    # ---------------- dispatch ----------------

    def match(self, method: str, path: str) -> Tuple[str, Dict[str, str]]:
        """(endpoint, path values); HTTPError 404 for an unknown path, 405
        for a known path under another method."""
        allowed = False
        for m, regex, endpoint in self._routes:
            hit = regex.match(path)
            if hit is None:
                continue
            if m == method:
                return endpoint, {k: urllib.parse.unquote(v)
                                  for k, v in hit.groupdict().items()}
            allowed = True
        if allowed:
            raise HTTPError(405, "The method is not allowed for the requested URL.")
        raise HTTPError(404, "not found")

    def handle(self, method: str, path: str, query=None,
               headers: Optional[Dict[str, str]] = None, body: bytes = b"") -> Reply:
        """Serve one request: (status, headers, body chunks). No route reads
        a request header yet (the trace headers are not ported). Errors become
        JSON ``{"status": "error", "message": ...}``: 404 for an unknown
        path, a KeyError or a missing file; the HTTPError's own code; 500
        for anything else. Every reply carries the CORS headers."""
        method = method.upper()
        if method == "OPTIONS":
            return 204, list(CORS_HEADERS), []
        t0 = time.perf_counter()
        endpoint = None
        try:
            endpoint, values = self.match(method, path)
            counter_inc("tpuml_http_requests_total", endpoint=endpoint)
            status, hdrs, chunks = getattr(self, endpoint)(Request(query, body), **values)
        except HTTPError as e:
            if e.code == 404 and endpoint is None:
                status, hdrs, chunks = _json({"status": "error", "message": "not found"}, 404)
            else:
                status, hdrs, chunks = _json({"status": "error", "message": str(e)}, e.code)
        except (KeyError, FileNotFoundError) as e:
            status, hdrs, chunks = _json({"status": "error", "message": str(e)}, 404)
        except Exception as e:  # noqa: BLE001 — the request's boundary
            logger.exception("%s %s failed", method, path)
            status, hdrs, chunks = _json({"status": "error", "message": str(e)}, 500)
        observe("tpuml_http_request_seconds", time.perf_counter() - t0,
                route=endpoint or "unmatched", method=method, code=str(status))
        return status, [*hdrs, *CORS_HEADERS], chunks

    # ---------------- helpers ----------------

    def _cluster_or_400(self):
        if self.coord.cluster is None:
            raise HTTPError(400, "coordinator is not running a cluster")
        return self.coord.cluster

    @staticmethod
    def _priority_or_400(value, default=0):
        if value is None:
            return default
        try:
            return int(value)
        except (TypeError, ValueError):
            raise HTTPError(400, f"priority must be an integer, got {value!r}")

    def _admission_reject(self, sid) -> Optional[Reply]:
        """429 / 503 with Retry-After for a submit the coordinator must not
        accept; None when admitted."""
        rejection = self.coord.admission_check(sid)
        if rejection is None:
            return None
        return _json({"status": "rejected", "reason": rejection["reason"],
                      "retry_after_s": rejection["retry_after_s"]},
                     rejection["status"],
                     [("Retry-After", f"{rejection['retry_after_s']:g}")])

    def _slots(self) -> Optional[Dict[str, int]]:
        sup = self.coord.agent_supervisor
        if sup is None:
            return None
        slots = sup.status()
        return {"alive": sum(1 for s in slots if s["alive"]), "total": len(slots),
                "gave_up": sum(1 for s in slots if s["gave_up"])}

    # ---------------- the reference master's routes ----------------

    def home(self, request) -> Reply:
        return _json({
            "service": "tpuml-coordinator",
            "endpoints": [
                "POST /create_session",
                "POST /download_data/<session_id>",
                "GET  /check_data/<session_id>?dataset_name=",
                "POST /preprocess/<session_id>",
                "POST /train/<session_id>",
                "POST /train_status/<session_id>  (SSE)",
                "GET  /check_status/<session_id>/<job_id>",
                "GET  /metrics/<session_id>/<job_id>",
                "GET  /download_model/<session_id>/<job_id>",
                "GET  /workers",
                "GET  /queues",
                "GET  /supervisor",
                "GET  /jobs",
                "GET  /curves/<job_id>[/<subtask_id>]  (learning curves)",
                "GET  /predictor/calibration  (predicted-vs-actual stats)",
                "GET  /health",
                "GET  /healthz  (deep health: device, workers, stragglers)",
                "GET  /livez  (liveness probe)",
                "GET  /readyz  (readiness: 503 while recovering)",
                "POST /subscribe  (worker agents)",
                "POST /unsubscribe/<worker_id>",
                "POST /heartbeat/<worker_id>",
                "GET  /next_tasks/<worker_id>?max=&timeout=",
                "POST /task_result/<worker_id>",
                "POST /task_metrics/<worker_id>",
                "GET  /dataset/<dataset_id>[?probe=1]",
            ],
        })

    def health(self, request) -> Reply:
        out: Dict[str, Any] = {"status": "ok"}
        slots = self._slots()
        if slots is not None:
            out["agent_slots"] = slots
            if slots["total"] and slots["gave_up"] == slots["total"]:
                out["status"] = "degraded"  # every executor slot is down
        return _json(out)

    def create_session(self, request) -> Reply:
        body = request.json(silent=True) or {}
        # an unsharded coordinator always mints the session id itself
        sid = self.coord.create_session(priority=self._priority_or_400(body.get("priority")))
        return _json({"session_id": sid}, 201)

    def download_data(self, request, sid) -> Reply:
        body = request.json()
        return _json(self.coord.download_data(sid, body["dataset_url"], body["dataset_name"],
                                               body["dataset_type"]))

    def check_data(self, request, sid) -> Reply:
        return _json(self.coord.check_data(sid, request.arg("dataset_name")))

    def preprocess(self, request, sid) -> Reply:
        body = request.json()
        return _json(self.coord.preprocess(sid, body["dataset_id"], body.get("config")))

    def train(self, request, sid) -> Reply:
        reject = self._admission_reject(sid)
        if reject is not None:
            return reject
        body = request.json()
        if "priority" in body:
            body["priority"] = self._priority_or_400(body["priority"], None)
        return _json(self.coord.submit_train(sid, body))

    def train_status(self, request, sid) -> Reply:
        """Submit and stream: SSE progress events until the job ends. A
        resume (a known job id) is a read and bypasses admission."""
        body = request.json()
        known = bool(body.get("job_id") and self.coord.store.has_job(sid, body["job_id"]))
        if not known:
            reject = self._admission_reject(sid)
            if reject is not None:
                return reject
        if "priority" in body:
            body["priority"] = self._priority_or_400(body["priority"], None)
        job_id = self.coord.submit_train(sid, body)["job_id"]
        coord = self.coord

        def stream():
            # a 2 KB comment prologue (ignored by SSE parsers) overflows the
            # read buffers of common clients, so the first snapshot is
            # delivered at once
            yield (":" + " " * 2048 + "\n\n").encode()
            tick = coord.config.service.sse_tick_s
            prev = time.monotonic()
            for progress in coord.stream_status(sid, job_id):
                now = time.monotonic()
                gauge_set("tpuml_sse_lag_seconds", max(now - prev - tick, 0.0))
                prev = now
                yield f"data: {json.dumps(json_safe(progress))}\n\n".encode()

        return 200, [("Content-Type", "text/event-stream; charset=utf-8")], stream()

    def check_status(self, request, sid, jid) -> Reply:
        return _json(self.coord.check_status(sid, jid))

    def metrics(self, request, sid, jid) -> Reply:
        """Per-subtask results; ``?wait=1`` blocks until the job finalizes
        (the reference master's blocking /metrics)."""
        if request.args.get("wait"):
            timeout = float(request.args.get("timeout",
                                             self.coord.config.service.client_timeout_s))
            self.coord._require_session(sid)
            self.coord.store.wait_job(sid, jid, timeout)
        return _json(self.coord.job_metrics(sid, jid))

    def download_model(self, request, sid, jid) -> Reply:
        path = self.coord.best_model_path(sid, jid)
        if path is None:
            return _json({"status": "error", "message": "no model artifact"}, 404)
        with open(path, "rb") as f:
            payload = f.read()
        return 200, [("Content-Type", "application/octet-stream"),
                     ("Content-Disposition",
                      f"attachment; filename={jid}_best_model.pkl")], [payload]

    # ---------------- introspection ----------------

    def workers(self, request) -> Reply:
        cluster = self.coord.cluster
        return _json(cluster.engine.worker_snapshot() if cluster is not None else {})

    def queues(self, request) -> Reply:
        cluster = self.coord.cluster
        return _json(cluster.engine.queue_snapshot() if cluster is not None else {})

    def supervisor(self, request) -> Reply:
        sup = self.coord.agent_supervisor
        return _json(sup.status() if sup is not None else [])

    def jobs(self, request) -> Reply:
        return _json(self.coord.store.jobs_overview())

    def healthz(self, request) -> Reply:
        """Deep health: the coordinator's device and its memory, each
        worker's health (batch EWMA, heartbeat age, failure ratio, queue
        depth), the stragglers, readiness. Always 200; ``status`` says ok
        or degraded."""
        coord = self.coord
        out: Dict[str, Any] = {"status": "ok", "obs_enabled": obs_enabled(),
                               "ready": coord.ready}
        if coord.recovery:
            out["recovery"] = coord.recovery
        if not coord.ready:
            out["status"] = "degraded"
        try:
            out["device"] = _device_health(coord.device)
        except Exception as e:  # noqa: BLE001 — an unreachable device is the finding
            out["device"] = {"reachable": False, "error": str(e)}
            out["status"] = "degraded"
        if coord.cluster is not None:
            snap = coord.cluster.engine.refresh_health_metrics()
            out["n_workers"] = len(snap)
            out["workers"] = snap
            out["bus_depths"] = coord.cluster.bus.depths()
            out["queue_depths"] = {wid: h["queue_depth"] for wid, h in snap.items()}
            out["stragglers"] = sorted(wid for wid, h in snap.items() if h["straggler"])
            if out["stragglers"] or not snap:
                out["status"] = "degraded"
        slots = self._slots()
        if slots is not None:
            out["agent_slots"] = slots
            if slots["total"] and slots["gave_up"] == slots["total"]:
                out["status"] = "degraded"
        return _json(out)

    def livez(self, request) -> Reply:
        return _json({"status": "ok"})

    def readyz(self, request) -> Reply:
        coord = self.coord
        if coord.ready:
            return _json({"status": "ready", "recovery": coord.recovery})
        retry_after = coord.config.service.admission_retry_after_s
        return _json({"status": "recovering", "recovery": coord.recovery}, 503,
                     [("Retry-After", f"{retry_after:g}")])

    def curves_job(self, request, jid) -> Reply:
        out = self.coord.job_curves(jid)
        if out is None:
            return _json({"status": "error", "message": f"no job {jid!r}"}, 404)
        return _json(out)

    def curves_subtask(self, request, jid, stid) -> Reply:
        try:
            return _json(self.coord.subtask_curves(jid, stid))
        except KeyError as e:
            return _json({"status": "error", "message": str(e).strip("'")}, 404)

    def predictor_calibration(self, request) -> Reply:
        return _json(self.coord.predictor_calibration())

    # ---------------- worker agents ----------------

    def subscribe(self, request) -> Reply:
        body = request.json(silent=True) or {}
        n_devices = body.get("n_devices")
        if n_devices is not None:
            try:
                int(n_devices)
            except (TypeError, ValueError):
                raise HTTPError(400, f"n_devices must be an integer, got {n_devices!r}")
        wid = self._cluster_or_400().register_remote(body.get("mem_capacity_mb"))
        return _json({"worker_id": wid}, 201)

    def unsubscribe(self, request, wid) -> Reply:
        self._cluster_or_400().unregister_remote(wid)
        return _json({"status": "ok"})

    def heartbeat(self, request, wid) -> Reply:
        ok = self._cluster_or_400().engine.heartbeat(wid)
        return _json({"status": "ok" if ok else "unknown_worker"}, 200 if ok else 404)

    def next_tasks(self, request, wid) -> Reply:
        """Long-poll the worker's queue: up to ``max`` tasks (default 64)
        within ``timeout`` seconds (default 10), plus the cooperative-cancel
        list."""
        cluster = self._cluster_or_400()
        max_n = int(request.args.get("max", 64))
        timeout_s = float(request.args.get("timeout", 10.0))
        out: Dict[str, Any] = {"tasks": cluster.pull_tasks(wid, max_n, timeout_s)}
        cancels = cluster.cancel_list()
        if cancels:
            out["cancel"] = cancels
        return _json(out)

    def task_result(self, request, wid) -> Reply:
        self._cluster_or_400().push_result(wid, request.json())
        return _json({"status": "ok"})

    def task_metrics(self, request, wid) -> Reply:
        self._cluster_or_400().push_metrics(wid, request.json())
        return _json({"status": "ok"})

    def dataset(self, request, dataset_id) -> Reply:
        """The coordinator's staged CSV (preprocessed first), streamed, for
        agents that fetch on a miss; ``?probe=1`` returns only its kind and
        size."""
        from ..data.datasets import find_csv

        root = self.coord.config.storage.datasets_dir
        path, kind = find_csv(dataset_id, preprocessed=True, root=root), "preprocessed"
        if path is None:
            path, kind = find_csv(dataset_id, root=root), "raw"
        if path is None:
            return _json({"status": "error",
                          "message": f"dataset {dataset_id!r} not staged"}, 404)
        if request.args.get("probe"):
            return _json({"kind": kind, "size": os.path.getsize(path)})
        return 200, [("Content-Type", "text/csv; charset=utf-8"),
                     ("Content-Length", str(os.path.getsize(path))),
                     ("X-Dataset-Kind", kind),
                     ("Content-Disposition", f"attachment; filename={dataset_id}.csv")
                     ], _file_chunks(path)


def _device_health(device) -> Dict[str, Any]:
    """The coordinator's device: reachability, kind, and on the card its
    memory from ``torch.cuda.mem_get_info``."""
    import torch

    if device.type != "cuda":
        return {"reachable": True, "platform": "cpu", "n_devices": 1, "device_kind": "cpu"}
    free, total = torch.cuda.mem_get_info(device)
    return {
        "reachable": True,
        "platform": "gpu",
        "n_devices": torch.cuda.device_count(),
        "device_kind": torch.cuda.get_device_name(device),
        "memory": {"bytes_in_use": int(total - free),
                   "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
                   "bytes_limit": int(total)},
    }


def create_app(coordinator: Optional[Coordinator] = None) -> App:
    return App(coordinator or Coordinator())


class _Handler(BaseHTTPRequestHandler):
    """HTTP/1.0 adapter: one request a connection; a streamed reply (SSE,
    a dataset) ends when the connection closes."""

    protocol_version = "HTTP/1.0"

    def _dispatch(self) -> None:
        parsed = urllib.parse.urlsplit(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, headers, chunks = self.server.app.handle(
            self.command, parsed.path, parsed.query, dict(self.headers.items()), body)
        if isinstance(chunks, list):
            headers = [*headers, ("Content-Length", str(sum(len(c) for c in chunks)))]
        try:
            self.send_response(status)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            for chunk in chunks:
                self.wfile.write(chunk)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client left (a stream it stopped reading)
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()

    do_GET = do_POST = do_OPTIONS = _dispatch

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s %s", self.address_string(), fmt % args)


class Server(ThreadingHTTPServer):
    daemon_threads = True
    block_on_close = False

    def __init__(self, app: App, host: str, port: int):
        self.app = app
        super().__init__((host, port), _Handler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        if host in ("0.0.0.0", "::", ""):
            host = "127.0.0.1"
        return f"http://{host}:{port}"


def start_server(coordinator: Coordinator, host: str = "127.0.0.1",
                 port: int = 0) -> Tuple[Server, threading.Thread]:
    """Serve ``coordinator`` on ``host:port`` (0: a free port the OS picks)
    in a background thread. Stop with ``server.shutdown();
    server.server_close()`` once every client is done."""
    server = Server(create_app(coordinator), host, port)
    t = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.1},
                         daemon=True, name="tpuml-server")
    t.start()
    return server, t


def serve(coordinator: Optional[Coordinator] = None, host: Optional[str] = None,
          port: Optional[int] = None) -> None:
    from ..utils.config import get_config

    cfg = get_config().service
    server = Server(create_app(coordinator), host or cfg.host,
                    cfg.port if port is None else port)
    logger.info("Serving on %s", server.url)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m cs230_distributed_machine_learning_tpu_torch.runtime.server``:
    serve the REST surface.

    - cluster mode (the default): the placement engine dispatches to worker
      agents that register over /subscribe; ``--local-executors N`` adds N
      in-process workers, ``--agent-executors N`` runs N supervised child
      agent processes (a fatal CUDA error kills only the child; its tasks
      are requeued and the supervisor respawns it).
    - ``--direct``: one in-process executor, no placement engine.

    The coordinator and its in-process workers run on the card unless
    ``--device cpu``. Of the child agents, slot 0 takes the card unless
    in-process workers hold it; every other slot runs on the CPU."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuml coordinator server")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--direct", action="store_true",
                        help="in-process executor, no placement engine")
    parser.add_argument("--local-executors", type=int, default=0, metavar="N",
                        help="cluster mode: also attach N in-process executors")
    parser.add_argument("--agent-executors", type=int, default=0, metavar="N",
                        help="cluster mode: run N supervised child agent processes")
    parser.add_argument("--journal", action="store_true",
                        help="journal job state; resume in-flight jobs on restart")
    parser.add_argument("--device", default=None,
                        help="the coordinator's and in-process workers' device "
                             "(default: the CUDA card; 'cpu' for the host)")
    args = parser.parse_args(argv)
    if args.direct and args.agent_executors > 0:
        parser.error("--agent-executors requires cluster mode (drop --direct)")

    from ..utils.config import get_config

    supervisor = None
    if args.direct:
        coord = Coordinator(device=args.device, journal=args.journal)
    else:
        from .cluster import ClusterRuntime

        cluster = ClusterRuntime()
        for _ in range(max(args.local_executors, 0)):
            cluster.add_executor(device=args.device)
        coord = Coordinator(device=args.device, cluster=cluster, journal=args.journal)
        if args.agent_executors > 0:
            from .supervisor import AgentSupervisor, agent_command

            cfg = get_config().service
            host = args.host or cfg.host
            # children dial an address the bound server answers on
            dial = "127.0.0.1" if host in (None, "", "0.0.0.0", "::") else host
            url = f"http://{dial}:{cfg.port if args.port is None else args.port}"
            card_taken = args.local_executors > 0 or args.device == "cpu"
            slot_args, slot_envs = [], []
            for i in range(args.agent_executors):
                if i == 0 and not card_taken:
                    slot_args.append([])
                    slot_envs.append(None)
                else:
                    slot_args.append(["--device", "cpu"])
                    slot_envs.append({"CUDA_VISIBLE_DEVICES": ""})
            supervisor = AgentSupervisor(agent_command(url), n=args.agent_executors,
                                         slot_envs=slot_envs, slot_args=slot_args)
            supervisor.start()
            coord.agent_supervisor = supervisor
    try:
        serve(coord, host=args.host, port=args.port)
    finally:
        if supervisor is not None:
            supervisor.stop()


if __name__ == "__main__":
    main()
