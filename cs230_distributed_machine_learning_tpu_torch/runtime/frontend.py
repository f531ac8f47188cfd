"""Stateless API front end for the sharded control plane.

Port of the JAX package's ``runtime/frontend.py``, rewritten on the
standard library (``http.server`` behind the port server's ``Server``,
``urllib`` upstream; the card's machine has neither werkzeug nor
requests). This process holds no job state: every request is routed to a
coordinator shard by the ids in its URL (runtime/sharding.py):

- session routes (``/train/<sid>``, ``/train_status/<sid>``,
  ``/check_status/<sid>/<jid>``, ...) route by ``shard_of(session_id)``;
  ``/create_session`` mints the session id here, so the hash and the
  owning shard agree by construction;
- job-only routes (``/trace/<jid>``, ``/cost/<jid>``, ``/explain/...``,
  ``/critical_path/...``, ``/curves/...``) route by the ``s<k>-`` stamp of
  the job id (an unstamped id is probed on every shard);
- worker-plane routes (``/next_tasks/<wid>``, ``/task_result/<wid>``, ...)
  route by the same stamp in the worker id; ``/subscribe`` assigns the
  worker to a shard (body ``{"shard": k}`` pins it, else round robin);
- a migrated job's ``409 moved`` answer is learned (``ForwardingCache``)
  and the request re-proxied once to the new owner;
- fleet-wide routes aggregate over every shard: ``/healthz`` (worst status
  wins), ``/readyz`` (ready when every shard is), ``/jobs`` / ``/workers``
  / ``/queues`` / ``/supervisor`` (merged), ``/metrics/prom`` (one
  exposition with a ``shard`` label injected per series),
  ``/metrics/history`` (shard-labelled series), ``/events`` (a
  seq-ordered merge paged by per-shard cursors), ``/alerts`` (the union,
  shard-stamped), ``/autoscale`` (fleet sums with per-shard bodies) and
  ``/steal_candidates`` (merged, donor-stamped).

A shard that is down answers 503 + Retry-After, the overload contract
clients already retry through. The ``/train_status`` event stream is
relayed unbuffered. A proxied request runs in a ``frontend.proxy`` span
(the trace id minted here when the client sent none), shipped to the
owning shard's tracer.

Run: ``python -m cs230_distributed_machine_learning_tpu_torch.runtime.frontend
--port 5000 --shards http://h1:5001,http://h2:5001``
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..obs import counter_inc, render_prometheus
from ..obs.tracing import PARENT_HEADER, TRACE_HEADER, TRACER
from ..obs.tracing import _enabled as _obs_enabled
from ..obs.tracing import new_span_id, new_trace_id
from ..utils import http
from ..utils.logging import get_logger
from ..utils.serialization import json_safe
from .server import CORS_HEADERS, Request, Server
from .sharding import ForwardingCache, id_shard, shard_of

logger = get_logger("tpuml.frontend")

Reply = Tuple[int, List[Tuple[str, str]], Any]

#: routed by the session id in the first path argument
_SESSION_ROUTES = {
    "download_data", "check_data", "preprocess", "train", "train_status",
    "check_status", "download_model",
}
#: routed by the worker-id stamp in the first path argument
_WORKER_ROUTES = {
    "unsubscribe", "heartbeat", "next_tasks", "task_result", "task_metrics",
    "trace_spans",
}
#: routed by the job-id stamp (a probe of every shard for unstamped ids)
_JOB_ROUTES = {"trace", "cost", "explain", "critical_path", "curves"}
#: reply headers relayed from the shard to the client
_FWD_HEADERS = ("Content-Type", "Retry-After", "X-Trace-Id", "X-Dataset-Kind",
                "Content-Disposition")
#: seconds an upstream connection or read may take (an event stream's
#: ticks keep its reads short)
_UPSTREAM_TIMEOUT_S = 910.0


def _inject_shard_label(body: str, shard) -> List[str]:
    """Rewrite one shard's Prometheus exposition so every series carries a
    ``shard=<k>`` label; comment and metadata lines pass through (the
    caller dedups them)."""
    out = []
    for line in body.splitlines():
        if not line.strip() or line.startswith("#"):
            out.append(line)
            continue
        name, _, rest = line.partition(" ")
        if "{" in name:
            fam, _, labels = name.partition("{")
            out.append(f'{fam}{{shard="{shard}",{labels} {rest}')
        else:
            out.append(f'{name}{{shard="{shard}"}} {rest}')
    return out


def _json(data, status: int = 200, headers=()) -> Reply:
    body = json.dumps(json_safe(data)).encode()
    return status, [("Content-Type", "application/json"), *headers], [body]


class _Call:
    """One inbound request as the router sees it."""

    def __init__(self, method, path, query, headers, body):
        self.method = method
        self.path = path
        self.query = query or ""
        self.headers = {k.lower(): v for k, v in (headers or {}).items()}
        self.body = body or b""
        self.args = Request(self.query, b"").args
        #: (trace id, proxy span id) of a traced request
        self.trace: Optional[Tuple[str, str]] = None
        #: the shard a single-shard relay went to
        self.shard: Optional[int] = None

    def json(self) -> Dict[str, Any]:
        try:
            out = json.loads(self.body.decode() or "null")
        except ValueError:
            return {}
        return out if isinstance(out, dict) else {}


class FrontendApp:
    """The router over a list of shard URLs (index = shard id)."""

    def __init__(self, shard_urls: List[str]):
        self.urls = [u.rstrip("/") for u in shard_urls]
        if not self.urls:
            raise ValueError("frontend needs at least one shard URL")
        self.n_shards = len(self.urls)
        self._rr = itertools.count()
        #: migrated jobs' redirects (the donor's 409 moved, remembered)
        self.fwd_cache = ForwardingCache()
        # one pool for every fan-out route, polled ones included
        self._pool = ThreadPoolExecutor(max_workers=max(2 * self.n_shards, 4),
                                        thread_name_prefix="tpuml-fe-fan")
        self._lock = threading.Lock()

    # ---------------- upstream ----------------

    def _upstream_headers(self, call: _Call) -> Dict[str, str]:
        headers = {}
        for h in ("content-type", "x-trace-id"):
            if call.headers.get(h):
                headers[h.title()] = call.headers[h]
        if call.trace is not None:
            # the shard's http.<endpoint> span nests under frontend.proxy
            headers[TRACE_HEADER] = call.trace[0]
            headers[PARENT_HEADER] = call.trace[1]
        return headers

    def _open(self, call: _Call, k: int, path: str, body: Optional[bytes] = None):
        """The shard's open reply to this request (an http.client response
        or the HTTPError that carries a 4xx / 5xx). Raises a transport
        error when the shard is unreachable."""
        call.shard = k
        url = f"{self.urls[k]}{path}" + (f"?{call.query}" if call.query else "")
        data = call.body if body is None else body
        req = urllib.request.Request(url, data=data if call.method != "GET" else None,
                                     headers=self._upstream_headers(call), method=call.method)
        try:
            return urllib.request.urlopen(req, timeout=_UPSTREAM_TIMEOUT_S)
        except urllib.error.HTTPError as e:
            return e
        except (urllib.error.URLError, OSError) as e:
            raise ConnectionError(str(e)) from e

    @staticmethod
    def _status(resp) -> int:
        return int(resp.status if hasattr(resp, "status") else resp.code)

    def _relay(self, resp, stream: bool = False) -> Reply:
        headers = [(h, resp.headers[h]) for h in _FWD_HEADERS if resp.headers.get(h)]
        status = self._status(resp)
        if not stream:
            try:
                body = resp.read()
            finally:
                resp.close()
            return status, headers, [body]

        def _body():
            # unbuffered: hand over whatever the shard flushed (an event)
            read1 = getattr(resp, "read1", None)
            try:
                while True:
                    chunk = read1(65536) if read1 is not None else resp.read(1)
                    if not chunk:
                        return
                    yield chunk
            finally:
                resp.close()

        return status, headers, _body()

    @staticmethod
    def _shard_down(k: int) -> Reply:
        # the overload contract: clients retry a 503 + Retry-After
        return _json({"status": "error", "reason": "shard_unavailable", "shard": k,
                      "retry_after_s": 2.0}, 503, [("Retry-After", "2")])

    def _proxy(self, call: _Call, k: int, path: str, *, body: Optional[bytes] = None,
               stream: bool = False, job_id: Optional[str] = None) -> Reply:
        if job_id is not None:
            cached = self.fwd_cache.get(job_id)
            if cached is not None and 0 <= cached < self.n_shards:
                k = cached
        try:
            resp = self._open(call, k, path, body)
        except ConnectionError:
            return self._shard_down(k)
        if job_id is not None and self._status(resp) == 409:
            # the forwarding stamp: learn the move, re-proxy once
            try:
                moved = json.loads(resp.read().decode() or "null")
            except ValueError:
                moved = None
            finally:
                resp.close()
            if isinstance(moved, dict) and moved.get("status") == "moved":
                try:
                    dest = int(moved.get("migrated_to"))
                except (TypeError, ValueError):
                    dest = -1
                if 0 <= dest < self.n_shards and dest != k:
                    self.fwd_cache.put(str(moved.get("job_id") or job_id), dest)
                    counter_inc("tpuml_frontend_forwarded_total")
                    try:
                        resp = self._open(call, dest, path, body)
                    except ConnectionError:
                        return self._shard_down(dest)
                    return self._relay(resp, stream=stream)
            return _json(moved, 409)
        return self._relay(resp, stream=stream)

    def _get_json(self, k: int, path: str, query: str = ""):
        """GET one shard's JSON body, or None (an error or an outage)."""
        url = f"{self.urls[k]}{path}" + (f"?{query}" if query else "")
        try:
            r = http.request("GET", url, timeout=10)
            return r.json() if r.status < 400 else None
        except (*http.TransportError, ValueError):
            return None

    def _fan_json(self, call: _Call, path: str, query: Optional[str] = None) -> Dict[int, Any]:
        """GET ``path`` on every shard concurrently: {shard: body} of the
        shards that answered (one hung shard must not stall the rest)."""
        q = call.query if query is None else query
        results = list(self._pool.map(lambda k: (k, self._get_json(k, path, q)),
                                      range(self.n_shards)))
        return {k: body for k, body in results if body is not None}

    def _scatter_first(self, call: _Call, path: str, stream: bool = False) -> Reply:
        """Every shard in order; the first answer that is not a 404 wins."""
        last: Optional[Reply] = None
        for k in range(self.n_shards):
            try:
                resp = self._open(call, k, path)
            except ConnectionError:
                last = self._shard_down(k)
                continue
            if self._status(resp) == 404:
                resp.close()
                continue
            return self._relay(resp, stream=stream)
        return last if last is not None else _json(
            {"status": "error", "message": "not found on any shard"}, 404)

    # ---------------- fleet-wide aggregates ----------------

    def _home(self, call) -> Reply:
        return _json({
            "service": "tpuml-frontend", "n_shards": self.n_shards, "shards": self.urls,
            "note": "stateless front end: session routes hash on session_id, job/worker "
                    "routes follow the s<k>- id stamp; /healthz, /jobs, /workers, /queues "
                    "and /metrics/prom aggregate over every shard",
        })

    def _down(self, shards) -> List[int]:
        return [k for k in range(self.n_shards) if k not in shards]

    def _health(self, call) -> Reply:
        shards = self._fan_json(call, "/health")
        degraded = [k for k in range(self.n_shards)
                    if (shards.get(k) or {}).get("status") != "ok"]
        return _json({"status": "ok" if not degraded else "degraded",
                      "n_shards": self.n_shards, "shards_unhealthy": degraded})

    def _readyz(self, call) -> Reply:
        shards = self._fan_json(call, "/readyz")
        ready = [k for k in shards if shards[k].get("status") == "ready"]
        if len(ready) == self.n_shards:
            return _json({"status": "ready", "n_shards": self.n_shards})
        return _json({"status": "recovering", "n_shards": self.n_shards,
                      "shards_ready": sorted(ready)}, 503, [("Retry-After", "2")])

    def _healthz(self, call) -> Reply:
        shards = self._fan_json(call, "/healthz")
        status = "ok"
        if len(shards) < self.n_shards or any(s.get("status") != "ok" for s in shards.values()):
            status = "degraded"
        return _json({"status": status, "n_shards": self.n_shards,
                      "shards_down": self._down(shards),
                      "n_workers": sum(int(s.get("n_workers") or 0) for s in shards.values()),
                      "shards": shards})

    def _merge_lists(self, call, path: str, sort_key=None) -> Reply:
        merged: List[Any] = []
        for body in self._fan_json(call, path).values():
            if isinstance(body, list):
                merged.extend(body)
        if sort_key is not None:
            merged.sort(key=sort_key, reverse=True)
        return _json(merged)

    def _merge_dicts(self, call, path: str) -> Reply:
        merged: Dict[str, Any] = {}
        for body in self._fan_json(call, path).values():
            if isinstance(body, dict):
                merged.update(body)  # worker ids are shard-stamped: unique
        return _json(merged)

    def _metrics_prom(self, call) -> Reply:
        def scrape(k):
            try:
                r = http.request("GET", f"{self.urls[k]}/metrics/prom", timeout=10)
                return k, (r.text() if r.status < 400 else None)
            except http.TransportError:
                return k, None

        bodies = list(self._pool.map(scrape, range(self.n_shards)))
        # this process's own registry (the forwarding counter), as one more
        # labelled source
        bodies.append(("frontend", render_prometheus()))
        lines: List[str] = []
        seen_meta = set()
        for k, text in bodies:
            if text is None:
                continue
            for line in _inject_shard_label(text, k):
                if line.startswith("#"):
                    if line in seen_meta:
                        continue
                    seen_meta.add(line)
                lines.append(line)
        return 200, [("Content-Type", "text/plain; version=0.0.4; charset=utf-8")], [
            ("\n".join(lines) + "\n").encode()]

    def _dashboard(self, call) -> Reply:
        from .server import _DASHBOARD_HTML

        return 200, [("Content-Type", "text/html; charset=utf-8")], [_DASHBOARD_HTML.encode()]

    def _events(self, call) -> Reply:
        """The fleet's event feed: a merge sorted by (seq, shard), paged by
        per-shard cursors. ``?since=`` takes a plain int (every shard) or
        the JSON cursor map a reply returned (``cursor``); the merge is cut
        to ``?limit=`` from the oldest end, so cursor polls never repeat or
        skip a (shard, seq)."""
        def _int(v, default):
            try:
                return int(v)
            except (TypeError, ValueError):
                return default

        limit = max(_int(call.args.get("limit"), 1000), 1)
        cursors = {k: 0 for k in range(self.n_shards)}
        since_raw = call.args.get("since") or ""
        if since_raw:
            try:
                parsed = json.loads(since_raw)
            except ValueError:
                parsed = None
            if isinstance(parsed, dict):
                for k, v in parsed.items():
                    kk = _int(k, -1)
                    if 0 <= kk < self.n_shards:
                        cursors[kk] = _int(v, 0)
            else:
                base = _int(since_raw, 0)
                cursors = {k: base for k in range(self.n_shards)}

        def one(k):
            return k, self._get_json(k, "/events", f"since={cursors[k]}&limit={limit}")

        merged: List[Dict[str, Any]] = []
        for k, body in self._pool.map(one, range(self.n_shards)):
            for e in (body or {}).get("events") or []:
                e["shard"] = k
                merged.append(e)
        merged.sort(key=lambda e: (int(e.get("seq") or 0), int(e.get("shard") or 0)))
        merged = merged[:limit]
        out_cursors = dict(cursors)
        for e in merged:
            out_cursors[e["shard"]] = max(out_cursors[e["shard"]], int(e.get("seq") or 0))
        cursor_map = {str(k): v for k, v in sorted(out_cursors.items())}
        return _json({"events": merged, "n_events": len(merged), "cursors": cursor_map,
                      "cursor": json.dumps(cursor_map, separators=(",", ":")),
                      # per-shard seqs collide: page with ``cursor``
                      "last_seq": 0})

    def _alerts(self, call) -> Reply:
        """The union of every shard's rule states, each stamped with its
        shard."""
        shards = self._fan_json(call, call.path)
        merged: List[Dict[str, Any]] = []
        for k in sorted(shards):
            for a in (shards[k] or {}).get("alerts") or []:
                a = dict(a)
                a["shard"] = k
                merged.append(a)
        merged.sort(key=lambda a: (a.get("rule") or "", a.get("shard") or 0))
        firing = [{"rule": a["rule"], "shard": a["shard"]}
                  for a in merged if a.get("state") == "firing"]
        return _json({"status": "firing" if firing else "ok", "n_firing": len(firing),
                      "firing": firing, "alerts": merged, "n_shards": self.n_shards,
                      "shards_down": self._down(shards)})

    def _autoscale(self, call) -> Reply:
        """Desired and live workers summed over the shards, desired shards
        their maximum, and which shard is hot (the per-shard pressures, the
        argmax and the max / mean imbalance)."""
        shards = self._fan_json(call, call.path)
        bodies = {k: (shards[k] or {}) for k in shards}
        pressures: Dict[int, float] = {}
        for k, b in bodies.items():
            sp = (b.get("signals") or {}).get("shard_pressure")
            if sp is not None:
                pressures[k] = float(sp)
        hot = max(pressures, key=lambda k: pressures[k]) if pressures else None
        mean_p = sum(pressures.values()) / len(pressures) if pressures else 0.0
        imbalance = (round(max(pressures.values()) / mean_p, 4)
                     if pressures and mean_p > 1e-9 else None)
        return _json({
            "desired_workers": sum(int(b.get("desired_workers") or 0) for b in bodies.values()),
            "live_workers": sum(int(b.get("live_workers") or 0) for b in bodies.values()),
            "desired_shards": max([int(b.get("desired_shards") or 0)
                                   for b in bodies.values()] + [0]),
            "shard_pressure": {str(k): v for k, v in sorted(pressures.items())},
            "hot_shard": hot, "imbalance_ratio": imbalance, "n_shards": self.n_shards,
            "shards_down": self._down(shards), "shards": bodies,
        })

    def _steal_candidates(self, call) -> Reply:
        shards = self._fan_json(call, call.path)
        merged: List[Dict[str, Any]] = []
        pressures: Dict[str, Any] = {}
        for k in sorted(shards):
            body = shards[k] or {}
            pressures[str(k)] = body.get("shard_pressure")
            for c in body.get("candidates") or []:
                c = dict(c)
                c["shard"] = k
                merged.append(c)
        return _json({"candidates": merged, "n_candidates": len(merged),
                      "shard_pressure": pressures, "n_shards": self.n_shards,
                      "shards_down": self._down(shards)})

    def _metrics_history(self, call) -> Reply:
        shards = self._fan_json(call, call.path)
        if not call.args.get("name"):
            return _json({"names": sorted({n for body in shards.values()
                                           for n in (body or {}).get("names") or []})})
        series: List[Dict[str, Any]] = []
        for k, body in shards.items():
            for s in (body or {}).get("series") or []:
                s["labels"] = {**(s.get("labels") or {}), "shard": str(k)}
                series.append(s)
        return _json({"name": call.args.get("name"),
                      "since": float(call.args.get("since", 0) or 0), "series": series})

    # ---------------- the router ----------------

    def _route(self, call: _Call) -> Reply:
        parts = [p for p in call.path.split("/") if p]
        if not parts:
            return self._home(call)
        head = parts[0]

        if head == "create_session":
            # minted here, so shard_of(sid) and the owner agree; a client's
            # id is ignored (no session fixation); the priority is forwarded
            body = call.json()
            sid = str(uuid.uuid4())
            fwd: Dict[str, Any] = {"session_id": sid}
            if body.get("priority") is not None:
                fwd["priority"] = body["priority"]
            call.headers["content-type"] = "application/json"
            return self._proxy(call, shard_of(sid, self.n_shards), "/create_session",
                               body=json.dumps(fwd).encode())
        if head in _SESSION_ROUTES and len(parts) >= 2:
            job_id = None
            if head in ("check_status", "download_model") and len(parts) >= 3:
                job_id = parts[2]
            elif head == "train_status":
                job_id = call.json().get("job_id") or None
            return self._proxy(call, shard_of(parts[1], self.n_shards), call.path,
                               stream=(head == "train_status"), job_id=job_id)
        if head == "metrics" and len(parts) == 3 and parts[1] not in ("prom", "history"):
            return self._proxy(call, shard_of(parts[1], self.n_shards), call.path,
                               job_id=parts[2])
        if head in _WORKER_ROUTES and len(parts) >= 2:
            k = id_shard(parts[1])
            if k is None or k >= self.n_shards:
                return _json({"status": "error", "message": f"worker id {parts[1]!r} carries "
                              "no valid shard stamp"}, 404)
            return self._proxy(call, k, call.path)
        if head == "subscribe":
            body = call.json()
            pinned = body.pop("shard", None)
            if pinned is None:
                with self._lock:
                    k = next(self._rr) % self.n_shards
            else:
                try:
                    k = int(pinned)
                except (TypeError, ValueError):
                    k = -1
                if not 0 <= k < self.n_shards:
                    return _json({"status": "error", "message": f"shard {pinned!r} not in "
                                  f"[0, {self.n_shards})"}, 400)
            call.headers["content-type"] = "application/json"
            return self._proxy(call, k, "/subscribe", body=json.dumps(body).encode())
        if head in _JOB_ROUTES and len(parts) >= 2:
            k = id_shard(parts[1])
            if k is not None and k < self.n_shards:
                return self._proxy(call, k, call.path, job_id=parts[1])
            return self._scatter_first(call, call.path)
        if head == "dataset" and len(parts) == 2:
            return self._scatter_first(call, call.path, stream=True)
        if head in ("slice_heartbeat", "slice_status") and len(parts) >= 2:
            return self._proxy(call, shard_of(parts[1], self.n_shards), call.path)

        if head == "health":
            return self._health(call)
        if head == "livez":
            return _json({"status": "ok"})
        if head == "readyz":
            return self._readyz(call)
        if head == "healthz":
            return self._healthz(call)
        if head == "jobs":
            return self._merge_lists(call, "/jobs", sort_key=lambda j: j.get("created_at") or 0)
        if head in ("workers", "queues"):
            return self._merge_dicts(call, call.path)
        if head == "metrics" and parts[1:] == ["prom"]:
            return self._metrics_prom(call)
        if head == "dashboard":
            return self._dashboard(call)
        if head == "events":
            return self._events(call)
        if head == "alerts":
            return self._alerts(call)
        if head == "autoscale":
            return self._autoscale(call)
        if head == "steal_candidates":
            return self._steal_candidates(call)
        if head == "supervisor":
            return self._merge_lists(call, call.path)
        if head == "metrics" and parts[1:] == ["history"]:
            return self._metrics_history(call)
        if head == "predictor":
            # no fleet-wide calibration: the per-shard bodies
            return _json({"shards": self._fan_json(call, call.path)})
        return _json({"status": "error", "message": "not found"}, 404)

    def _ship_span(self, k: int, span: Dict[str, Any]) -> None:
        """The proxy span into the owning shard's tracer (best effort)."""
        try:
            http.request("POST", f"{self.urls[k]}/trace_spans/frontend",
                         json={"spans": [json_safe(span)]}, timeout=5)
        except http.TransportError:
            logger.debug("frontend.proxy span shipping to shard %d failed", k)

    def handle(self, method: str, path: str, query=None,
               headers: Optional[Dict[str, str]] = None, body: bytes = b"") -> Reply:
        """Serve one request (the port server's ``App.handle`` surface):
        (status, headers, body chunks), CORS on every reply, the trace id
        echoed."""
        method = method.upper()
        if method == "OPTIONS":
            return 204, list(CORS_HEADERS), []
        call = _Call(method, path, query, headers, body)
        head = path.split("/")[1] if "/" in path else ""
        inbound = call.headers.get(TRACE_HEADER.lower())
        # the span transport itself is never traced
        traced = _obs_enabled() and head != "trace_spans"
        trace_id = inbound
        t0 = time.time()
        if traced:
            trace_id = inbound or new_trace_id()
            call.trace = (trace_id, new_span_id())
        try:
            status, hdrs, chunks = self._route(call)
        except Exception as e:  # noqa: BLE001 — a routing bug must still answer
            logger.exception("Frontend routing failed for %s", path)
            status, hdrs, chunks = _json({"status": "error", "message": str(e)}, 500)
        out = [*hdrs, *CORS_HEADERS]
        if trace_id:
            out = [h for h in out if h[0].lower() != TRACE_HEADER.lower()]
            out.append((TRACE_HEADER, trace_id))
        # client-traced or single-shard relays only: untraced polls of the
        # aggregates must not churn the trace ring
        if traced and (inbound or call.shard is not None):
            span = {
                "trace_id": trace_id, "span_id": call.trace[1], "parent_id": None,
                "name": "frontend.proxy", "start": t0, "end": time.time(),
                "attrs": {"route": head or "/", "path": path, "method": method,
                          "status": status, "shard": call.shard, "minted": inbound is None},
                "process": f"frontend:{os.getpid()}",
            }
            TRACER.record(span)
            if call.shard is not None:
                self._pool.submit(self._ship_span, call.shard, span)
        return status, out, chunks


def create_frontend_app(shard_urls: List[str]) -> FrontendApp:
    return FrontendApp(shard_urls)


def start_frontend(shard_urls: List[str], host: str = "127.0.0.1",
                   port: int = 0) -> Tuple[Server, threading.Thread]:
    """Serve a front end over ``shard_urls`` on ``host:port`` (0: a free
    port) in a background thread; stop with ``shutdown(); server_close()``."""
    server = Server(create_frontend_app(shard_urls), host, port)
    t = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.1},
                         daemon=True, name="tpuml-frontend")
    t.start()
    return server, t


def serve(shard_urls: List[str], host: str = "0.0.0.0", port: int = 5000) -> None:
    server = Server(create_frontend_app(shard_urls), host, port)
    logger.info("Front end on %s over %d shards", server.url, len(shard_urls))
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv: Optional[List[str]] = None) -> None:
    """Serve the stateless front end of a sharded control plane."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuml API front end")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--shards", required=True,
                        help="comma-separated coordinator-shard base URLs, in shard order "
                             "(index in this list == shard id)")
    args = parser.parse_args(argv)
    serve([u for u in args.shards.split(",") if u.strip()], host=args.host, port=args.port)


if __name__ == "__main__":
    main()
